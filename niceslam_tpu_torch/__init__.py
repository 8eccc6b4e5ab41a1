"""niceslam_tpu_torch — the NICE-SLAM-class engine in PyTorch with CUDA kernels.

The PyTorch/CUDA counterpart of ``niceslam_tpu`` (the JAX reference), built
for one NVIDIA Hopper card. Module paths mirror the JAX package
(``core/pose.py``, ``ops/trilinear.py``, ``slam/tracker.py``, ...), so each
module's reference is found at the same path there. Plain tensor code is
PyTorch; the trilinear grid sampler's forward and backward are hand-written
CUDA kernels (``csrc/trilerp.cu``, bound in ``ops/trilerp_kernels.py``).

Entry points (``slam.system.NiceSLAM``, ``ops.trilinear.sample_grid``) run
on ``cuda`` unless the caller passes ``device="cpu"``; on CPU tensors every
kernel wrapper uses its plain PyTorch version.

Numerics: parity with the JAX reference is an fp32 question, so TF32 is
switched off here, once, for matmuls and cuDNN convolutions alike.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

DEFAULT_DEVICE = "cuda"
