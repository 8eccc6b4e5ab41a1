"""The bench world that the JAX package's diagnostic scripts repeat, in the
port's dataclasses: the synthetic box scene's bound, 640x480 at fx = fy =
360, ``GridLenConfig()``, and the mapping budgets of the bench (1000 pixels,
``iters_first`` 1500, 60 iterations every 5th frame, a keyframe every 10th,
a window of 5 out of 64 keyframes, no colour refinement), the coarse level
on. :func:`world_config` takes each script's own tracking, decoders, sync
and mapping overrides; :func:`card` picks the device as every diagnostic's
``main`` does.
"""
from __future__ import annotations

import os

import torch

from ..bench import BOUND, CAM
from ..config.schema import GridLenConfig, MappingConfig, SLAMConfig, TrackingConfig

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# The scripts' default decoders, relative to the repository's root.
DECODERS = "models/pretrained_decoders.npz"
WORLD_MAPPING = dict(pixels=1000, iters_first=1500, iters=60, every_frame=5,
                     keyframe_every=10, mapping_window_size=5, max_keyframes=64,
                     color_refine=False)


def decoders_path(path: str) -> str:
    """A script's decoder argument as the config's ``pretrained_middle_fine``:
    ``""`` for none (``""`` or ``none``), a relative path from the
    repository's root (the JAX scripts run from there), anything else as
    given."""
    if path in ("", "none"):
        return ""
    return path if os.path.isabs(path) else os.path.join(ROOT, path)


def world_config(tracking: TrackingConfig, pretrained: str = DECODERS, sync: str = "strict",
                 mapping: MappingConfig | None = None, coarse: bool = True,
                 **mapping_over) -> SLAMConfig:
    """The bench world with ``tracking``, the decoders ``pretrained``
    (:func:`decoders_path`), ``sync`` and ``coarse``; the mapping budgets of
    the world with ``mapping_over`` on top, or ``mapping`` whole where a
    script gives its own."""
    return SLAMConfig(
        dataset="synthetic",
        bound=BOUND,
        cam=CAM,
        grid_len=GridLenConfig(),
        tracking=tracking,
        mapping=mapping or MappingConfig(**{**WORLD_MAPPING, **mapping_over}),
        coarse=coarse,
        verbose=False,
        sync_method=sync,
        pretrained_middle_fine=decoders_path(pretrained),
    )


def card(cpu: bool) -> torch.device:
    """The device of a diagnostic: the card, or the CPU with ``cpu``. Without
    a card it raises unless ``cpu``: nothing falls back."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to run the "
                           "diagnostic on the CPU")
    return torch.device("cuda")


def synchronize(device) -> None:
    """Wait for ``device``'s work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """A numpy array (a frame's colour, depth or pose) on ``device``,
    float32."""
    return torch.as_tensor(x, dtype=torch.float32).to(device)
