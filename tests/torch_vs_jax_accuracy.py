"""End-to-end accuracy of the port against the JAX package on the tiny CPU
world: the accuracy tripwire's configuration and 12-frame trajectory, run by
both packages for the same seeds, printing each run's ATE and raw per-frame
position error. The packages draw different pixels, so the comparison is of
distributions, not of trajectories.

    JAX_PLATFORMS=cpu python tests/torch_vs_jax_accuracy.py [frames] [seeds]

Several CPU-minutes (both packages, 12 frames, 4 seeds by default); not part
of the test suite.
"""
import dataclasses
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

NPZ = os.path.join(_ROOT, "models", "pretrained_decoders.npz")


def _tripwire(cfg):
    return dataclasses.replace(
        cfg,
        pretrained_middle_fine=NPZ,
        mapping=dataclasses.replace(cfg.mapping, bootstrap_frames=4, fs_weight=1.0),
    )


def _report(name, seed, res, t0):
    est = np.stack([np.asarray(p) for p in res["est_c2w"]])[:, :3, 3]
    gt = np.stack([np.asarray(p) for p in res["gt_c2w"]])[:, :3, 3]
    raw = 100 * np.linalg.norm(est - gt, axis=1)
    print(f"{name} seed {seed}: ATE {100 * res['ate_rmse']:.3f} cm, raw position "
          f"error per frame (cm) {[round(float(e), 2) for e in raw]}, "
          f"{time.time() - t0:.0f} s", flush=True)
    return 100 * res["ate_rmse"]


def main(frames: int = 12, seeds: int = 4):
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    from integration.conftest import tiny_config as jax_tiny
    from niceslam_tpu.io.datasets.synthetic import SyntheticBoxReader as JaxReader
    from niceslam_tpu.slam.system import NiceSLAM as JaxSLAM
    from niceslam_tpu_torch.io.datasets.synthetic import SyntheticBoxReader
    from niceslam_tpu_torch.slam.system import NiceSLAM
    from test_torch_slam import tiny_config

    ates = {"jax": [], "torch": []}
    for seed in range(seeds):
        t0 = time.time()
        cfg = _tripwire(jax_tiny())
        reader = JaxReader(cfg, n_frames=12, trajectory_kwargs=dict(arc_fraction=0.1))
        res = JaxSLAM(cfg, reader=reader, seed=seed).run(frames)
        ates["jax"].append(_report("jax", seed, res, t0))
        t0 = time.time()
        cfg = _tripwire(tiny_config())
        reader = SyntheticBoxReader(cfg, n_frames=12, trajectory_kwargs=dict(arc_fraction=0.1))
        res = NiceSLAM(cfg, reader=reader, seed=seed, device="cpu").run(frames)
        ates["torch"].append(_report("torch", seed, res, t0))
    for name, a in ates.items():
        print(f"{name}: ATE per seed {[round(x, 3) for x in a]}, mean {np.mean(a):.3f} cm")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
