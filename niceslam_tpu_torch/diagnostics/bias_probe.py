"""The frame-0 rendered-depth bias: the counterpart of the JAX package's
``scripts/bias_probe.py``, with its configuration and record.

Maps frame 0 of the bench world at its true pose (``iters_first``
iterations), then renders 2,000 interior pixels of frame 0 (rows and columns
20 px inside the edges, ``np.random.default_rng(0)``; the training sampler
crops the same edges) at the colour stage and reports whether the depth
error is additive or proportional: its mean (``bias_cm``) and spread, the
linear fit rendered = a gt + b, and where the compositing weights' mass
sits (their sum and largest weight per ray).

    python -m niceslam_tpu_torch.diagnostics.bias_probe [--cpu]

One JSON line on standard output. It runs on the card unless ``--cpu`` is
given, and fails where no card is found.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..config.schema import SLAMConfig, TrackingConfig
from ..core import rays as rays_mod
from ..io.datasets.synthetic import SyntheticBoxReader
from ..render.renderer import render_rays
from ..slam.system import NiceSLAM
from .world import as_tensor, card, world_config

N_PIXELS = 2000
EDGE = 20


def config() -> SLAMConfig:
    return world_config(TrackingConfig(pixels=200, iters=10, gt_camera=True))


def run(cfg: SLAMConfig, device):
    """Frame 0 mapped at its true pose: ``(slam, reader)``."""
    reader = SyntheticBoxReader(cfg, n_frames=2)
    slam = NiceSLAM(cfg, reader=reader, seed=0, device=device)
    slam.run(1)
    slam.result()
    return slam, reader


def interior_pixels(H: int, W: int, n: int, seed: int = 0):
    """``n`` pixel rows and columns ``EDGE`` px inside the image, from
    ``np.random.default_rng(seed)``: ``(jj, ii)``."""
    rng = np.random.default_rng(seed)
    return rng.integers(EDGE, H - EDGE, n), rng.integers(EDGE, W - EDGE, n)


def measure(slam: NiceSLAM, frame) -> dict:
    """The bias record of ``frame`` rendered at its true pose, unrounded."""
    dev = slam.device
    ro_all, rd_all = rays_mod.rays_for_image(slam.intr, as_tensor(frame.gt_c2w, dev))
    jj, ii = interior_pixels(slam.intr.H, slam.intr.W, N_PIXELS)
    jt, it = torch.as_tensor(jj).to(dev), torch.as_tensor(ii).to(dev)
    gt = as_tensor(frame.depth, dev)[jt, it]
    with torch.no_grad():
        out = render_rays(slam.state.decoders, slam.state.grids, slam.bounds, slam.scene_bound,
                          ro_all[jt, it], rd_all[jt, it], gt, "color", slam.rcfg)
    dep, w, gtn = out.depth.cpu().numpy(), out.weights.cpu().numpy(), gt.cpu().numpy()
    m = gtn > 0
    err = dep[m] - gtn[m]
    a, b = np.polyfit(gtn[m], dep[m], 1)
    wsum = w.sum(-1)
    return {
        "n": int(m.sum()),
        "bias_cm": 100 * float(err.mean()),
        "std_cm": 100 * float(err.std()),
        "fit_a": float(a),
        "fit_b_cm": 100 * float(b),
        "w_sum_mean": float(wsum[m].mean()),
        "w_sum_min": float(wsum[m].min()),
        "w_max_mean": float(w[m].max(-1).mean()),
        "gt_range": [float(gtn[m].min()), float(gtn[m].max())],
        "train_loss_proxy": float(np.abs(err).mean()),
    }


DECIMALS = {"bias_cm": 2, "std_cm": 2, "fit_a": 4, "fit_b_cm": 2, "w_sum_mean": 4,
            "w_sum_min": 4, "w_max_mean": 4, "train_loss_proxy": 4}


def rounded(rec: dict) -> dict:
    out = {k: round(v, DECIMALS[k]) if k in DECIMALS else v for k, v in rec.items()}
    out["gt_range"] = [round(x, 2) for x in rec["gt_range"]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    slam, reader = run(config(), card(args.cpu))
    print(json.dumps(rounded(measure(slam, reader[0]))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
