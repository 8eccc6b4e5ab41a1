"""Occupancy saturation of a decoder set on fresh grids: the counterpart of
the JAX package's ``scripts/saturation_probe.py``, with its argument,
configuration and record.

At the start of a run the grids are about zero (N(0, 0.01)). If the frozen
decoders' occupancy at such features saturates sigmoid(10 occ), the grids
get no gradient and the map never learns geometry. Healthy: |occ| mostly
under ~0.5, and a gradient into the grids. For the ``middle`` and ``color``
stages, on 4,096 uniform points of the bound (``np.random.default_rng(0)``):
the occupancy's mean and 10th/90th percentiles, the mean alpha, the share of
alphas under 1e-3 and over 0.999, and the norm of the gradient of
sum(sigmoid(10 occ)) in the middle grid (summed in float64: a float32 sum
over the grid's 160,000 entries is off by up to ~6e-5 of it, as the JAX
script's is). It runs no frame, so the record depends on nothing but the
seed-0 grids and the decoders.

    python -m niceslam_tpu_torch.diagnostics.saturation_probe [DECODERS|none] [--cpu]

The decoders default to ``models/pretrained_decoders.npz``; ``none`` keeps
the seed-0 random ones. One JSON object on standard output. It runs on the
card unless ``--cpu`` is given, and fails where no card is found.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..config.schema import MappingConfig, SLAMConfig, TrackingConfig
from ..io.datasets.synthetic import SyntheticBoxReader
from ..models.decoders import nice_forward
from ..slam.system import NiceSLAM
from .world import DECODERS, card, world_config

STAGES = ("middle", "color")
N_POINTS = 4096


def config(path: str = DECODERS) -> SLAMConfig:
    return world_config(TrackingConfig(gt_camera=True), pretrained=path,
                        mapping=MappingConfig(pixels=1000))


def build(cfg: SLAMConfig, device) -> NiceSLAM:
    """The probe's system: seed 0, one frame in its reader, none run."""
    return NiceSLAM(cfg, reader=SyntheticBoxReader(cfg, n_frames=1), seed=0, device=device)


def points(cfg: SLAMConfig, device) -> torch.Tensor:
    """The 4,096 uniform points of the bound."""
    b = np.asarray(cfg.bound)
    pts = np.random.default_rng(0).uniform(b[:, 0], b[:, 1], size=(N_POINTS, 3))
    return torch.as_tensor(pts, dtype=torch.float32).to(device)


def measure(slam: NiceSLAM, pts: torch.Tensor) -> dict:
    """Each stage's statistics, unrounded."""
    dec, grids = slam.state.decoders, slam.state.grids
    out = {}
    for stage in STAGES:
        with torch.no_grad():
            occ = nice_forward(dec, grids, pts, slam.bounds, stage)[:, 3].cpu().numpy()
        alpha = 1.0 / (1.0 + np.exp(-np.clip(10.0 * occ, -60, 60)))
        middle = grids["middle"].detach().clone().requires_grad_(True)
        raw = nice_forward(dec, {**grids, "middle": middle}, pts, slam.bounds, stage)
        (grad,) = torch.autograd.grad(torch.sum(torch.sigmoid(10.0 * raw[:, 3])), middle)
        out[stage] = {
            "occ_mean": float(occ.mean()),
            "occ_p10": float(np.percentile(occ, 10)),
            "occ_p90": float(np.percentile(occ, 90)),
            "alpha_mean": float(alpha.mean()),
            "frac_alpha_lt_1e-3": float((alpha < 1e-3).mean()),
            "frac_alpha_gt_0.999": float((alpha > 0.999).mean()),
            "docc_dmiddlegrid_norm": float(torch.linalg.norm(grad.double())),
        }
    return out


# Each key's decimals in the script's record.
DECIMALS = {"occ_mean": 3, "occ_p10": 3, "occ_p90": 3, "alpha_mean": 4,
            "frac_alpha_lt_1e-3": 3, "frac_alpha_gt_0.999": 3, "docc_dmiddlegrid_norm": 4}


def rounded(rec: dict) -> dict:
    return {stage: {k: round(v, DECIMALS[k]) for k, v in s.items()} for stage, s in rec.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", nargs="?", default=DECODERS)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    device = card(args.cpu)
    cfg = config(args.path)
    print(json.dumps(rounded(measure(build(cfg, device), points(cfg, device))), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
