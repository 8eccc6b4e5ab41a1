"""Where the rendered depth's error lives in the map: the counterpart of the
JAX package's ``scripts/depth_diag.py``, with its arguments, configuration
and record.

Maps the bench world with the true poses (no tracking, async sync), then
renders the whole depth image (``render_image``) at a few frames, at the
``middle``, ``fine`` and ``color`` stages, and reports each one's error over
the pixels with depth: the signed mean (``bias_cm``), the mean absolute
error and its median and 90th percentile. A bad first frame means the
optimisation never fits; a good first and bad later frames mean the map
does not generalise.

    python -m niceslam_tpu_torch.diagnostics.depth_diag [--frames 16] \\
        [--pretrained DECODERS] [--eval-frames K ...] [--seed 0] \\
        [--iters-first 1500] [--iters 60] [--cpu]

The frames evaluated default to the first, the middle and the last. One
JSON list on standard output. It runs on the card unless ``--cpu`` is
given, and fails where no card is found.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..config.schema import SLAMConfig, TrackingConfig
from ..io.datasets.synthetic import SyntheticBoxReader
from ..render.renderer import render_image
from ..slam.system import NiceSLAM
from .world import DECODERS, as_tensor, card, world_config

STAGES = ("middle", "fine", "color")


def config(pretrained: str = DECODERS, iters_first: int = 1500, iters: int = 60) -> SLAMConfig:
    return world_config(TrackingConfig(pixels=200, iters=10, gt_camera=True),
                        pretrained=pretrained, sync="async", iters_first=iters_first,
                        iters=iters)


def run(cfg: SLAMConfig, frames: int, seed: int, device):
    """``frames`` frames mapped at their true poses: ``(slam, reader)``."""
    reader = SyntheticBoxReader(cfg, n_frames=frames)
    slam = NiceSLAM(cfg, reader=reader, seed=seed, device=device)
    slam.run(frames)
    slam.result()
    return slam, reader


def measure(slam: NiceSLAM, reader, eval_frames) -> list:
    """One row per frame of ``eval_frames``, each stage's errors unrounded."""
    dev = slam.device
    rows = []
    for k in eval_frames:
        f = reader[k]
        row = {"frame": k}
        for stage in STAGES:
            ro = render_image(slam.state.decoders, slam.state.grids, slam.bounds,
                              slam.scene_bound, slam.intr, as_tensor(f.gt_c2w, dev),
                              as_tensor(f.depth, dev), stage, slam.rcfg)
            serr = (ro.depth.cpu().numpy() - f.depth)[f.depth > 0]
            err = np.abs(serr)
            row[stage] = {
                "bias_cm": 100 * float(serr.mean()),
                "l1_cm": 100 * float(err.mean()),
                "p50_cm": 100 * float(np.percentile(err, 50)),
                "p90_cm": 100 * float(np.percentile(err, 90)),
            }
        rows.append(row)
    return rows


def rounded(rows: list) -> list:
    return [{k: v if k == "frame" else {kk: round(x, 2) for kk, x in v.items()}
             for k, v in row.items()} for row in rows]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--pretrained", default=DECODERS)
    ap.add_argument("--eval-frames", type=int, nargs="*", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters-first", type=int, default=1500)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = card(args.cpu)
    n = args.frames
    slam, reader = run(config(args.pretrained, args.iters_first, args.iters), n, args.seed,
                       device)
    print(json.dumps(rounded(measure(slam, reader, args.eval_frames or [0, n // 2, n - 1])),
                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
