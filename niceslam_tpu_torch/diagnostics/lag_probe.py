"""Per-frame tracking lag: the counterpart of the JAX package's
``scripts/lag_probe.py``, with its arguments, configuration and record.

Drives the whole loop frame by frame (strict sync, after ``precompile()``)
and reports, for every frame, the translation error of the constant-speed
warm start that the tracker departs from (rebuilt from the last two
tracked poses with ``core/pose.constant_speed_warm_start``, as the system
builds it), the error of the tracked pose it lands on, their difference
(what the tracker added this frame) and whether the frame was mapped: it
tells drift of the motion model from an under-converged tracker and from
frames right after a mapping event.

    python -m niceslam_tpu_torch.diagnostics.lag_probe [--frames 36] \\
        [--pretrained DECODERS] [--separate-lr] [--track-iters 10] \\
        [--track-pixels 200] [--track-lr 0.001] [--depth-gate 0.3] [--seed 0] [--cpu]

Each frame's row goes to standard error as it is done, the ATE and every
row to standard output as one JSON object. The JAX script joins
``precompile_async()``, which the port has not; it runs ``precompile()``.
It runs on the card unless ``--cpu`` is given, and fails where no card is
found.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..config.schema import SLAMConfig, TrackingConfig
from ..core.pose import constant_speed_warm_start
from ..io.datasets.synthetic import SyntheticBoxReader
from ..slam.system import NiceSLAM
from .world import DECODERS, as_tensor, card, world_config

ROWS_KEY = "rows (k, warmstart_err, tracked_err, delta, mapped)"


def config(pretrained: str = DECODERS, separate_lr: bool = False, track_iters: int = 10,
           track_pixels: int = 200, track_lr: float = 1e-3,
           depth_gate: float = 0.3) -> SLAMConfig:
    return world_config(
        TrackingConfig(pixels=track_pixels, iters=track_iters, lr=track_lr,
                       seperate_LR=separate_lr, depth_err_gate=depth_gate),
        pretrained=pretrained, decoder_train="never")


def build(cfg: SLAMConfig, frames: int, seed: int, device):
    """The probe's system, its programs captured: ``(slam, reader)``."""
    reader = SyntheticBoxReader(cfg, n_frames=frames)
    slam = NiceSLAM(cfg, reader=reader, seed=seed, device=device)
    slam.precompile()
    return slam, reader


def warm_start(slam: NiceSLAM, gt_c2w) -> np.ndarray:
    """The pose the next frame's solve departs from, rebuilt from the
    tracked poses: the constant-speed extrapolation of the last two from
    frame 2 on, the last one at frame 1, the true pose at frame 0."""
    est = slam.est_c2w
    if len(est) >= 2:
        prev, prev2 = (as_tensor(p, slam.device) for p in (est[-1], est[-2]))
        return constant_speed_warm_start(prev, prev2).cpu().numpy()
    if len(est) == 1:
        return np.asarray(est[-1], np.float32)
    return np.asarray(gt_c2w, np.float32)


def measure(slam: NiceSLAM, reader, frames: int) -> dict:
    """Steps every frame: ``{"ate_rmse_cm", "rows", "warm_starts"}``, the
    rows ``(k, warm start error, tracked error, mapped)`` in cm, unrounded,
    and each frame's rebuilt warm start; the ATE is the error's text where
    the result has none (a non-finite trajectory)."""
    every = slam.cfg.mapping.every_frame
    rows, starts = [], []
    for k in range(frames):
        f = reader[k]
        ws = warm_start(slam, f.gt_c2w)
        slam.step(f)
        est = np.asarray(slam.est_c2w[-1])
        e_ws = 100 * float(np.linalg.norm(ws[:3, 3] - f.gt_c2w[:3, 3]))
        e_tr = 100 * float(np.linalg.norm(est[:3, 3] - f.gt_c2w[:3, 3]))
        rows.append((k, e_ws, e_tr, k % every == 0))
        starts.append(ws)
        print("frame", rounded_row(rows[-1]), file=sys.stderr, flush=True)
    try:
        ate = 100 * slam.result().get("ate_rmse", float("nan"))
    except Exception as ex:  # noqa: BLE001 — a NaN trajectory breaks the alignment's SVD
        ate = f"error: {ex}"
    return {"ate_rmse_cm": ate, "rows": rows, "warm_starts": starts}


def rounded_row(row) -> tuple:
    k, e_ws, e_tr, mapped = row
    return (k, round(e_ws, 2), round(e_tr, 2), round(e_tr - e_ws, 2), mapped)


def rounded(rec: dict) -> dict:
    ate = rec["ate_rmse_cm"]
    return {"ate_rmse_cm": ate if isinstance(ate, str) else round(ate, 3),
            ROWS_KEY: [rounded_row(r) for r in rec["rows"]]}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--pretrained", default=DECODERS)
    ap.add_argument("--separate-lr", action="store_true")
    ap.add_argument("--track-iters", type=int, default=10)
    ap.add_argument("--track-pixels", type=int, default=200)
    ap.add_argument("--track-lr", type=float, default=1e-3)
    ap.add_argument("--depth-gate", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    cfg = config(args.pretrained, args.separate_lr, args.track_iters, args.track_pixels,
                 args.track_lr, args.depth_gate)
    slam, reader = build(cfg, args.frames, args.seed, card(args.cpu))
    print(json.dumps(rounded(measure(slam, reader, args.frames)), indent=0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
