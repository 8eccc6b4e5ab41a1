"""Tracking error against map error on the bench world: the counterpart of
the JAX package's ``scripts/accuracy_probe.py``, with its flags,
configuration and record.

Runs ``NiceSLAM.run(frames)`` on the synthetic scene at the bench's world
under one variation of the tracker, the mapper or the decoders, and reports
the ATE, the raw (unaligned) position error's mean, largest and last
values, the relative pose error (each frame's step against the true step:
the tracker's share, free of accumulated drift) and the whole error curve;
with ``--depth-psnr`` the last frame rendered at its true pose: the depth's
mean absolute error and the colour's PSNR.

    python -m niceslam_tpu_torch.diagnostics.accuracy_probe --frames 24 --gt-camera  # map only
    python -m niceslam_tpu_torch.diagnostics.accuracy_probe --frames 24              # whole loop
    python -m niceslam_tpu_torch.diagnostics.accuracy_probe --decoder-train never [--cpu]

Every flag of the JAX script is here (``--help``); the decoders are random
unless ``--pretrained`` names them, as there. The programs are captured
(``precompile()``) before the timed run; the JAX script starts
``precompile_async()`` and does not wait for it. One JSON line on standard
output. It runs on the card unless ``--cpu`` is given, and fails where no
card is found.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..accuracy_sweep import render_check
from ..config.schema import SLAMConfig, TrackingConfig
from ..io.datasets.synthetic import SyntheticBoxReader
from ..slam.system import NiceSLAM
from .world import card, synchronize, world_config


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--gt-camera", action="store_true")
    ap.add_argument("--decoder-train", default="init", choices=["never", "init", "always"],
                    help="mapping.decoder_train policy (never = round-1 frozen-random "
                    "behavior)")
    ap.add_argument("--no-coarse", action="store_true")
    ap.add_argument("--no-ba", action="store_true")
    ap.add_argument("--sync", default="async")
    ap.add_argument("--track-iters", type=int, default=10)
    ap.add_argument("--track-pixels", type=int, default=200)
    ap.add_argument("--track-lr", type=float, default=1e-3)
    ap.add_argument("--track-wcolor", type=float, default=0.5)
    ap.add_argument("--no-color-track", action="store_true")
    ap.add_argument("--no-dynamic", action="store_true")
    ap.add_argument("--depth-gate", type=float, default=0.3)
    ap.add_argument("--track-method", default="gn", choices=["gn", "adam"])
    ap.add_argument("--gn-prior-r", type=float, default=0.02)
    ap.add_argument("--gn-prior-t", type=float, default=0.03)
    ap.add_argument("--tv", type=float, default=0.0, help="mapping.tv_weight grid smoothness")
    ap.add_argument("--ba-min", type=int, default=4, help="mapping.BA_min_keyframes gate")
    ap.add_argument("--bootstrap", type=int, default=0, help="mapping.bootstrap_frames")
    ap.add_argument("--separate-lr", action="store_true")
    ap.add_argument("--map-pixels", type=int, default=1000)
    ap.add_argument("--map-iters", type=int, default=60)
    ap.add_argument("--iters-first", type=int, default=1500)
    ap.add_argument("--every-frame", type=int, default=5)
    ap.add_argument("--keyframe-every", type=int, default=10)
    ap.add_argument("--pretrained", default="",
                    help="pretrained decoder npz (cfg.pretrained_middle_fine)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--depth-psnr", action="store_true",
                    help="render final-frame depth and report L1/PSNR")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    return ap


def config(args: argparse.Namespace) -> SLAMConfig:
    return world_config(
        TrackingConfig(
            pixels=args.track_pixels, iters=args.track_iters, lr=args.track_lr,
            gt_camera=args.gt_camera, w_color_loss=args.track_wcolor,
            use_color_in_tracking=not args.no_color_track,
            handle_dynamic=not args.no_dynamic, depth_err_gate=args.depth_gate,
            method=args.track_method, gn_prior_sigma_r=args.gn_prior_r,
            gn_prior_sigma_t=args.gn_prior_t, seperate_LR=args.separate_lr,
        ),
        pretrained=args.pretrained, sync=args.sync, coarse=not args.no_coarse,
        pixels=args.map_pixels, iters_first=args.iters_first, iters=args.map_iters,
        every_frame=args.every_frame, keyframe_every=args.keyframe_every,
        BA=not args.no_ba, BA_min_keyframes=args.ba_min, bootstrap_frames=args.bootstrap,
        decoder_train=args.decoder_train, tv_weight=args.tv,
    )


def measure(args: argparse.Namespace, device) -> dict:
    """The variant's run and its record, unrounded."""
    cfg = config(args)
    n = args.frames
    reader = SyntheticBoxReader(cfg, n_frames=n)
    slam = NiceSLAM(cfg, reader=reader, seed=args.seed, device=device)
    slam.precompile()
    synchronize(device)
    t0 = time.perf_counter()
    slam.run(n)
    res = slam.result()
    synchronize(device)
    dt = time.perf_counter() - t0

    est, gt = np.asarray(res["est_c2w"]), np.asarray(res["gt_c2w"])
    terr = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
    rpe = np.linalg.norm((est[1:, :3, 3] - est[:-1, :3, 3]) - (gt[1:, :3, 3] - gt[:-1, :3, 3]),
                         axis=-1)
    out = {
        "frames": n,
        "wall_s": dt,
        "ate_rmse_cm": 100 * res.get("ate_rmse", float("nan")),
        "raw_t_err_cm": {"mean": 100 * float(terr.mean()), "max": 100 * float(terr.max()),
                         "last": 100 * float(terr[-1])},
        "rpe_t_cm": {"mean": 100 * float(rpe.mean()),
                     "p90": 100 * float(np.percentile(rpe, 90))},
        "t_err_curve_cm": [100 * float(e) for e in terr],
        "variant": {
            "gt_camera": args.gt_camera,
            "decoder_train": args.decoder_train,
            "pretrained": bool(args.pretrained),
            "seed": args.seed,
            "coarse": not args.no_coarse,
            "BA": not args.no_ba,
            "track": [args.track_pixels, args.track_iters, args.track_lr],
        },
    }
    if args.depth_psnr:
        out["depth_l1_cm"], out["color_psnr_db"] = render_check(slam, reader[n - 1], gt[-1])
    return out


def rounded(rec: dict) -> dict:
    out = dict(rec)
    out["wall_s"] = round(rec["wall_s"], 1)
    out["ate_rmse_cm"] = round(rec["ate_rmse_cm"], 3)
    for k in ("raw_t_err_cm", "rpe_t_cm"):
        out[k] = {kk: round(v, 3) for kk, v in rec[k].items()}
    out["t_err_curve_cm"] = [round(e, 2) for e in rec["t_err_curve_cm"]]
    if "depth_l1_cm" in rec:
        out["depth_l1_cm"] = round(rec["depth_l1_cm"], 3)
        out["color_psnr_db"] = round(rec["color_psnr_db"], 2)
    return out


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    print(json.dumps(rounded(measure(args, card(args.cpu)))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
