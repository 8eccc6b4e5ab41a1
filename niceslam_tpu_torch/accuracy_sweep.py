"""Multi-seed and multi-variant ATE sweep in one process: the counterpart of
the JAX package's ``scripts/accuracy_sweep.py``, with its keys, its
defaults and its records.

    python -m niceslam_tpu_torch.accuracy_sweep [--cpu] [--out SWEEP.jsonl] \\
        base:seed=0 base:seed=1 boot:seed=0:bootstrap=5 tv:seed=0:tv=0.01 ...

Each positional argument is ``name[:key=val]*``. Keys (:data:`DEFAULTS`):
seed, frames, bootstrap, bi (bootstrap_iters), ba_min, balr (BA_cam_lr),
tv, fs, fsband, lock, kf_every, every, window, map_pixels, map_iters,
iters_first, method (gn|adam), prior_r, prior_t, gate, step_clip, doff
(gn_depth_offset_sigma), cs (const_speed), retrack, iters, pixels,
use_color, w_color, nsurf, sband, gt_camera, pretrained (0 disables), pt
(decoder artifact suffix), depth_psnr. Each variant runs
``NiceSLAM.run(frames)`` on the synthetic scene at the bench's world
(640x480, the bench's bound and grids), its graphs captured as they are
first met; with ``depth_psnr`` the last frame is rendered at its true pose
(``render_image``) for a depth L1 and a colour PSNR. One JSON line per
variant goes to standard output and to ``--out``.

A variant that fails is recorded (its ``error``) and the sweep goes on, as
the JAX sweep does; the command then exits 1. It runs on the card unless
``--cpu`` is given, and fails where no card is found.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from .bench import BOUND, CAM
from .config.schema import (
    GridLenConfig,
    MappingConfig,
    RenderingConfig,
    SLAMConfig,
    TrackingConfig,
)
from .io.datasets.synthetic import SyntheticBoxReader
from .render.renderer import render_image
from .slam.system import NiceSLAM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


DEFAULTS = dict(
    seed=0, frames=36, bootstrap=0, ba_min=4, tv=0.0, kf_every=10, every=5,
    method="gn", prior_r=0.02, prior_t=0.03, gate=0.3, step_clip=0.02,
    iters=10, pixels=200, gt_camera=0, pretrained=1, depth_psnr=0,
    map_iters=60, iters_first=1500, window=5, use_color=1, map_pixels=1000,
    w_color=0.5, fs=0.0, fsband=0.05, balr=0.001, pt="default", retrack=0, nsurf=16,
    sband=0.05, cs=1, doff=0.0, lock=0, bi=0,
)


def parse_variant(spec: str) -> dict:
    parts = spec.split(":")
    v = dict(DEFAULTS)
    v["name"] = parts[0]
    for kv in parts[1:]:
        k, val = kv.split("=")
        if k not in DEFAULTS:
            raise KeyError(f"unknown sweep key {k!r}")
        v[k] = type(DEFAULTS[k])(float(val)) if isinstance(
            DEFAULTS[k], (int, float)) else val
    return v


def sweep_config(v: dict) -> SLAMConfig:
    """The variant's configuration: each key on the config field the JAX
    sweep sets from it."""
    pt_file = ("pretrained_decoders.npz" if v["pt"] == "default"
               else f"pretrained_decoders_{v['pt']}.npz")
    return SLAMConfig(
        dataset="synthetic",
        bound=BOUND,
        pretrained_middle_fine=os.path.join(ROOT, "models", pt_file) if v["pretrained"] else "",
        cam=CAM,
        grid_len=GridLenConfig(),
        tracking=TrackingConfig(
            pixels=v["pixels"], iters=v["iters"], gt_camera=bool(v["gt_camera"]),
            depth_err_gate=v["gate"], method=v["method"],
            gn_prior_sigma_r=v["prior_r"], gn_prior_sigma_t=v["prior_t"],
            gn_step_clip=v["step_clip"],
            use_color_in_tracking=bool(v["use_color"]),
            const_speed_assumption=bool(v["cs"]),
            gn_depth_offset_sigma=v["doff"],
            w_color_loss=v["w_color"],
        ),
        mapping=MappingConfig(
            pixels=v["map_pixels"], iters_first=v["iters_first"], iters=v["map_iters"],
            every_frame=v["every"], keyframe_every=v["kf_every"],
            mapping_window_size=v["window"], max_keyframes=64,
            color_refine=False, BA_min_keyframes=v["ba_min"], BA_cam_lr=v["balr"],
            bootstrap_frames=v["bootstrap"], bootstrap_iters=v["bi"], tv_weight=v["tv"],
            fs_weight=v["fs"], fs_band=v["fsband"], retrack=bool(v["retrack"]),
            lock_after=v["lock"],
        ),
        coarse=True,
        verbose=False,
        sync_method="async",
        rendering=RenderingConfig(N_surface=v["nsurf"], surface_band=v["sband"]),
    )


def run_one(v: dict, device="cuda") -> dict:
    """One variant on ``device``: its record."""
    device = torch.device(device)
    cfg = sweep_config(v)
    n = v["frames"]
    reader = SyntheticBoxReader(cfg, n_frames=n)
    slam = NiceSLAM(cfg, reader=reader, seed=v["seed"], device=device)
    t0 = time.perf_counter()
    slam.run(n)
    res = slam.result()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    est = np.asarray(res["est_c2w"])
    gt = np.asarray(res["gt_c2w"])
    terr = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
    out = {
        "name": v["name"],
        "seed": v["seed"],
        "frames": n,
        "wall_s": round(dt, 1),
        "fps": round(n / dt, 2),
        "ate_rmse_cm": round(100 * res.get("ate_rmse", float("nan")), 3),
        "t_err_cm": {
            "mean": round(100 * float(terr.mean()), 2),
            "max": round(100 * float(terr.max()), 2),
            "last": round(100 * float(terr[-1]), 2),
        },
        "curve_cm": [round(100 * float(e), 1) for e in terr[::3]],
        "variant": {k: v[k] for k in sorted(v) if k != "name"},
    }
    if v["depth_psnr"]:
        l1_cm, psnr = render_check(slam, reader[n - 1], gt[-1])
        out["depth_l1_cm"] = round(l1_cm, 3)
        out["color_psnr_db"] = round(psnr, 2)
    return out


def render_check(slam: NiceSLAM, frame, c2w) -> tuple:
    """``frame`` rendered (``render_image``, colour stage) at the pose
    ``c2w``: the depth's mean absolute error in cm over the pixels with
    depth and the colour's PSNR in dB, unrounded."""
    dev = slam.device
    ro = render_image(
        slam.state.decoders, slam.state.grids, slam.bounds, slam.scene_bound,
        slam.intr, torch.as_tensor(c2w, device=dev),
        torch.as_tensor(frame.depth, device=dev), "color", slam.rcfg,
    )
    d = ro.depth.cpu().numpy()
    m = frame.depth > 0
    mse = float(((ro.rgb.cpu().numpy() - frame.color) ** 2).mean())
    return 100 * float(np.abs(d - frame.depth)[m].mean()), -10 * np.log10(mse + 1e-12)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("variants", nargs="+")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to run the sweep "
                           "on the CPU")
    variants = [parse_variant(spec) for spec in args.variants]
    failed = []
    sink = open(args.out, "a") if args.out else None
    try:
        for spec, v in zip(args.variants, variants):
            log(f"--- running {spec}")
            t0 = time.perf_counter()
            try:
                rec = run_one(v, device)
            except Exception as e:  # noqa: BLE001 — record it, go on, exit non-zero
                log(traceback.format_exc())
                rec = {"name": v["name"], "seed": v["seed"],
                       "error": str(e).split("\n")[0][:300]}
                failed.append(spec)
            rec["total_s"] = round(time.perf_counter() - t0, 1)
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            # The variant's system is gone: its graphs' pool goes back.
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    if failed:
        log(f"{len(failed)} of {len(variants)} variants failed: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
