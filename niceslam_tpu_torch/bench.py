"""End-to-end SLAM benchmark of the port on the card: the counterpart of the
JAX package's ``bench.py``, step for step.

Runs the full tracker and mapper loop on the synthetic analytic scene at
the bench configuration (:func:`bench_config`: 640x480 RGB-D, GN tracking
400 rays x 20 iterations a frame, mapping 1000 rays x 60 iterations every
5th frame, 32+16 samples, c_dim 32, the shipped decoders) and reports
steady-state tracked frames/s:

1. the frames are staged on the card before any system is built (the
   analytic frame generator is harness, not engine);
2. each seed's system runs the same schedule on them: ``precompile()``
   captures every graph (the JAX bench joins ``precompile_async()``, which
   the port has not), 6 warm-up frames (frame 0 maps with 1500
   iterations), a synchronize, then the other frames up to ``result()``
   and a synchronize: async sync dispatches ahead of the host, so a window
   ends on completed work. Seed 0's window is the timed one;
3. ATE over ``BENCH_SEEDS`` seeds, seed 0 the timed run. Each seed's
   ``NiceSLAM`` is built after the previous one is released, so that its
   graphs reuse the card's one graph pool (``slam/programs.py``);
4. each seed logs its own ATE, or ``n/a``, with the device memory
   allocated before its system, its graph pool and its peak memory;
5. the whole-step roofline (:func:`roofline_shares`) from the port's
   ``utils/roofline.py``, whose device table raises for an unknown card.

``vs_baseline`` anchors to 1.0 frames/s, as the JAX bench does. Standard
output gets exactly one JSON line, with the JAX bench's keys; everything
else goes to standard error.

    python -m niceslam_tpu_torch.bench [--cpu]

Environment, as the JAX bench reads it: ``BENCH_TRACK_PX`` (400),
``BENCH_KF`` (10), ``BENCH_SYNC`` (``async``), ``BENCH_FRAMES`` (36),
``BENCH_SEEDS`` (8); only :func:`main` reads them. It runs on the card
unless ``--cpu`` is given, and fails where no card is found.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .config.schema import (
    CamConfig,
    GridLenConfig,
    MappingConfig,
    SLAMConfig,
    TrackingConfig,
)
from .io.datasets.base import Frame
from .io.datasets.synthetic import SyntheticBoxReader
from .slam.programs import pool_bytes
from .slam.system import NiceSLAM
from .utils import roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM = 6
# The bench's world: the synthetic scene's bound and the 640x480 camera.
BOUND = ((-4.5, 3.82), (-1.5, 2.02), (-3.0, 2.76))
CAM = CamConfig(H=480, W=640, fx=360.0, fy=360.0, cx=320.0, cy=240.0)
DECODERS = os.path.join(ROOT, "models", "pretrained_decoders.npz")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_env(environ=os.environ) -> dict:
    """The ``BENCH_*`` variables that set the configuration, read as the JAX
    bench reads them, as :func:`bench_config`'s arguments."""
    return dict(sync=environ.get("BENCH_SYNC", "async"),
                track_px=int(environ.get("BENCH_TRACK_PX", "400")),
                kf=int(environ.get("BENCH_KF", "10")))


def bench_config(sync: str = "async", track_px: int = 400, kf: int = 10,
                 random_decoders: bool = False) -> SLAMConfig:
    """``bench.py``'s configuration in the port's dataclasses: ``sync``,
    ``track_px`` and ``kf`` take the place of ``BENCH_SYNC``,
    ``BENCH_TRACK_PX`` and ``BENCH_KF`` (:func:`bench_env` reads them).
    Without ``models/pretrained_decoders.npz`` it raises, unless
    ``random_decoders``: then the decoders stay random, as the JAX bench
    warns."""
    pretrained = DECODERS
    if not os.path.exists(pretrained):
        if not random_decoders:
            raise FileNotFoundError(f"{pretrained}: the shipped decoders are missing")
        log("WARNING: models/pretrained_decoders.npz not found — benchmarking "
            "with FROZEN RANDOM decoders (not the reference operating point)")
        pretrained = ""
    return SLAMConfig(
        dataset="synthetic",
        bound=BOUND,
        pretrained_middle_fine=pretrained,
        cam=CAM,
        grid_len=GridLenConfig(),
        tracking=TrackingConfig(
            pixels=track_px,
            iters=20,
            gn_depth_offset_sigma=0.05,
        ),
        mapping=MappingConfig(
            pixels=1000,
            iters_first=1500,
            iters=60,
            every_frame=5,
            keyframe_every=kf,
            mapping_window_size=5,
            max_keyframes=64,
            color_refine=False,
            bootstrap_frames=5,
            fs_weight=3.0,
            retrack=True,
        ),
        coarse=True,
        verbose=False,
        sync_method=sync,
    )


def roofline_shares(cfg: SLAMConfig, grid_bytes: dict, per_frame_s: float,
                    peaks: roofline.ChipPeaks) -> dict:
    """The JAX bench's whole-step roofline: the analytic FLOPs and bytes of
    one ``every_frame`` group (every frame tracks ``tracking.iters``
    iterations, one frame maps: a coarse and a staged pass of
    ``mapping.iters`` each) over the group's measured seconds, as shares of
    the card's peaks, and the frames/s at the bound."""
    m, t = cfg.mapping, cfg.tracking
    samples = cfg.rendering.N_samples + cfg.rendering.N_surface
    track = roofline.render_cost(t.pixels, samples, cfg.model.c_dim, grid_bytes, "color",
                                 backward=True)
    mapping = roofline.mapping_step_cost(m.pixels, samples, cfg.model.c_dim, grid_bytes)
    flops = m.every_frame * t.iters * track["flops"] + 2 * m.iters * mapping["flops"]
    nbytes = m.every_frame * t.iters * track["bytes"] + 2 * m.iters * mapping["bytes"]
    group_s = per_frame_s * m.every_frame
    t_bytes = nbytes / (peaks.hbm_gbps * 1e9)
    t_flops = flops / peaks.flops_f32
    return {"hbm_util": t_bytes / group_s, "mfu": t_flops / group_s,
            "sol_fps": m.every_frame / max(t_bytes, t_flops)}


def _synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _release(device: torch.device):
    """Free what a released system held (its graphs' pool among it) and
    start a new reading of peak device memory."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _mib(nbytes: float, device: torch.device) -> str:
    return f"{nbytes / 2**20:.1f} MiB" if device.type == "cuda" else "n/a"


def _run_seed(cfg: SLAMConfig, reader, frames, seed: int, warm: int, device: torch.device):
    """One seed's ``NiceSLAM`` on the staged frames, built once the card is
    released: ``precompile()``, the warm-up frames, a synchronize, then the
    other frames up to ``result()`` and a synchronize, timed. Logs the
    seed's own ATE (``n/a`` where its result has none), its seconds, the
    device memory allocated before its system was built, the graph pool and
    the peak since. Returns the result, the timed seconds and the grids'
    bytes."""
    _release(device)
    start = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    slam = NiceSLAM(cfg, reader=reader, seed=seed, device=device)
    t0 = time.perf_counter()
    slam.precompile()
    _synchronize(device)
    precompile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for frame in frames[:warm]:
        tf = time.perf_counter()
        slam.step(frame)
        if seed == 0:
            log(f"warmup frame {frame.idx}: {time.perf_counter() - tf:.3f} s")
    _synchronize(device)
    if seed == 0:
        log(f"precompile (all signatures): {precompile_s:.3f} s, "
            f"{len(slam._programs.captures)} graphs")
        log(f"warmup {warm} frames: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    for frame in frames[warm:]:
        slam.step(frame)
    res = slam.result()
    _synchronize(device)
    dt = time.perf_counter() - t0
    ate = res.get("ate_rmse")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"seed {seed}: ATE RMSE = {'n/a' if ate is None else f'{round(100 * ate, 3)} cm'}; "
        f"precompile {precompile_s:.3f} s; frames {warm}-{len(frames) - 1} {dt:.3f} s; "
        f"allocated at start {_mib(start, device)}; graph pool "
        f"{pool_bytes() / 2**20:.1f} MiB; peak {_mib(peak, device)}")
    return res, dt, {lvl: g.numel() * 4 for lvl, g in slam.state.grids.items()}


def run(cfg: SLAMConfig, n_frames: int = 36, seeds: int = 8, warm: int = WARM,
        device="cuda") -> dict:
    """The bench on ``device``: prints its JSON line on standard output and
    returns it. Every seed runs the same schedule on the same staged frames;
    seed 0's frames after the warm-up are the timed window."""
    device = torch.device(device)
    reader = SyntheticBoxReader(cfg, n_frames=n_frames)
    frames = []
    for k in range(n_frames):
        f = reader[k]
        frames.append(Frame(idx=f.idx, color=torch.as_tensor(f.color).to(device),
                            depth=torch.as_tensor(f.depth).to(device), gt_c2w=f.gt_c2w))
    _synchronize(device)

    res, dt, grid_bytes = _run_seed(cfg, reader, frames, 0, warm, device)
    fps = (n_frames - warm) / dt
    ate = res.get("ate_rmse")
    log(f"steady-state: {n_frames - warm} frames in {dt:.3f} s -> {fps:.4f} fps")
    ates = [] if ate is None else [float(ate)]
    for seed in range(1, seeds):
        r, _, _ = _run_seed(cfg, reader, frames, seed, warm, device)
        if r.get("ate_rmse") is not None:
            ates.append(float(r["ate_rmse"]))
    ate_mean = float(np.mean(ates)) if ates else None

    peaks = roofline.device_peaks(
        torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    shares = roofline_shares(cfg, grid_bytes, dt / (n_frames - warm), peaks)
    log(f"roofline({peaks.name}): hbm_util={shares['hbm_util']:.4f} "
        f"mfu={shares['mfu']:.5f} speed-of-light fps={shares['sol_fps']:.2f}")
    line = {
        "metric": "end_to_end_tracked_frames_per_s",
        "value": round(fps, 4),
        "unit": "frames/s",
        "vs_baseline": round(fps / 1.0, 4),
        "ate_rmse_cm": None if ate_mean is None else round(ate_mean * 100, 4),
        "ate_seed0_cm": None if ate is None else round(ate * 100, 4),
        "ate_seeds_cm": [round(a * 100, 3) for a in ates],
        "hbm_util": round(shares["hbm_util"], 4),
        "mfu": round(shares["mfu"], 5),
        "sol_fps": round(shares["sol_fps"], 2),
        "chip": peaks.name,
    }
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --cpu to run the bench "
                               "on the CPU")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()
        log(f"card: {smi[torch.cuda.current_device()]}")
    run(bench_config(**bench_env(), random_decoders=True),
        int(os.environ.get("BENCH_FRAMES", "36")),
        int(os.environ.get("BENCH_SEEDS", "8")), WARM, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
