#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``niceslam_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--frames 8] [--iters-first 1500] [--profile] [--seeds 1]

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions; the
   kernels are built with ``nvcc`` from ``niceslam_tpu_torch/csrc`` into
   ``build/kernels`` and the build time and ``ptxas`` report are printed.
2. kernels: every kernel of the main path at the main path's shapes against
   its plain PyTorch version on the same card tensors, with the max error,
   the median device time (CUDA events), the plain version's time, the time
   of one PyTorch library call computing the same function, and the bound
   computed from bytes and operations.
3. card vs CPU: the port on the card (kernels) against the port on the CPU
   (plain versions) on a small world with injected pixels: a Gauss-Newton
   tracking solve and the mapping loss with its gradients.
4. main path: ``NiceSLAM.step`` of the bench configuration (``bench.py``,
   strict sync) on the synthetic scene, with the launch counts of every
   kernel, per-frame seconds, per-frame position errors and the ATE.

``--profile`` adds a last phase: two more every_frame groups, the first
timed, the second under ``torch.profiler``, for the card's busy share and
the kernels that take its time (slow: the profiler's host side takes
minutes to digest the ~10^5 kernels of a group). ``--seeds N`` runs the
main path again for seeds 1 to N-1 and prints the ATE of every seed.

It then prints the kernels' JSON line, the card's ``nvidia-smi`` line and,
last, ``{"ok": true, "device": {...}}``. It needs one CUDA device and the
rest of the repository beside it; without either it fails.
"""
import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense, at the 700 W power limit): HBM3 rate and
# fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# Operations per point and channel, counted from the kernels' arithmetic:
# 7 lerps of 3 flops; the derivative adds 19; the backward adds 8 weight
# products and 8 atomic adds for dgrid plus 6 for the dv contraction.
FWD_OPS, DERIV_OPS, BWD_OPS = 21, 19, 22

# ATE (cm) at which the main path counts as having lost the track: about
# twice the 14.5 cm the camera travels in the first 8 frames of the bench.
ATE_LOST_CM = 30.0


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()]


def device_ms(fn, reps: int = 50, rounds: int = 7) -> float:
    """Median device time of one ``fn()`` in ms (CUDA events).

    A spin kernel keeps the card busy while the host enqueues ``reps``
    calls, so the events bracket back-to-back device work and not the
    host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def bound_ms(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def check_close(name, got, want, rtol, atol):
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(max abs err {max_err(got, want):.3e}, rtol {rtol}, atol {atol})"
        )


# ----------------------------------------------------------------- phase 1
def phase_card():
    from niceslam_tpu_torch.ops import trilerp_kernels as tk

    log(f"card: {nvidia_smi_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib, report = tk.build(verbose=True)
    log(f"build: {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")


# ----------------------------------------------------------------- phase 2
def bench_config():
    """``bench.py``'s configuration, strict sync, as the port's dataclasses."""
    from niceslam_tpu_torch.config.schema import (
        CamConfig, GridLenConfig, MappingConfig, SLAMConfig, TrackingConfig,
    )

    return SLAMConfig(
        dataset="synthetic",
        bound=((-4.5, 3.82), (-1.5, 2.02), (-3.0, 2.76)),
        pretrained_middle_fine=os.path.join(ROOT, "models", "pretrained_decoders.npz"),
        cam=CamConfig(H=480, W=640, fx=360.0, fy=360.0, cx=320.0, cy=240.0),
        grid_len=GridLenConfig(),
        tracking=TrackingConfig(pixels=400, iters=20, gn_depth_offset_sigma=0.05),
        mapping=MappingConfig(
            pixels=1000, iters_first=1500, iters=60, every_frame=5,
            keyframe_every=10, mapping_window_size=5, max_keyframes=64,
            color_refine=False, bootstrap_frames=5, fs_weight=3.0, retrack=True,
        ),
        coarse=True,
        verbose=False,
        sync_method="strict",
    )


def main_path_grid_shapes(cfg):
    from niceslam_tpu_torch.grid.hierarchy import adjust_bound, grid_shape

    b = adjust_bound(np.asarray(cfg.bound, np.float32) * cfg.scale,
                     cfg.grid_len.bound_divisable)
    return {
        lvl: grid_shape(b, getattr(cfg.grid_len, lvl),
                        cfg.model.coarse_bound_enlarge if lvl == "coarse" else 1.0)
        + (cfg.model.c_dim,)
        for lvl in ("coarse", "middle", "fine", "color")
    }


def phase_kernels(cfg):
    """Parity, time and bound of K1 and K2 at the main path's shapes."""
    import torch.nn.functional as F

    from niceslam_tpu_torch.ops import trilerp_kernels as tk

    shapes = main_path_grid_shapes(cfg)
    log(f"main-path grid shapes [Z,Y,X,C]: {shapes}")
    n_track = cfg.tracking.pixels * (cfg.rendering.N_samples + cfg.rendering.N_surface)
    n_map = cfg.mapping.pixels * (cfg.rendering.N_samples + cfg.rendering.N_surface)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for lvl, n in (("fine", n_map), ("middle", n_track)):
        Z, Y, X, C = shapes[lvl]
        R = Z * Y * X
        grid = torch.randn((Z, Y, X, C), device="cuda", generator=gen) * 0.05
        hi = torch.tensor([Z - 1, Y - 1, X - 1], device="cuda", dtype=torch.float32)
        v = (torch.rand((n, 3), device="cuda", generator=gen) * hi).contiguous()
        g = torch.randn((n, C), device="cuda", generator=gen)
        # The library yardstick: grid_sample on the channel-first volume at
        # normalized xyz coordinates (its border clamp gives equal values).
        vol = grid.permute(3, 0, 1, 2)[None].contiguous()
        nrm = (v.flip(-1) / hi.flip(-1) * 2 - 1).reshape(1, n, 1, 1, 3).contiguous()

        def lib_fwd():
            return F.grid_sample(vol, nrm, mode="bilinear", padding_mode="border",
                                 align_corners=True)

        lib_gout = g.t().reshape(1, C, n, 1, 1).contiguous()

        def lib_bwd():
            return torch.ops.aten.grid_sampler_3d_backward(
                lib_gout, vol, nrm, 0, 1, True, [True, True])

        torch.cuda.synchronize()
        for deriv in (False, True):
            out, dout = tk.trilerp_fwd(grid, v, deriv=deriv)
            ref, dref = tk.trilerp_fwd_plain(grid, v, deriv=deriv)
            torch.cuda.synchronize()
            check_close(f"trilerp_fwd[{lvl}, deriv={deriv}] out", out, ref, 1e-5, 1e-5)
            err = max_err(out, ref)
            if deriv:
                check_close(f"trilerp_fwd[{lvl}] dV/dv", dout, dref, 1e-5, 1e-5)
                err = max(err, max_err(dout, dref))
            else:
                gs_out = lib_fwd()[0, :, :, 0, 0].t()
                check_close(f"grid_sample[{lvl}] vs plain", gs_out, ref, 1e-4, 1e-5)
            ms = device_ms(lambda: tk.trilerp_fwd(grid, v, deriv=deriv))
            plain = device_ms(lambda: tk.trilerp_fwd_plain(grid, v, deriv=deriv), reps=10)
            libt = None if deriv else device_ms(lib_fwd)
            nbytes = 4 * (R * C + 3 * n + n * C + (3 * n * C if deriv else 0))
            nops = n * C * (FWD_OPS + (DERIV_OPS if deriv else 0))
            bms, by = bound_ms(nbytes, nops)
            rows.append(dict(name="trilerp_fwd", case=f"{lvl} N={n} deriv={int(deriv)}",
                             max_abs_err=err, ms=ms, plain_ms=plain, library_ms=libt,
                             bound_ms=bms, bound_by=by))
        dgrid, dv = tk.trilerp_bwd(grid, v, g)
        rdgrid, rdv = tk.trilerp_bwd_plain(grid, v, g)
        torch.cuda.synchronize()
        # Tolerances: the atomics add in another order than index_add_.
        check_close(f"trilerp_bwd[{lvl}] dgrid", dgrid, rdgrid, 1e-5, 1e-5)
        check_close(f"trilerp_bwd[{lvl}] dv", dv, rdv, 2e-5, 2e-5)
        err = max(max_err(dgrid, rdgrid), max_err(dv, rdv))
        ms = device_ms(lambda: tk.trilerp_bwd(grid, v, g))
        plain = device_ms(lambda: tk.trilerp_bwd_plain(grid, v, g), reps=10)
        libt = device_ms(lib_bwd)
        nbytes = 4 * (R * C + 3 * n + n * C + R * C + 3 * n)
        nops = n * C * (FWD_OPS + DERIV_OPS + BWD_OPS)
        bms, by = bound_ms(nbytes, nops)
        rows.append(dict(name="trilerp_bwd", case=f"{lvl} N={n}", max_abs_err=err,
                         ms=ms, plain_ms=plain, library_ms=libt, bound_ms=bms,
                         bound_by=by))
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"kernel {r['name']:<12} {r['case']:<26} max_abs_err {r['max_abs_err']:.3e}  "
            f"ms {r['ms']:.4f}  plain_ms {r['plain_ms']:.4f}  library_ms {lib}  "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    return rows


# ----------------------------------------------------------------- phase 3
def phase_card_vs_cpu():
    """The port on the card against the port on the CPU, small world."""
    from niceslam_tpu_torch.core.pose import tensor_from_camera
    from niceslam_tpu_torch.core.rays import Intrinsics
    from niceslam_tpu_torch.grid.hierarchy import GridConfig, init_grids
    from niceslam_tpu_torch.io.datasets.synthetic import circular_trajectory, render_box_scene
    from niceslam_tpu_torch.models.decoders import DecoderConfig, init_decoders, tree_map
    from niceslam_tpu_torch.models.pretrained import load_decoders_npz
    from niceslam_tpu_torch.render.renderer import RenderConfig
    from niceslam_tpu_torch.slam import mapper
    from niceslam_tpu_torch.slam.tracker import TrackConfig, track_frame

    bound = np.array([[-2.2, 2.2]] * 3, np.float32)
    intr = Intrinsics(H=48, W=64, fx=40.0, fy=40.0, cx=32.0, cy=24.0)
    rcfg = RenderConfig(n_samples=16, n_surface=8)
    rng = np.random.default_rng(0)
    gcfg = GridConfig(coarse_len=1.5, middle_len=0.5, fine_len=0.25, color_len=0.25,
                      bound_divisable=0.25)
    grids, bounds, sb = init_grids(bound, gcfg, gen=torch.Generator().manual_seed(1),
                                   device="cpu")
    grids = {k: torch.from_numpy(rng.normal(size=g.shape).astype(np.float32) * 0.05)
             for k, g in grids.items()}
    dec = load_decoders_npz(
        os.path.join(ROOT, "models", "pretrained_decoders.npz"),
        init_decoders(DecoderConfig(), gen=torch.Generator().manual_seed(0), device="cpu"),
    )
    poses = circular_trajectory(6, radius=0.5, arc_fraction=0.8, height_amp=0.2)
    frames = [render_box_scene(intr, poses[k], bound * 0.9) for k in (0, 2, 4)]
    init = poses[2].copy()
    init[:3, 3] += np.array([0.02, -0.015, 0.01], np.float32)
    tcfg = TrackConfig(pixels=200, iters=2, ignore_edge_H=4, ignore_edge_W=4,
                       gn_depth_offset_sigma=0.05)
    px = [(rng.integers(4, intr.W - 4, 200), rng.integers(4, intr.H - 4, 200))
          for _ in range(tcfg.iters)]
    F_ = 4
    colors = np.zeros((F_, intr.H, intr.W, 3), np.float32)
    depths = np.zeros((F_, intr.H, intr.W), np.float32)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (F_, 1, 1))
    for w, k in enumerate((0, 2, 4)):
        colors[w], depths[w] = frames[w]
        c2ws[w] = poses[k]
    valid = np.array([True, True, True, False])
    fixed = np.array([True, False, False, True])
    n = 300
    fidx, pi, pj = rng.integers(0, 3, n), rng.integers(0, intr.W, n), rng.integers(0, intr.H, n)

    def run(dev):
        to = lambda a, dt=None: torch.as_tensor(a, dtype=dt).to(dev)  # noqa: E731
        g_d = {k: v.to(dev) for k, v in grids.items()}
        d_d = tree_map(lambda t: t.to(dev), dec)
        b_d = {k: v.to(dev) for k, v in bounds.items()}
        sb_d = to(sb)
        color, depth = frames[1]
        pose, losses = track_frame(
            d_d, g_d, b_d, sb_d, intr, to(color), to(depth), to(init), tcfg, rcfg,
            pixels=[(to(i, torch.long), to(j, torch.long)) for i, j in px],
        )
        params = {
            "grids": {k: v.clone().requires_grad_(True) for k, v in g_d.items()},
            "decoders": d_d,
            "cams": tensor_from_camera(to(c2ws)).detach().requires_grad_(True),
        }
        loss = mapper.mapping_loss(
            params, b_d, sb_d, intr, to(colors), to(depths), to(valid), to(fixed),
            to(fidx, torch.long), to(pi, torch.long), to(pj, torch.long), "color", 0.2,
            rcfg, tv_weight=0.5, fs_weight=1.0, fs_band=0.05,
        )
        loss.backward()
        out = {"pose": pose, "track_losses": losses, "map_loss": loss.detach(),
               "cams_grad": params["cams"].grad}
        out.update({f"grid_grad_{k}": v.grad for k, v in params["grids"].items()
                    if v.grad is not None})
        return {k: v.detach().cpu() for k, v in out.items()}

    from niceslam_tpu_torch.ops import trilerp_kernels as tk

    tk.reset_launches()
    gpu = run("cuda")
    launched = dict(tk.LAUNCHES)
    cpu = run("cpu")
    if not (launched["trilerp_fwd"] > 0 and launched["trilerp_bwd"] > 0):
        raise AssertionError(f"card run did not launch both kernels: {launched}")
    # 1e-4 relative to each quantity's largest entry: fp32 sums and atomics
    # in another order than on the CPU.
    worst = 0.0
    for k in cpu:
        scale = max(float(cpu[k].abs().max()), 1e-12)
        rel = max_err(gpu[k], cpu[k]) / scale
        worst = max(worst, rel)
        log(f"card vs cpu {k:<18} max rel err {rel:.3e}")
        if not rel <= 1e-4:
            raise AssertionError(f"card vs CPU: {k} differs by {rel:.3e} (> 1e-4)")
    moved = float(np.abs(gpu["pose"].numpy() - init).max())
    if not moved > 1e-3:
        raise AssertionError(f"GN solve did not move the pose ({moved:.2e})")
    return worst


# ----------------------------------------------------------------- phase 4
def phase_main_path(cfg, n_frames: int, seed: int = 0):
    from niceslam_tpu_torch.io.datasets.synthetic import SyntheticBoxReader
    from niceslam_tpu_torch.ops import trilerp_kernels as tk
    from niceslam_tpu_torch.slam.system import NiceSLAM

    # The bench's 36-frame trajectory; the first n_frames of it are run.
    reader = SyntheticBoxReader(cfg, n_frames=36)
    frames = [reader[k] for k in range(n_frames)]
    slam = NiceSLAM(cfg, reader=reader, seed=seed)  # device defaults to cuda
    slam.n_imgs = n_frames
    torch.cuda.synchronize()
    tk.reset_launches()
    dts = []
    for k, frame in enumerate(frames):
        t0 = time.perf_counter()
        slam.step(frame)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        ev = [e for e in slam.events if e.get("frame") == k]
        fr = ev[-1]
        log(f"frame {k}: {dts[-1]:.3f} s (track {fr['dt_track']:.3f} s, map "
            f"{fr['dt_map']:.3f} s)  " + " ".join(
                f"{e['event']}({'coarse' if e.get('coarse') else 'staged'})"
                for e in ev[:-1]))
    launches = dict(tk.LAUNCHES)
    log(f"main-path launches: {launches}")
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    res = slam.result()
    poses = np.stack(res["est_c2w"])
    if not np.isfinite(poses).all():
        raise AssertionError("non-finite poses")
    for lvl, g in slam.state.grids.items():
        if g.device.type != "cuda" or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"grid {lvl} not finite on the card")
    rejected = [e for e in slam.events if e["event"] == "map_rejected"]
    if rejected:
        raise AssertionError(f"mapping passes rejected: {rejected}")
    ate_cm = 100.0 * res["ate_rmse"]
    err_cm = 100.0 * np.linalg.norm(
        poses[:, :3, 3] - np.stack(res["gt_c2w"])[:, :3, 3], axis=1)
    log(f"seed {seed}: per-frame seconds: {[round(d, 4) for d in dts]}")
    log(f"seed {seed}: tracked frames/s after frame 0: {(len(dts) - 1) / sum(dts[1:]):.4f}")
    log(f"seed {seed}: position error per frame (cm): {[round(float(e), 2) for e in err_cm]}")
    log(f"seed {seed}: ATE RMSE over {n_frames} frames: {ate_cm:.4f} cm")
    # A lost track, not an accuracy check: one seed's ATE over these frames
    # changes from run to run (the grid gradient's atomics), and single runs
    # on an H100 ranged from about 1 to 17 cm (PERF.md); accuracy is judged
    # over seeds, against the tripwire's bounds, by tests/test_torch_slam.py.
    if not ate_cm < ATE_LOST_CM:
        raise AssertionError(f"ATE {ate_cm:.3f} cm: the track is lost (>= {ATE_LOST_CM} cm)")
    return launches, slam, reader, ate_cm


# ------------------------------------------------------- optional profile
def phase_profile(slam, reader, group: int):
    """Where the time of a steady-state every_frame group goes (tracking-only
    frames and one mapping event). One group runs unprofiled for its wall
    time; the next, equivalent group runs under ``torch.profiler`` (CUDA
    activity) for the card's kernel time, which the profiler does not
    inflate as it does the host's. Busy share = kernel time / wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(n):
        start = len(slam.est_c2w)
        frames = [reader[k] for k in range(start, start + n)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for frame in frames:
            slam.step(frame)
        torch.cuda.synchronize()
        ev = [e for e in slam.events if e["event"] == "frame" and e["frame"] >= start]
        return time.perf_counter() - t0, ev

    wall, ev = run(group)
    log(f"profile: frames {ev[0]['frame']}-{ev[-1]['frame']} unprofiled: wall {wall:.3f} s, "
        f"track {sum(e['dt_track'] for e in ev):.3f} s, map {sum(e['dt_map'] for e in ev):.3f} s")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_p, ev = run(group)
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kern) / 1e6
    if not busy_s > 0:
        raise AssertionError("the profiler recorded no kernel time on the card")
    n_kern = sum(e.count for e in kern)
    log(f"profile: frames {ev[0]['frame']}-{ev[-1]['frame']} profiled: wall {wall_p:.3f} s, "
        f"kernel time {busy_s:.4f} s in {n_kern} kernels (mean {busy_s / n_kern * 1e6:.2f} us), "
        f"busy share {busy_s / wall:.4f} of the unprofiled wall")
    ranked = sorted(kern, key=lambda e: -e.self_device_time_total)
    for e in ranked[:10] + [e for e in ranked[10:] if "trilerp" in e.key]:
        log(f"profile:   {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x  {e.key[:100]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--iters-first", type=int, default=1500)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--seeds", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import niceslam_tpu_torch  # noqa: F401  (sets TF32 off)

    cfg = bench_config()
    if args.iters_first != cfg.mapping.iters_first:
        log(f"cut: mapping.iters_first {cfg.mapping.iters_first} -> {args.iters_first}")
        cfg = dataclasses.replace(
            cfg, mapping=dataclasses.replace(cfg.mapping, iters_first=args.iters_first))
    if args.frames != 8:
        log(f"cut: frames 8 -> {args.frames}")

    t_all = time.perf_counter()
    phase_card()
    rows = phase_kernels(cfg)
    phase_card_vs_cpu()
    launches, slam, reader, ate0 = phase_main_path(cfg, args.frames)
    if args.profile:
        phase_profile(slam, reader, cfg.mapping.every_frame)
    del slam
    ates = [ate0] + [phase_main_path(cfg, args.frames, seed)[3]
                     for seed in range(1, args.seeds)]
    log(f"ATE per seed (cm): {[round(a, 4) for a in ates]}, mean {np.mean(ates):.4f}")

    src = "niceslam_tpu_torch/csrc/trilerp.cu"
    replaces = {
        "trilerp_fwd": "niceslam_tpu/ops/pallas_trilerp.py:206",
        "trilerp_bwd": "niceslam_tpu/ops/pallas_trilerp.py:394",
    }
    # One entry per kernel at its largest main-path call (the mapping batch
    # on the fine grid; K1 without its derivative output).
    kernels = []
    for name in ("trilerp_fwd", "trilerp_bwd"):
        r = next(r for r in rows if r["name"] == name and r["case"].startswith("fine")
                 and "deriv=1" not in r["case"])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces[name],
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    log(f"total seconds: {time.perf_counter() - t_all:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
