#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``niceslam_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--frames 8] [--iters-first 1500] [--profile] [--seeds 1]

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions; the
   kernels are built with ``nvcc`` from ``niceslam_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) into ``build/kernels`` and the
   build times and ``ptxas`` reports are printed.
2. kernels: every kernel of both sampler routes (K1, K2 fused; K3, K4, K5
   packed) at the main path's shapes against its plain PyTorch version on
   the same card tensors, with the max error, the median device time (CUDA
   events), the plain version's time, the time of one PyTorch library call
   computing the same function where there is one, and the bound computed
   from bytes and operations; on uniform random points, and K1, K2 and K5
   again on the points of one mapping batch (frame 0 of the synthetic
   scene at its true pose: stratified and surface samples, which crowd
   into the voxels at the surface). The grid gradients of K2 and K5 must
   equal their fixed-point model (``ops/fixed_point.py``) bit for bit, also
   with the points in another order.
3. card vs CPU, under each route: the port on the card (kernels) against
   the port on the CPU (plain versions) on a small world with injected
   pixels: a Gauss-Newton tracking solve and the mapping loss with its
   gradients.
4. main path, under each route: ``NiceSLAM.step`` of the bench
   configuration (``bench.py``, strict sync) on the synthetic scene, first
   on the fused route, then on the packed route, with the launch counts of
   every kernel (the route's kernels launched, the other route's not),
   per-frame seconds, peak device memory, per-frame position errors and the
   ATE; a lost track (``lost_track``) fails. Frames 0 and 1 of the fused
   run are run again from a new ``NiceSLAM`` and must give the same grids
   and poses bit for bit: one seed is one trajectory on the card. On the
   packed run's frame-0 map both routes' ``sample_grid`` values and grid
   gradients are compared on all four levels at a mapping batch's points.
5. mesher: ``extract_mesh`` at resolution 128 (2,097,152 query points) on
   the packed run's final map under each route, timed once, and one query
   of the occupancy field per route, the two fields compared, then
   ``postprocess_mesh`` and ``write_ply`` to a temporary directory.

``--profile`` adds a phase after the fused main path: two more every_frame
groups, the first timed, the second under ``torch.profiler``, for the
card's busy share and the kernels that take its time (slow: the profiler's
host side takes minutes to digest the ~10^5 kernels of a group).
``--seeds N`` runs the fused main path again for seeds 1 to N-1 and prints
the ATE of every seed.

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
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

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

# The main path counts as having lost the track at an ATE (cm, aligned) of
# about twice the 14.5 cm the camera travels in the first 8 frames of the
# bench, or at a raw position error (cm, unaligned) of more than three times
# that path in any frame: the similarity alignment of the ATE can absorb a
# drift that has left the scene (96.6 cm raw at 26.9 cm ATE seen on an H100).
ATE_LOST_CM = 30.0
RAW_LOST_CM = 45.0

# The kernels of each sampler route, as their wrappers count them.
ROUTE_KERNELS = {
    "fused": ("trilerp_fwd", "trilerp_bwd"),
    "packed": ("corner_table", "gather_rows", "scatter_corners"),
}
BACKWARD_KERNELS = ("trilerp_bwd", "scatter_corners")


def _launch_tables():
    from niceslam_tpu_torch.ops import packed_kernels as pk
    from niceslam_tpu_torch.ops import trilerp_kernels as tk

    return tk.LAUNCHES, pk.LAUNCHES


def all_launches() -> dict:
    return {k: v for table in _launch_tables() for k, v in table.items()}


def set_launches(counts: dict):
    """Set every kernel's launch count (to 0 where ``counts`` has none)."""
    for table in _launch_tables():
        for name in table:
            table[name] = counts.get(name, 0)


def check_route_launches(what: str, route: str, launches: dict, forward_only=False):
    """The route's kernels launched (only its forward ones where nothing is
    differentiated), no other kernel."""
    want = [k for k in ROUTE_KERNELS[route]
            if not (forward_only and k in BACKWARD_KERNELS)]
    for name, cnt in launches.items():
        if name in want and cnt <= 0:
            raise AssertionError(f"{what}: kernel {name} was not launched: {launches}")
        if name not in want and cnt != 0:
            raise AssertionError(f"{what}: kernel {name} launched: {launches}")


def log(*a):
    print(*a, flush=True)


def lost_track(ate_cm: float, err_cm) -> str:
    """Why the track counts as lost (``""`` if it does not): the ATE at or
    over ``ATE_LOST_CM``, or a frame's raw position error at or over
    ``RAW_LOST_CM``. A bound for a lost track, not an accuracy check: that
    is judged over seeds (PERF.md)."""
    if not ate_cm < ATE_LOST_CM:
        return f"ATE {ate_cm:.3f} cm >= {ATE_LOST_CM} cm"
    worst = int(np.argmax(err_cm))
    if not err_cm[worst] < RAW_LOST_CM:
        return f"raw position error {err_cm[worst]:.3f} cm at frame {worst} >= {RAW_LOST_CM} cm"
    return ""


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


def check_order_independent(name, got, want):
    """A grid gradient of the points in another order: the same bits."""
    if not torch.equal(got, want):
        raise AssertionError(
            f"{name}: the sum depends on the order of the points "
            f"(max abs diff {max_err(got, want):.3e})")
    log(f"kernel {name}: bit-equal with the points permuted")


# ----------------------------------------------------------------- phase 1
def phase_card():
    from niceslam_tpu_torch.ops import packed_kernels as pk
    from niceslam_tpu_torch.ops import trilerp_kernels as tk

    log(f"card: {nvidia_smi_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")

    def timed_build(src):
        t0 = time.perf_counter()
        lib, report = tk.build(src, verbose=True)
        return lib, report, time.perf_counter() - t0

    t0 = time.perf_counter()
    srcs = (tk.CSRC / "trilerp.cu", pk.SRC)
    with ThreadPoolExecutor(len(srcs)) as ex:
        built = list(ex.map(timed_build, srcs))
    log(f"build: {len(srcs)} sources in parallel in {time.perf_counter() - t0:.2f} s")
    for lib, report, dt in built:
        log(f"build: {lib.relative_to(ROOT)} in {dt:.2f} s")
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


def surface_points(cfg):
    """Voxel coordinates on the fine and middle grids of the points of one
    mapping batch: frame 0 of the synthetic scene seen from its true pose,
    ``cfg.mapping.pixels`` rays of stratified and surface samples."""
    from niceslam_tpu_torch.ops.trilinear import voxel_coords

    slam, reader = new_slam(cfg, 1, 0)
    frame = reader[0]
    gen = torch.Generator(device="cuda").manual_seed(2)
    pts = mapping_batch_points(slam, frame, torch.as_tensor(frame.gt_c2w, device="cuda"),
                               cfg, gen)
    return {lvl: voxel_coords(pts, slam.bounds[lvl], slam.state.grids[lvl].shape[:3]).contiguous()
            for lvl in ("fine", "middle")}


def kernel_cases(cfg):
    """Phase 2's inputs: per level, a seeded random grid and cotangent at
    uniform random points (fine: the mapping batch's count of points;
    middle: the tracking batch's), then the same grid with a new cotangent
    at the points of :func:`surface_points`."""
    shapes = main_path_grid_shapes(cfg)
    n_track = cfg.tracking.pixels * (cfg.rendering.N_samples + cfg.rendering.N_surface)
    n_map = cfg.mapping.pixels * (cfg.rendering.N_samples + cfg.rendering.N_surface)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for lvl, n in (("fine", n_map), ("middle", n_track)):
        Z, Y, X, C = shapes[lvl]
        grid = torch.randn((Z, Y, X, C), device="cuda", generator=gen) * 0.05
        hi = torch.tensor([Z - 1, Y - 1, X - 1], device="cuda", dtype=torch.float32)
        v = (torch.rand((n, 3), device="cuda", generator=gen) * hi).contiguous()
        g = torch.randn((n, C), device="cuda", generator=gen)
        cases.append(dict(lvl=lvl, points="uniform", grid=grid, v=v, g=g))
    for lvl, v in surface_points(cfg).items():
        grid = next(c["grid"] for c in cases if c["lvl"] == lvl)
        g = torch.randn((v.shape[0], grid.shape[-1]), device="cuda", generator=gen)
        cases.append(dict(lvl=lvl, points="surface", grid=grid, v=v, g=g))
    for c in cases:
        c["perm"] = torch.randperm(c["v"].shape[0], device="cuda", generator=gen)
        c["name"] = f"{c['lvl']}{' surface' if c['points'] == 'surface' else ''} N={c['v'].shape[0]}"
    return cases


def bucket_stats(grid, v) -> str:
    """How the points crowd: distinct start voxels, the largest bucket (K5's
    pairs per start row are 4x that), and the most corner terms one grid
    row of K2 sums."""
    from niceslam_tpu_torch.ops.fixed_point import corner_terms

    rows, _ = corner_terms(grid.shape[:3], v, v[:, :1])
    per_start = torch.bincount(rows[:, 0])
    per_row = torch.bincount(rows.reshape(-1))
    return (f"{int((per_start > 0).sum())} start voxels of {grid[..., 0].numel()}, largest "
            f"bucket {int(per_start.max())} points, most terms in one row {int(per_row.max())}")


def grad_atol(case, ref) -> float:
    """Absolute tolerance of a grid gradient against its plain version:
    1e-5, and on a mapping batch's points 1e-5 of the gradient's largest
    entry: there a grid row sums up to thousands of terms, which the plain
    version adds in fp32 (``index_add_``, in any order on the card), while
    the kernels' sum is exact to within their fixed-point step."""
    if case["points"] == "uniform":
        return 1e-5
    return 1e-5 * max(1.0, float(ref.abs().max()))


def check_model(name, got, model):
    """A grid gradient against its fixed-point model: the same bits."""
    if not torch.equal(got, model):
        raise AssertionError(f"{name}: differs from the fixed-point model "
                             f"(max abs diff {max_err(got, model):.3e})")


def phase_kernels(cfg):
    """Parity, time and bound of K1-K5 at the main path's shapes."""
    import torch.nn.functional as F

    from niceslam_tpu_torch.ops import fixed_point as fp
    from niceslam_tpu_torch.ops import packed_kernels as pk
    from niceslam_tpu_torch.ops import trilerp_kernels as tk

    log(f"main-path grid shapes [Z,Y,X,C]: {main_path_grid_shapes(cfg)}")
    rows = []
    for case in kernel_cases(cfg):
        grid, v, g, perm, name = case["grid"], case["v"], case["g"], case["perm"], case["name"]
        uniform = case["points"] == "uniform"
        Z, Y, X, C = grid.shape
        R, n = Z * Y * X, v.shape[0]
        log(f"kernel inputs [{name}]: {bucket_stats(grid, v)}")
        # The library yardstick: grid_sample on the channel-first volume at
        # normalized xyz coordinates (its border clamp gives equal values).
        hi = torch.tensor([Z - 1, Y - 1, X - 1], device="cuda", dtype=torch.float32)
        vol = grid.permute(3, 0, 1, 2)[None].contiguous()
        nrm = (v.flip(-1) / hi.flip(-1) * 2 - 1).reshape(1, n, 1, 1, 3).contiguous()

        def lib_fwd():
            return F.grid_sample(vol, nrm, mode="bilinear", padding_mode="border",
                                 align_corners=True)

        lib_gout = g.t().reshape(1, C, n, 1, 1).contiguous()

        def lib_bwd():
            return torch.ops.aten.grid_sampler_3d_backward(
                lib_gout, vol, nrm, 0, 1, True, [True, True])

        def row(kname, **kw):
            rows.append(dict(name=kname, case=name, points=case["points"], **kw))

        torch.cuda.synchronize()
        for deriv in ((False, True) if uniform else (False,)):
            out, dout = tk.trilerp_fwd(grid, v, deriv=deriv)
            ref, dref = tk.trilerp_fwd_plain(grid, v, deriv=deriv)
            torch.cuda.synchronize()
            check_close(f"trilerp_fwd[{name}, deriv={deriv}] out", out, ref, 1e-5, 1e-5)
            err = max_err(out, ref)
            if deriv:
                check_close(f"trilerp_fwd[{name}] dV/dv", dout, dref, 1e-5, 1e-5)
                err = max(err, max_err(dout, dref))
            else:
                gs_out = lib_fwd()[0, :, :, 0, 0].t()
                check_close(f"grid_sample[{name}] vs plain", gs_out, ref, 1e-4, 1e-5)
            ms = device_ms(lambda: tk.trilerp_fwd(grid, v, deriv=deriv))
            plain = device_ms(lambda: tk.trilerp_fwd_plain(grid, v, deriv=deriv), reps=10)
            libt = None if deriv else device_ms(lib_fwd)
            nbytes = 4 * (R * C + 3 * n + n * C + (3 * n * C if deriv else 0))
            nops = n * C * (FWD_OPS + (DERIV_OPS if deriv else 0))
            bms, by = bound_ms(nbytes, nops)
            rows.append(dict(name="trilerp_fwd", case=f"{name} deriv={int(deriv)}",
                             points=case["points"], max_abs_err=err, ms=ms, plain_ms=plain,
                             library_ms=libt, bound_ms=bms, bound_by=by))
        dgrid, dv = tk.trilerp_bwd(grid, v, g)
        rdgrid, rdv = tk.trilerp_bwd_plain(grid, v, g)
        pdgrid, _ = tk.trilerp_bwd(grid, v[perm].contiguous(), g[perm].contiguous(),
                                   need_dv=False)
        model = fp.trilerp_bwd_fixed_point(grid, v, g)
        torch.cuda.synchronize()
        # Tolerances: K2 sums in fixed point, index_add_ in fp32.
        check_close(f"trilerp_bwd[{name}] dgrid", dgrid, rdgrid, 1e-5, grad_atol(case, rdgrid))
        check_close(f"trilerp_bwd[{name}] dv", dv, rdv, 2e-5, 2e-5)
        check_model(f"trilerp_bwd[{name}] dgrid", dgrid, model)
        check_order_independent(f"trilerp_bwd[{name}] dgrid", pdgrid, dgrid)
        err = max(max_err(dgrid, rdgrid), max_err(dv, rdv))
        ms = device_ms(lambda: tk.trilerp_bwd(grid, v, g))
        plain = device_ms(lambda: tk.trilerp_bwd_plain(grid, v, g), reps=10)
        libt = device_ms(lib_bwd)
        nbytes = 4 * (R * C + 3 * n + n * C + R * C + 3 * n)
        nops = n * C * (FWD_OPS + DERIV_OPS + BWD_OPS)
        bms, by = bound_ms(nbytes, nops)
        row("trilerp_bwd", max_abs_err=err, ms=ms, plain_ms=plain, library_ms=libt,
            bound_ms=bms, bound_by=by)
        rows += packed_kernel_rows(pk, fp, case, with_table=uniform)
    log("library_ms of corner_table: null, no single PyTorch call builds the "
        "packed table (the plain version is six concatenations)")
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"kernel {r['name']:<15} {r['case']:<34} max_abs_err {r['max_abs_err']:.3e}  "
            f"ms {r['ms']:.4f}  plain_ms {r['plain_ms']:.4f}  library_ms {lib}  "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    return rows


def packed_kernel_rows(pk, fp, case, with_table=True):
    """Parity, time and bound of K5 (and, ``with_table``, of K3 and K4) on
    the inputs of K1 and K2: the table of the grid, the rows at the starts
    of the points, and the corner cotangents ``w8 (x) g`` scattered back
    (and again with the points in the case's order ``perm``)."""
    from niceslam_tpu_torch.ops.trilinear import packed_starts

    grid, v, g, perm, name = case["grid"], case["v"], case["g"], case["perm"], case["name"]
    Z, Y, X, C = grid.shape
    R, n = Z * Y * X, v.shape[0]
    start, w = packed_starts(v, (Z, Y, X))
    idx4 = pk.pair_starts(start, Y, X)
    ct8 = (pk.corner_weights(w[:, 0], w[:, 1], w[:, 2])[:, :, None] * g[:, None, :]).contiguous()
    # The library yardstick of K5: index_add_ of the 8 corner rows (k order).
    rows8 = (idx4[:, :, None] + torch.arange(2, device=v.device, dtype=torch.int32)).reshape(-1)
    ct_flat = ct8.reshape(-1, C)
    out = []

    def row(kname, **kw):
        out.append(dict(name=kname, case=name, points=case["points"], **kw))

    if with_table:
        table = pk.corner_table(grid)
        ref = pk.corner_table_plain(grid)
        torch.cuda.synchronize()
        if not torch.equal(table, ref):  # a copy: bit-exact
            raise AssertionError(f"corner_table[{name}]: kernel disagrees with its plain "
                                 f"version (max abs err {max_err(table, ref):.3e})")
        bms, by = bound_ms(4 * (R * C + R * 8 * C), 0)
        row("corner_table", max_abs_err=max_err(table, ref),
            ms=device_ms(lambda: pk.corner_table(grid)),
            plain_ms=device_ms(lambda: pk.corner_table_plain(grid), reps=10),
            library_ms=None, bound_ms=bms, bound_by=by)

        rows = pk.gather_rows(table, start)
        ref = pk.gather_rows_plain(table, start)
        lib = torch.index_select(table, 0, start)
        torch.cuda.synchronize()
        if not (torch.equal(rows, ref) and torch.equal(lib, ref)):
            raise AssertionError(f"gather_rows[{name}]: kernel disagrees with its plain "
                                 f"version (max abs err {max_err(rows, ref):.3e})")
        bms, by = bound_ms(4 * (2 * n * 8 * C + n), 0)
        row("gather_rows", max_abs_err=max_err(rows, ref),
            ms=device_ms(lambda: pk.gather_rows(table, start)),
            plain_ms=device_ms(lambda: pk.gather_rows_plain(table, start), reps=10),
            library_ms=device_ms(lambda: torch.index_select(table, 0, start)),
            bound_ms=bms, bound_by=by)
        del table, rows, lib

    def lib_scatter():
        return torch.zeros((R, C), device=grid.device).index_add_(0, rows8, ct_flat)

    dflat = pk.scatter_corners(idx4, ct8, R)
    ref = pk.scatter_corners_plain(idx4, ct8, R)
    pflat = pk.scatter_corners(idx4[perm].contiguous(), ct8[perm].contiguous(), R)
    model = fp.scatter_corners_fixed_point(idx4, ct8, R)
    torch.cuda.synchronize()
    # Tolerance: K5 sums in fixed point, index_add_ in fp32.
    atol = grad_atol(case, ref)
    check_close(f"scatter_corners[{name}]", dflat, ref, 1e-5, atol)
    check_model(f"scatter_corners[{name}]", dflat, model)
    check_order_independent(f"scatter_corners[{name}]", pflat, dflat)
    check_close(f"index_add_[{name}] vs plain", lib_scatter(), ref, 1e-5, atol)
    bms, by = bound_ms(4 * (n * 8 * C + 4 * n + R * C), n * 8 * C)
    row("scatter_corners", max_abs_err=max_err(dflat, ref),
        ms=device_ms(lambda: pk.scatter_corners(idx4, ct8, R)),
        plain_ms=device_ms(lambda: pk.scatter_corners_plain(idx4, ct8, R), reps=10),
        library_ms=device_ms(lib_scatter), bound_ms=bms, bound_by=by)
    return out


# ----------------------------------------------------------------- phase 3
def phase_card_vs_cpu(route: str):
    """The port on the card against the port on the CPU, small world, on
    the sampler route ``route``."""
    from niceslam_tpu_torch.core.pose import tensor_from_camera
    from niceslam_tpu_torch.core.rays import Intrinsics
    from niceslam_tpu_torch.grid.hierarchy import GridConfig, init_grids
    from niceslam_tpu_torch.io.datasets.synthetic import circular_trajectory, render_box_scene
    from niceslam_tpu_torch.models.decoders import DecoderConfig, init_decoders, tree_map
    from niceslam_tpu_torch.models.pretrained import load_decoders_npz
    from niceslam_tpu_torch.ops.trilinear import sampler_route
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

    with sampler_route(route):
        set_launches({})
        gpu = run("cuda")
        launched = all_launches()
        cpu = run("cpu")
    check_route_launches(f"card vs CPU [{route}]", route, launched)
    log(f"card vs cpu [{route}] launches: {launched}")
    # 1e-4 relative to each quantity's largest entry: fp32 sums and atomics
    # in another order than on the CPU.
    worst = 0.0
    for k in cpu:
        scale = max(float(cpu[k].abs().max()), 1e-12)
        rel = max_err(gpu[k], cpu[k]) / scale
        worst = max(worst, rel)
        log(f"card vs cpu [{route}] {k:<18} max rel err {rel:.3e}")
        if not rel <= 1e-4:
            raise AssertionError(f"card vs CPU [{route}]: {k} differs by {rel:.3e} (> 1e-4)")
    moved = float(np.abs(gpu["pose"].numpy() - init).max())
    if not moved > 1e-3:
        raise AssertionError(f"GN solve did not move the pose ({moved:.2e})")
    return worst


# ----------------------------------------------------------------- phase 4
def new_slam(cfg, n_frames: int, seed: int):
    """A ``NiceSLAM`` on the bench's 36-frame trajectory that runs the first
    ``n_frames`` of it, on the card (the default device)."""
    from niceslam_tpu_torch.io.datasets.synthetic import SyntheticBoxReader
    from niceslam_tpu_torch.slam.system import NiceSLAM

    reader = SyntheticBoxReader(cfg, n_frames=36)
    slam = NiceSLAM(cfg, reader=reader, seed=seed)
    slam.n_imgs = n_frames
    return slam, reader


def snapshot(slam) -> dict:
    """The map's grids (copies on the card) and the poses so far."""
    return dict(grids={lvl: g.detach().clone() for lvl, g in slam.state.grids.items()},
                poses=np.stack(slam.est_c2w))


def phase_main_path(cfg, n_frames: int, seed: int = 0, route: str = "fused",
                    keep: int = 0):
    """``NiceSLAM.step`` over ``n_frames`` under ``route``; with ``keep`` the
    result holds a :func:`snapshot` after frame ``keep - 1``."""
    from niceslam_tpu_torch.ops.trilinear import sampler_route

    slam, reader = new_slam(cfg, n_frames, seed)
    frames = [reader[k] for k in range(n_frames)]
    kept = None
    tag = f"[{route}] seed {seed}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_launches({})
    dts = []
    for k, frame in enumerate(frames):
        t0 = time.perf_counter()
        with sampler_route(route):
            slam.step(frame)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        ev = [e for e in slam.events if e.get("frame") == k]
        fr = ev[-1]
        log(f"{tag} frame {k}: {dts[-1]:.3f} s (track {fr['dt_track']:.3f} s, map "
            f"{fr['dt_map']:.3f} s)  " + " ".join(
                f"{e['event']}({'coarse' if e.get('coarse') else 'staged'})"
                for e in ev[:-1]))
        if k == 0 and route == "packed":
            # Not part of the main path: its launches are taken out again.
            counts = all_launches()
            compare_routes_on_map(slam, frame, cfg)
            set_launches(counts)
        if k == keep - 1:
            kept = snapshot(slam)
    peak = torch.cuda.max_memory_allocated()
    launches = all_launches()
    log(f"{tag}: main-path launches: {launches}")
    log(f"{tag}: peak device memory {peak / 2**20:.1f} MiB (max_memory_allocated)")
    check_route_launches(f"main path {tag}", route, launches)
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
    log(f"{tag}: per-frame seconds: {[round(d, 4) for d in dts]}")
    log(f"{tag}: tracked frames/s after frame 0: {(len(dts) - 1) / sum(dts[1:]):.4f}")
    log(f"{tag}: position error per frame (cm): {[round(float(e), 2) for e in err_cm]}")
    log(f"{tag}: ATE RMSE over {n_frames} frames: {ate_cm:.4f} cm")
    # Accuracy is judged over seeds, against the tripwire's bounds, by
    # tests/test_torch_slam.py; here only a lost track fails.
    lost = lost_track(ate_cm, err_cm)
    if lost:
        raise AssertionError(f"{tag}: the track is lost: {lost}")
    return dict(launches=launches, slam=slam, reader=reader, ate_cm=ate_cm, dts=dts,
                peak_bytes=peak, kept=kept, seed=seed, route=route, n_frames=n_frames)


def phase_repeat(cfg, run: dict, frames: int):
    """The first ``frames`` frames of ``run`` again, from a new ``NiceSLAM``
    on the same seed and route: the grids and poses must equal ``run``'s
    snapshot bit for bit (the grid gradients of K2 and K5 do not depend on
    the order of their atomics, and nothing else on the path does either)."""
    from niceslam_tpu_torch.ops.trilinear import sampler_route

    slam, reader = new_slam(cfg, run["n_frames"], run["seed"])
    t0 = time.perf_counter()
    with sampler_route(run["route"]):
        for k in range(frames):
            slam.step(reader[k])
    torch.cuda.synchronize()
    got, want = snapshot(slam), run["kept"]
    diffs = {lvl: max_err(got["grids"][lvl], want["grids"][lvl]) for lvl in want["grids"]}
    dpose = float(np.abs(got["poses"] - want["poses"]).max())
    log(f"[{run['route']}] seed {run['seed']} frames 0-{frames - 1} again "
        f"({time.perf_counter() - t0:.3f} s): max abs diff of the grids {diffs}, "
        f"of the poses {dpose:.3e}")
    same = all(torch.equal(got["grids"][lvl], want["grids"][lvl]) for lvl in want["grids"])
    if not (same and np.array_equal(got["poses"], want["poses"])):
        raise AssertionError(f"[{run['route']}] seed {run['seed']}: a second run of frames "
                             f"0-{frames - 1} differs from the first")


def mapping_batch_points(slam, frame, c2w, cfg, gen):
    """World points ``[P * (N_samples + N_surface), 3]`` of one mapping
    batch: ``cfg.mapping.pixels`` pixels of ``frame`` drawn from ``gen``,
    cast from pose ``c2w``, with stratified and surface samples."""
    from niceslam_tpu_torch.core import rays, sampling

    color = torch.as_tensor(frame.color, device="cuda")
    depth = torch.as_tensor(frame.depth, device="cuda")
    i, j = rays.draw_pixels(gen, slam.intr, cfg.mapping.pixels)
    rb = rays.sample_rays(slam.intr, c2w, depth, color, i, j)
    near, far = rays.near_far_from_bound(
        rb.rays_o, rb.rays_d, slam.scene_bound, rb.gt_depth, cfg.rendering.N_samples)
    z = sampling.merge_z_vals(
        sampling.stratified_z_vals(near, far, cfg.rendering.N_samples),
        sampling.surface_z_vals(rb.gt_depth, cfg.rendering.N_surface,
                                cfg.rendering.surface_band))
    return sampling.points_along_rays(rb.rays_o, rb.rays_d, z).reshape(-1, 3).contiguous()


def compare_routes_on_map(slam, frame, cfg):
    """Both routes' ``sample_grid`` values and grid gradients on every level
    of the current map, at the points of one mapping batch (pixels of
    ``frame`` at its estimated pose, stratified + surface samples)."""
    from niceslam_tpu_torch.ops.trilinear import sample_grid, sampler_route

    gen = torch.Generator(device="cuda").manual_seed(1)
    pts = mapping_batch_points(
        slam, frame, torch.as_tensor(slam.est_c2w[-1], device="cuda"), cfg, gen)
    for lvl, grid in slam.state.grids.items():
        gout = torch.randn((pts.shape[0], grid.shape[-1]), device="cuda", generator=gen)
        got = {}
        for route in ("fused", "packed"):
            g = grid.detach().clone().requires_grad_(True)
            with sampler_route(route):
                val = sample_grid(g, pts, slam.bounds[lvl])
            (val * gout).sum().backward()
            got[route] = (val.detach(), g.grad)
        torch.cuda.synchronize()
        # Values 1e-5: the lerps round alike. Grid gradients 1e-5 of their
        # largest entry: K2 and K5 round each of up to thousands of terms per
        # voxel to fixed-point steps of their own (each has its own bound).
        check_close(f"routes[{lvl}] values", got["packed"][0], got["fused"][0], 1e-5, 1e-5)
        diff = max_err(got["packed"][1], got["fused"][1])
        scale = max(1.0, float(got["fused"][1].abs().max()))
        log(f"routes on frame-0 map [{lvl} {tuple(grid.shape)}] at {pts.shape[0]} points: "
            f"max abs diff values {max_err(got['packed'][0], got['fused'][0]):.3e}, "
            f"grid grad {diff:.3e} (largest entry {scale:.3e})")
        if not diff <= 1e-5 * scale:
            raise AssertionError(f"routes[{lvl}]: grid gradients differ by {diff:.3e}")


# ----------------------------------------------------------------- phase 5
def phase_mesher(slam, cfg, resolution: int = 128):
    """``extract_mesh`` of the final map under each route, timed once, and
    the occupancy field of one query per route, the two fields compared;
    ``postprocess_mesh`` and ``write_ply`` of the packed mesh."""
    from niceslam_tpu_torch.eval import mesher
    from niceslam_tpu_torch.ops.trilinear import sampler_route

    st = slam.state
    args = (st.decoders, st.grids, slam.bounds, slam.scene_bound)
    fields, meshes = {}, {}
    for route in ("fused", "packed"):
        with sampler_route(route):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            set_launches({})
            t0 = time.perf_counter()
            occ, _ = mesher.query_occupancy_grid(*args, resolution=resolution)
            t_query = time.perf_counter() - t0
            launches = all_launches()
            peak = torch.cuda.max_memory_allocated()
            t0 = time.perf_counter()
            meshes[route] = mesher.extract_mesh(
                *args, resolution=resolution, level=cfg.meshing.level_set)
            t_all = time.perf_counter() - t0
        check_route_launches(f"mesher [{route}]", route, launches, forward_only=True)
        if not np.isfinite(occ).all():
            raise AssertionError(f"mesher [{route}]: non-finite occupancy")
        verts, faces, _ = meshes[route]
        if not (len(verts) > 0 and len(faces) > 0):
            raise AssertionError(f"mesher [{route}]: empty mesh")
        fields[route] = occ
        log(f"mesher [{route}]: {occ.size} query points in {-(-occ.size // 65536)} chunks: "
            f"query {t_query:.3f} s (launches {launches}, peak device memory "
            f"{peak / 2**20:.1f} MiB); extract_mesh {t_all:.3f} s, of which "
            f"{t_all - t_query:.3f} s past the query (marching tetrahedra on the host, "
            f"vertex colors): {len(verts)} verts, {len(faces)} faces")
    # Tolerance: 1e-4 of the field's scale. The routes' features differ by
    # rounding (K1 fuses the lerp into FMAs, the packed lerp runs op by op)
    # and the decoders carry that to the occupancy.
    diff = float(np.abs(fields["packed"] - fields["fused"]).max())
    scale = max(1.0, float(np.abs(fields["fused"]).max()))
    log(f"mesher: fields of the two routes: max abs diff {diff:.3e} "
        f"(field scale {scale:.3f}, tolerance {1e-4 * scale:.3e})")
    if not diff <= 1e-4 * scale:
        raise AssertionError(f"mesher: the routes' fields differ by {diff:.3e}")
    # The cleanup of the JAX package's mesher, copied: its frustum test
    # takes camera z forward while the poses look along -z (ROADMAP, queue
    # 3), so it may cull what the cameras saw. Both meshes are written.
    verts, faces, colors = meshes["packed"]
    t0 = time.perf_counter()
    clean = mesher.postprocess_mesh(
        verts, faces, colors, cfg.meshing, poses_c2w=np.stack(slam.est_c2w), intr=slam.intr)
    log(f"mesher: postprocess_mesh (clean_mesh={cfg.meshing.clean_mesh}) in "
        f"{time.perf_counter() - t0:.3f} s: {len(verts)} -> {len(clean[0])} verts, "
        f"{len(faces)} -> {len(clean[1])} faces")
    with tempfile.TemporaryDirectory() as tmp:
        for name, mesh in (("extracted", meshes["packed"]), ("postprocessed", clean)):
            path = os.path.join(tmp, f"{name}.ply")
            t0 = time.perf_counter()
            mesher.write_ply(path, *mesh)
            log(f"mesher: write_ply of the {name} mesh: {os.path.getsize(path)} bytes "
                f"in {time.perf_counter() - t0:.3f} s")


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
    for route in ROUTE_KERNELS:
        phase_card_vs_cpu(route)
    repeat = min(2, args.frames)
    runs = {"fused": phase_main_path(cfg, args.frames, keep=repeat)}
    phase_repeat(cfg, runs["fused"], repeat)
    if args.profile:
        phase_profile(runs["fused"]["slam"], runs["fused"]["reader"], cfg.mapping.every_frame)
    del runs["fused"]["slam"]  # the packed run's peak memory is its own
    runs["packed"] = phase_main_path(cfg, args.frames, route="packed")
    for route, run in runs.items():
        log(f"routes: [{route}] frame seconds {[round(d, 4) for d in run['dts']]}, "
            f"after frame 0 {sum(run['dts'][1:]):.3f} s, peak device memory "
            f"{run['peak_bytes'] / 2**20:.1f} MiB, ATE {run['ate_cm']:.4f} cm")
    t0 = time.perf_counter()
    phase_mesher(runs["packed"]["slam"], cfg)
    log(f"mesher phase: {time.perf_counter() - t0:.1f} s")
    del runs["packed"]["slam"]
    ates = [runs["fused"]["ate_cm"]] + [phase_main_path(cfg, args.frames, seed)["ate_cm"]
                                        for seed in range(1, args.seeds)]
    log(f"ATE per seed (cm), fused route: {[round(a, 4) for a in ates]}, "
        f"mean {np.mean(ates):.4f}")

    sources = {
        "fused": "niceslam_tpu_torch/csrc/trilerp.cu",
        "packed": "niceslam_tpu_torch/csrc/packed_table.cu",
    }
    # The pallas_call of each TPU kernel in niceslam_tpu/ops/pallas_trilerp.py.
    pallas_call_line = {"trilerp_fwd": 244, "trilerp_bwd": 413, "corner_table": 128,
                        "gather_rows": 163, "scatter_corners": 306}
    # One entry per kernel at its largest main-path call (the mapping batch
    # on the fine grid, uniform points; K1 without its derivative output),
    # with its launches
    # on its own route's main path.
    kernels = []
    for route, names in ROUTE_KERNELS.items():
        for name in names:
            r = next(r for r in rows if r["name"] == name and r["points"] == "uniform"
                     and r["case"].startswith("fine") and "deriv=1" not in r["case"])
            kernels.append({
                "name": name, "route": "cuda", "source": sources[route],
                "replaces": f"niceslam_tpu/ops/pallas_trilerp.py:{pallas_call_line[name]}",
                "launches": runs[route]["launches"][name], "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
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
