"""Per-op microbenchmarks of the port on the card: the counterpart of the JAX
package's ``scripts/kernel_bench.py``, with its op names and record keys.

Main section, at the bench's grids (``GridConfig()`` on the bench bound,
random decoders) and N = 48,000 uniform points, one mapping batch:

- ``trilinear_fwd_<level>`` and ``trilinear_fwdbwd_<level>``:
  ``sample_grid`` and its grid gradient on the middle, fine and color
  grids (K1, and K1 with K2, on the default fused route);
- ``nice_forward_<stage>``: the decoder chain at each stage;
- ``compositing``: ``raw_to_outputs`` on 1000 rays x 48 samples;
- ``render_fwd_<track|map>`` and ``render_fwdbwd_<track|map>``:
  ``render_rays`` and its grid gradient at 200 and 1000 rays.

Pallas section (``--pallas``), on the middle and fine grids at the same
points: each hand-written kernel that replaces a ``pallas_call`` under
the name the JAX script gave it, beside the op the JAX script set against
it: ``corner_table_pallas`` K3 (``corner_table_xla``: its plain version,
six concatenations), ``gather8C_pallas`` K4 (``gather8C_xla``:
``torch.index_select``), ``trilerp_fused_pallas`` K1 without its
derivative output, ``scatter_pallas`` K5 (``scatter_xla_table``:
``index_add_`` of the 8 corner rows). K2, which the JAX script reaches
only through the sampler's gradient, runs in ``trilinear_fwdbwd_*``.

Each op prints one JSON record, ``{"op", "n", "mean_ms", "p50_ms",
"gflops", "mbytes", "sol_ms", "frac_sol", ...}``: ``sol_ms`` is the time at
the card's peaks for the op's analytic cost (``utils/roofline.py``, the
JAX script's costs), ``frac_sol`` that over ``p50_ms``.

Timing. The JAX script repeats each op K = 32 times inside one compiled
program (``lax.scan``), so that the dispatch of a remote chip drops out.
Its counterpart here is one CUDA graph holding K calls of the op, captured
once after a warm-up and replayed ``--iters`` times between CUDA events:
``mean_ms`` and ``p50_ms`` are the mean and median over the replays of a
replay's time over K. A replay runs no Python, so the host's cost per
launch drops out as the dispatch does there. With ``--cpu`` each op runs
K times eagerly between host clocks, a CPU time. A kernel that fails to
build or to launch raises: nothing is recorded and passed over.

Kernel cases (:func:`kernel_rows`, card only): K1-K6 at the main path's
shapes against their plain versions and, in alternating rounds, the
library call that computes the same function (for K6, the decoders' forward
mode that it replaces: ``vmap(jvp)`` of the plain MLP), with each kernel's
bound; ``chip_smoke.py`` prints its kernel table from them. ``--decoders``
runs :func:`decoder_rows` alone: K6 per MLP at 48,000 points (the bench
stream's GN batch) and 6 tangents.

    python -m niceslam_tpu_torch.kernel_bench [--pallas] [--decoders] [--iters 8] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from functools import partial
from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import pretrain_decoders as pd
from .bench import BOUND
from .core import rays, sampling
from .core.compositing import raw_to_outputs
from .eval.mesher import lattice_points
from .grid.hierarchy import GridConfig, adjust_bound, grid_shape, init_grids
from .io.datasets.synthetic import SyntheticBoxReader
from .models.decoders import DecoderConfig, _mlp_forward, init_decoders, nice_forward, tree_map
from .ops import decoder_kernels as dk
from .ops import fixed_point as fp
from .ops import packed_kernels as pk
from .ops import trilerp_kernels as tk
from .ops.trilinear import packed_starts, sample_grid, voxel_coords
from .render.renderer import RenderConfig, render_rays
from .slam.system import NiceSLAM
from .utils import roofline

K = 32  # calls of an op in one graph
N_POINTS = 48_000  # one mapping batch: 1000 rays x 48 samples

# Operations per point and channel, counted from the kernels' arithmetic:
# 7 lerps of 3 flops; the derivative adds 19; the backward adds 8 weight
# products and 8 atomic adds for dgrid plus 6 for the dv contraction.
FWD_OPS, DERIV_OPS, BWD_OPS = 21, 19, 22


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ------------------------------------------------------------------ the ops
class Op(NamedTuple):
    """One op of the bench: ``fn()`` computes it on tensors made ahead."""

    name: str
    n: int
    fn: Callable[[], object]
    cost: Dict[str, float]
    extra: Callable[[float], dict] = lambda p50_ms: {}


def main_ops(params, grids, bounds, scene_bound, pts, rcfg: RenderConfig = RenderConfig(),
             track_rays: int = 200, map_rays: int = 1000) -> List[Op]:
    """The JAX script's main section on these inputs, in its order."""
    gen = torch.Generator().manual_seed(0)
    dev = pts.device
    n = pts.shape[0]
    gb = {lvl: g.numel() * 4 for lvl, g in grids.items()}
    c_dim = grids["fine"].shape[-1]
    S = rcfg.n_samples + rcfg.n_surface
    ops = []
    for lvl in ("middle", "fine", "color"):
        g, b = grids[lvl], bounds[lvl]
        C = g.shape[-1]
        corner_bytes = n * 8 * C * 4  # 8 corner rows of C floats
        leaf = g.detach().clone().requires_grad_(True)

        def fwdbwd(leaf=leaf, b=b):
            return torch.autograd.grad(sample_grid(leaf, pts, b).sum(), leaf)[0]

        ops += [
            Op(f"trilinear_fwd_{lvl}", n, partial(sample_grid, g, pts, b),
               roofline.trilinear_cost(n, C, g.numel() * 4),
               lambda p50, nb=corner_bytes: {"gather_GBps": round(nb / (p50 * 1e6), 2)}),
            Op(f"trilinear_fwdbwd_{lvl}", n, fwdbwd,
               roofline.trilinear_cost(n, C, g.numel() * 4, backward=True),
               lambda p50, nb=corner_bytes: {"scatter_GBps": round(2 * nb / (p50 * 1e6), 2)}),
        ]
    for stage in ("middle", "fine", "color"):
        ops.append(Op(f"nice_forward_{stage}", n,
                      partial(nice_forward, params, grids, pts, bounds, stage),
                      roofline.render_cost(n, 1, c_dim, gb, stage)))

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    raw, rd = randn(map_rays, S, 4), randn(map_rays, 3)
    z = torch.sort(torch.rand((map_rays, S), generator=gen), dim=-1).values.to(dev)
    ops.append(Op("compositing", map_rays * S, partial(raw_to_outputs, raw, z, rd, True),
                  roofline.compositing_cost(map_rays, S)))
    leaves = {lvl: g.detach().clone().requires_grad_(True) for lvl, g in grids.items()}
    for n_rays, tag in ((track_rays, "track"), (map_rays, "map")):
        rd = randn(n_rays, 3)
        rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
        ro = torch.zeros((n_rays, 3), device=dev)
        gtd = torch.full((n_rays,), 1.5, device=dev)

        def fwd(ro=ro, rd=rd, gtd=gtd):
            return render_rays(params, grids, bounds, scene_bound, ro, rd, gtd, "color",
                               rcfg).depth

        def fwdbwd(ro=ro, rd=rd, gtd=gtd):
            depth = render_rays(params, leaves, bounds, scene_bound, ro, rd, gtd, "color",
                                rcfg).depth
            return torch.autograd.grad(depth.sum(), list(leaves.values()), allow_unused=True)

        ops += [
            Op(f"render_fwd_{tag}", n_rays * S, fwd,
               roofline.render_cost(n_rays, S, c_dim, gb)),
            Op(f"render_fwdbwd_{tag}", n_rays * S, fwdbwd,
               roofline.render_cost(n_rays, S, c_dim, gb, backward=True)),
        ]
    return ops


def pallas_ops(grids, bounds, pts) -> List[Op]:
    """The JAX script's Pallas section on these inputs, in its order: per
    level (middle, fine) each kernel beside the op it is set against."""
    gen = torch.Generator().manual_seed(7)
    n = pts.shape[0]
    ops = []
    for lvl in ("middle", "fine"):
        g, b = grids[lvl], bounds[lvl]
        Z, Y, X, C = g.shape
        R = Z * Y * X
        table_cost = {"flops": 0, "bytes": g.numel() * 4 + g.numel() * 8 * 4}
        v = voxel_coords(pts, b, (Z, Y, X)).contiguous()
        start, w = packed_starts(v, (Z, Y, X))
        table = pk.corner_table_plain(g)
        gbytes = n * 8 * C * 4

        def rate(p50, nb=gbytes):
            return {"GBps": round(nb / (p50 * 1e6), 2)}

        gct = torch.randn((n, C), generator=gen).to(g.device)
        ct8 = (pk.corner_weights(w[:, 0], w[:, 1], w[:, 2])[:, :, None]
               * gct[:, None, :]).contiguous()
        idx4 = pk.pair_starts(start, Y, X)
        # index_add_ of the 8 corner rows (k order), as chip_smoke times it.
        rows8 = (idx4[:, :, None] + torch.arange(2, device=g.device, dtype=torch.int32)
                 ).reshape(-1)
        ct_flat = ct8.reshape(-1, C)

        def scatter_lib(R=R, C=C, rows8=rows8, ct_flat=ct_flat):
            return torch.zeros((R, C), device=ct_flat.device).index_add_(0, rows8, ct_flat)

        ops += [
            Op(f"corner_table_xla_{lvl}", g.numel(), partial(pk.corner_table_plain, g),
               table_cost),
            Op(f"corner_table_pallas_{lvl}", g.numel(), partial(pk.corner_table, g),
               table_cost),
            Op(f"gather8C_xla_{lvl}", n, partial(torch.index_select, table, 0, start),
               {"flops": 0, "bytes": gbytes}, rate),
            Op(f"gather8C_pallas_{lvl}", n, partial(pk.gather_rows, table, start),
               {"flops": 0, "bytes": gbytes}, rate),
            Op(f"trilerp_fused_pallas_{lvl}", n, partial(tk.trilerp_fwd, g, v),
               roofline.trilinear_cost(n, C, g.numel() * 4)),
            Op(f"scatter_xla_table_{lvl}", n, scatter_lib, {"flops": 0, "bytes": 2 * gbytes}),
            Op(f"scatter_pallas_{lvl}", n, partial(pk.scatter_corners, idx4, ct8, R),
               {"flops": 0, "bytes": 2 * gbytes}),
        ]
    return ops


# ------------------------------------------------------------------ timing
def graph_times(fn, iters: int, k: int = K):
    """Mean and median ms of one ``fn()`` on the card: ``k`` calls captured
    in one CUDA graph (after three warm-up calls on a side stream, as a
    capture needs), the graph replayed ``iters`` times between CUDA
    events, each replay's time over ``k``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / k)
    return float(np.mean(ts)), float(np.percentile(ts, 50))


def host_times(fn, iters: int, k: int = K):
    """Mean and median ms of one ``fn()`` on the CPU: ``k`` eager calls
    between host clocks, ``iters`` times."""
    fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        ts.append((time.perf_counter() - t0) * 1e3 / k)
    return float(np.mean(ts)), float(np.percentile(ts, 50))


def record(op: Op, mean_ms: float, p50_ms: float, peaks: roofline.ChipPeaks) -> dict:
    """The JAX script's record of one op, with its roofline: ``sol_ms``
    (the least time at ``peaks``) and ``frac_sol`` (its share of p50)."""
    sol = roofline.sol_ms(op.cost["flops"], op.cost["bytes"], peaks)
    return {
        "op": op.name,
        "n": op.n,
        "mean_ms": round(mean_ms, 4),
        "p50_ms": round(p50_ms, 4),
        "gflops": round(op.cost["flops"] / 1e9, 2),
        "mbytes": round(op.cost["bytes"] / 1e6, 2),
        "sol_ms": round(sol, 4),
        "frac_sol": round(sol / max(p50_ms, 1e-9), 4),
        **op.extra(p50_ms),
    }


def run_ops(ops: List[Op], device, peaks: roofline.ChipPeaks, iters: int = 8,
            k: int = K) -> List[dict]:
    """Time each op on ``device`` (where its tensors lie), printing its
    record."""
    times = graph_times if torch.device(device).type == "cuda" else host_times
    recs = []
    for op in ops:
        recs.append(record(op, *times(op.fn, iters, k), peaks))
        print(json.dumps(recs[-1]), flush=True)
    return recs


# --------------------------------------------- kernel cases (card only)
def _batch_ms(f, reps: int) -> float:
    """Device time of one ``f()`` in ms, from one batch of ``reps`` calls
    between CUDA events. A spin kernel keeps the card busy while the host
    enqueues the batch, so the events bracket back-to-back device work and
    not the host's launch overhead."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    a.record()
    for _ in range(reps):
        f()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int = 50, rounds: int = 7) -> float:
    """Median device time of one ``fn()`` in ms over ``rounds`` batches
    (:func:`_batch_ms`)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return statistics.median(_batch_ms(fn, reps) for _ in range(rounds))


def paired_ms(fn, lib, reps: int = 50, rounds: int = 15) -> dict:
    """A kernel ``fn`` and the library call ``lib`` that computes the same
    function, timed alternately on the same inputs: ``rounds`` rounds, each
    one :func:`_batch_ms` batch of either (the one first in even rounds,
    the other in odd ones). Returns the median ms of one call of each and
    their spreads (min and max over the rounds)."""
    for _ in range(3):
        fn()
        lib()
    torch.cuda.synchronize()
    times = {"ms": [], "library_ms": []}
    for r in range(rounds):
        order = (("ms", fn), ("library_ms", lib)) if r % 2 == 0 else (
            ("library_ms", lib), ("ms", fn))
        for key, f in order:
            times[key].append(_batch_ms(f, reps))
    out = {}
    for key, ts in times.items():
        out[key] = statistics.median(ts)
        out[f"{key}_spread"] = (min(ts), max(ts))
    return out


def spread(r: dict, key: str) -> str:
    lo, hi = r[f"{key}_spread"]
    return f"{key} {r[key]:.4f} [{lo:.4f}-{hi:.4f}]"


def bound_ms(nbytes: float, nops: float):
    """The least time for ``nbytes`` moved and ``nops`` fp32 operations on
    this card, from the published peaks of ``utils/roofline.py`` (which
    raises for a card it holds no row of), and which of the two binds."""
    peaks = roofline.device_peaks(torch.cuda.get_device_name())
    t_bytes = nbytes / (peaks.hbm_gbps * 1e9)
    t_ops = nops / peaks.flops_f32
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



def main_path_grid_shapes(cfg):

    b = adjust_bound(np.asarray(cfg.bound, np.float32) * cfg.scale,
                     cfg.grid_len.bound_divisable)
    return {
        lvl: grid_shape(b, getattr(cfg.grid_len, lvl),
                        cfg.model.coarse_bound_enlarge if lvl == "coarse" else 1.0)
        + (cfg.model.c_dim,)
        for lvl in ("coarse", "middle", "fine", "color")
    }


def scene_points(cfg):
    """Voxel coordinates on the fine and middle grids of two point sets of
    the main path: ``"surface"``, the points of one mapping batch (frame 0
    of the synthetic scene seen from its true pose, ``cfg.mapping.pixels``
    rays of stratified and surface samples), and ``"mesher"``, the middle
    65,536-point chunk of the mesher's resolution-128 lattice over the
    scene bound, in the mesher's order."""
    reader = SyntheticBoxReader(cfg, n_frames=36)
    slam = NiceSLAM(cfg, reader=reader)
    frame = reader[0]
    gen = torch.Generator(device="cuda").manual_seed(2)
    batch = mapping_batch_points(slam, frame, torch.as_tensor(frame.gt_c2w, device="cuda"),
                                 cfg, gen)
    chunk = 65536
    lattice = lattice_points(slam.scene_bound, 128).reshape(-1, 3)
    mid = len(lattice) // chunk // 2 * chunk
    lattice = torch.from_numpy(lattice[mid:mid + chunk]).to("cuda")
    return {kind: {lvl: voxel_coords(pts, slam.bounds[lvl],
                                     slam.state.grids[lvl].shape[:3]).contiguous()
                   for lvl in ("fine", "middle")}
            for kind, pts in (("surface", batch), ("mesher", lattice))}


def kernel_cases(cfg):
    """Phase 2's inputs: per level, a seeded random grid and cotangent at
    uniform random points (fine: the mapping batch's count of points;
    middle: the tracking batch's), then the same grid with a new cotangent
    at the surface points of :func:`scene_points`, and the same grid at its
    mesher points (K1 only: the mesher differentiates nothing)."""
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
    for kind, pts in scene_points(cfg).items():
        for lvl, v in pts.items():
            grid = next(c["grid"] for c in cases if c["lvl"] == lvl)
            g = (torch.randn((v.shape[0], grid.shape[-1]), device="cuda", generator=gen)
                 if kind == "surface" else None)
            cases.append(dict(lvl=lvl, points=kind, grid=grid, v=v, g=g))
    for c in cases:
        c["perm"] = torch.randperm(c["v"].shape[0], device="cuda", generator=gen)
        kind = "" if c["points"] == "uniform" else f" {c['points']}"
        c["name"] = f"{c['lvl']}{kind} N={c['v'].shape[0]}"
    return cases


def k1_width_cases(cases):
    """K1's other variants and widths on the fine case's uniform points: C
    = 3 (the scalar kernel), C = 96 (the vector kernel looping over quads,
    as when ``vmap`` folds 3 tangents into the channels) and C = 32 in a
    grid view 4 bytes off alignment (the scalar kernel at the main path's
    width)."""
    fine = cases[0]
    Z, Y, X, _ = fine["grid"].shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = []
    for C, off in ((3, 0), (96, 0), (32, 1)):
        buf = torch.randn(Z * Y * X * C + off, device="cuda", generator=gen) * 0.05
        grid = buf[off:].view(Z, Y, X, C)
        kind = f"C={C}" + (" misaligned" if off else "")
        out.append(dict(lvl="fine", points="width", grid=grid, v=fine["v"],
                        name=f"fine {kind} N={fine['v'].shape[0]}"))
    return out


def corner_rows_touched(grid, v) -> int:
    """Distinct grid rows among the 8 corner rows of the points ``v``."""
    rows, _ = fp.corner_terms(grid.shape[:3], v, v[:, :1])
    return int(torch.unique(rows).numel())


def bucket_stats(grid, v) -> str:
    """How the points crowd: distinct start voxels, the largest bucket (K5's
    pairs per start row are 4x that), and the most corner terms one grid
    row of K2 sums."""
    rows, _ = fp.corner_terms(grid.shape[:3], v, v[:, :1])
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


def grid_sample_inputs(grid, v):
    """The library yardstick's inputs: the channel-first volume and the
    normalized xyz coordinates of ``v`` (its border clamp gives equal
    values)."""
    Z, Y, X, _ = grid.shape
    hi = torch.tensor([Z - 1, Y - 1, X - 1], device="cuda", dtype=torch.float32)
    vol = grid.permute(3, 0, 1, 2)[None].contiguous()
    nrm = (v.flip(-1) / hi.flip(-1) * 2 - 1).reshape(1, v.shape[0], 1, 1, 3).contiguous()
    return vol, nrm


def k1_rows(case):
    """K1 on one case, without and with its derivative output: parity with
    the plain version (1e-5), the variant that ``fwd_variant`` picks (where
    it picks the scalar one at C % 4 == 0, the entry point must refuse the
    vector one), times, and the bound counting the grid rows that the
    points touch; beside them the corner-row bytes that a call reads
    (8 * N * C * 4) and their rate."""
    grid, v, name = case["grid"], case["v"], case["name"]
    C, n = grid.shape[-1], v.shape[0]
    vol, nrm = grid_sample_inputs(grid, v)

    def lib_fwd():
        return F.grid_sample(vol, nrm, mode="bilinear", padding_mode="border",
                             align_corners=True)

    touched = corner_rows_touched(grid, v)
    rows = []
    for deriv in (False, True):
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
        dptr = dout.data_ptr() if deriv else None
        variant, G = tk.fwd_variant(C, grid.data_ptr(), out.data_ptr(), dptr)
        if variant == "scalar" and C % 4 == 0:
            rc = tk._lib().trilerp_fwd(
                grid.data_ptr(), v.data_ptr(), out.data_ptr(), dptr, n, *grid.shape,
                True, 8, torch.cuda.current_stream().cuda_stream)
            if rc != 1:  # cudaErrorInvalidValue
                raise AssertionError(f"trilerp_fwd[{name}]: the vector variant on "
                                     f"misaligned pointers returned {rc}, not refused")
        kern = lambda: tk.trilerp_fwd(grid, v, deriv=deriv)  # noqa: E731
        times = (dict(ms=device_ms(kern), library_ms=None) if deriv
                 else paired_ms(kern, lib_fwd))
        plain = device_ms(lambda: tk.trilerp_fwd_plain(grid, v, deriv=deriv), reps=10)
        nbytes = 4 * (touched * C + 3 * n + n * C + (3 * n * C if deriv else 0))
        nops = n * C * (FWD_OPS + (DERIV_OPS if deriv else 0))
        bms, by = bound_ms(nbytes, nops)
        corner_bytes = 8 * n * C * 4
        rows.append(dict(name="trilerp_fwd", case=f"{name} deriv={int(deriv)}",
                         points=case["points"], max_abs_err=err, plain_ms=plain, **times,
                         bound_ms=bms, bound_by=by,
                         extra=f"{variant} G={G}, {touched} rows touched, corner rows "
                               f"{corner_bytes / 1e6:.1f} MB at "
                               f"{corner_bytes / (times['ms'] * 1e-3) / 1e12:.2f} TB/s"))
    return rows


def kernel_rows(cfg):
    """Parity, time and bound of K1-K5 at the main path's shapes, and of K6
    at the GN linearization's (the tracking batch's points, 6 tangents)."""
    log(f"main-path grid shapes [Z,Y,X,C]: {main_path_grid_shapes(cfg)}")
    rows = []
    cases = kernel_cases(cfg)
    for case in cases + k1_width_cases(cases):
        grid, v, name = case["grid"], case["v"], case["name"]
        log(f"kernel inputs [{name}]: {bucket_stats(grid, v)}")
        rows += k1_rows(case)
        if case["points"] in ("mesher", "width"):
            continue
        g, perm = case["g"], case["perm"]
        uniform = case["points"] == "uniform"
        Z, Y, X, C = grid.shape
        R, n = Z * Y * X, v.shape[0]
        # The library yardstick: grid_sample on the channel-first volume at
        # normalized xyz coordinates (its border clamp gives equal values).
        vol, nrm = grid_sample_inputs(grid, v)
        lib_gout = g.t().reshape(1, C, n, 1, 1).contiguous()

        def lib_bwd():
            return torch.ops.aten.grid_sampler_3d_backward(
                lib_gout, vol, nrm, 0, 1, True, [True, True])

        def row(kname, **kw):
            rows.append(dict(name=kname, case=name, points=case["points"], **kw))

        torch.cuda.synchronize()
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
        times = paired_ms(lambda: tk.trilerp_bwd(grid, v, g), lib_bwd)
        plain = device_ms(lambda: tk.trilerp_bwd_plain(grid, v, g), reps=10)
        nbytes = 4 * (R * C + 3 * n + n * C + R * C + 3 * n)
        nops = n * C * (FWD_OPS + DERIV_OPS + BWD_OPS)
        bms, by = bound_ms(nbytes, nops)
        row("trilerp_bwd", max_abs_err=err, plain_ms=plain, **times, bound_ms=bms, bound_by=by)
        rows += packed_kernel_rows(case, with_table=uniform)
    rows += k2_dgrid_only_rows()
    n_track = cfg.tracking.pixels * (cfg.rendering.N_samples + cfg.rendering.N_surface)
    rows += decoder_rows(n_track)
    log("library_ms of corner_table: null, no single PyTorch call builds the "
        "packed table (the plain version is six concatenations)")
    for r in rows:
        log_kernel_row(r)
    for r in rows:
        if r["name"] == "gather_rows":
            log_verdict(r)
    return rows


def log_kernel_row(r: dict):
    """A kernel row; where it has a library call, both times are the
    medians of alternating rounds with their spreads."""
    if r["library_ms"] is None:
        times = f"ms {r['ms']:.4f}  library_ms n/a"
    else:
        times = f"{spread(r, 'ms')}  {spread(r, 'library_ms')} (alternating)"
    log(f"kernel {r['name']:<15} {r['case']:<34} max_abs_err {r['max_abs_err']:.3e}  "
        f"{times}  plain_ms {r['plain_ms']:.4f}  bound_ms {r['bound_ms']:.4f} "
        f"({r['bound_by']})" + (f"  [{r['extra']}]" if "extra" in r else ""))


def log_verdict(r: dict):
    """Whether a kernel loses to its library call: by more than the two
    spreads (the width of each one's rounds) together."""
    (lo, hi), (llo, lhi) = r["ms_spread"], r["library_ms_spread"]
    margin = (hi - lo) + (lhi - llo)
    gap = r["ms"] - r["library_ms"]
    verdict = "loses" if gap > margin else "does not lose"
    log(f"verdict {r['name']} [{r['case']}]: kernel - library {gap:+.4f} ms against the "
        f"spreads {margin:.4f} ms: {verdict}; at {r['bound_ms'] / r['ms']:.2f} of its bound")


def pretrain_scene_on_card(bi: int, seed: int = 0):
    """A pretraining scene on envelope ``bi``, on the card: the grids and
    bounds of scene ``bi`` of a run with ``seed`` and a geometry drawn from
    a fresh ``default_rng(seed)``."""
    grids, bounds, adj = init_grids(np.asarray(pd.BOUND_SET[bi], np.float32), GridConfig(),
                                    gen=torch.Generator().manual_seed(seed + 100 + bi),
                                    device="cuda")
    geom = {k: torch.from_numpy(v).to("cuda")
            for k, v in pd.scene_geometry(np.random.default_rng(seed), adj).items()}
    return grids, bounds, geom


def k2_dgrid_only_rows():
    """K2 asked for the grid gradient alone, as the pretraining's backward
    launches it (the points are constants), at the pretraining's largest
    fine grid (the third envelope) on one batch's occupancy points: against
    its plain version and bit for bit against the fixed-point model, also
    with the points permuted; an all-zero cotangent (what the color stage
    sends to the fine and middle samples) must give exactly zero."""
    grids, bounds, geom = pretrain_scene_on_card(2)
    gen = torch.Generator(device="cuda").manual_seed(5)
    pts = pd.occupancy_points(pd.draw_batch(gen, geom, bounds, 4096))
    grid = torch.randn(grids["fine"].shape, device="cuda", generator=gen) * 0.05
    del grids
    Z, Y, X, C = grid.shape
    R = Z * Y * X
    v = voxel_coords(pts, bounds["fine"], (Z, Y, X)).contiguous()
    n = v.shape[0]
    g = torch.randn((n, C), device="cuda", generator=gen)
    perm = torch.randperm(n, device="cuda", generator=gen)
    name = f"fine {Z}x{Y}x{X} pretraining N={n} dgrid only"
    log(f"kernel inputs [{name}]: {bucket_stats(grid, v)}")
    dgrid, dv = tk.trilerp_bwd(grid, v, g, need_dv=False)
    rdgrid, _ = tk.trilerp_bwd_plain(grid, v, g, need_dv=False)
    pdgrid, _ = tk.trilerp_bwd(grid, v[perm].contiguous(), g[perm].contiguous(), need_dv=False)
    zero, _ = tk.trilerp_bwd(grid, v, torch.zeros_like(g), need_dv=False)
    model = fp.trilerp_bwd_fixed_point(grid, v, g)
    torch.cuda.synchronize()
    if dv is not None:
        raise AssertionError(f"trilerp_bwd[{name}]: a dv was returned")
    check_close(f"trilerp_bwd[{name}] dgrid", dgrid, rdgrid, 1e-5,
                1e-5 * max(1.0, float(rdgrid.abs().max())))
    check_model(f"trilerp_bwd[{name}] dgrid", dgrid, model)
    check_order_independent(f"trilerp_bwd[{name}] dgrid", pdgrid, dgrid)
    if int(torch.count_nonzero(zero)) != 0:
        raise AssertionError(f"trilerp_bwd[{name}]: a zero cotangent gave "
                             f"{int(torch.count_nonzero(zero))} non-zero entries")
    log(f"kernel trilerp_bwd[{name}]: an all-zero cotangent gives exactly zero")
    vol, nrm = grid_sample_inputs(grid, v)
    lib_gout = g.t().reshape(1, C, n, 1, 1).contiguous()
    bms, by = bound_ms(4 * (3 * n + n * C + R * C), n * C * (BWD_OPS - 6))
    return [dict(
        name="trilerp_bwd", case=name, points="pretraining",
        max_abs_err=max_err(dgrid, rdgrid),
        **paired_ms(lambda: tk.trilerp_bwd(grid, v, g, need_dv=False),
                    lambda: torch.ops.aten.grid_sampler_3d_backward(
                        lib_gout, vol, nrm, 0, 1, True, [True, False])),
        plain_ms=device_ms(lambda: tk.trilerp_bwd_plain(grid, v, g, need_dv=False), reps=10),
        bound_ms=bms, bound_by=by)]


def packed_kernel_rows(case, with_table=True):
    """Parity, time and bound of K5 (and, ``with_table``, of K3 and K4) on
    the inputs of K1 and K2: the table of the grid, the rows at the starts
    of the points, and the corner cotangents ``w8 (x) g`` scattered back
    (and again with the points in the case's order ``perm``)."""
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
        # Bytes: the distinct table rows the starts touch, read once; the
        # indices; the n rows written.
        touched = int(torch.unique(start).numel())
        bms, by = bound_ms(4 * (touched * 8 * C + n + n * 8 * C), 0)
        row("gather_rows", max_abs_err=max_err(rows, ref),
            **paired_ms(lambda: pk.gather_rows(table, start),
                        lambda: torch.index_select(table, 0, start)),
            plain_ms=device_ms(lambda: pk.gather_rows_plain(table, start), reps=10),
            bound_ms=bms, bound_by=by, extra=f"{touched} of {R} rows touched")
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
        **paired_ms(lambda: pk.scatter_corners(idx4, ct8, R), lib_scatter),
        plain_ms=device_ms(lambda: pk.scatter_corners_plain(idx4, ct8, R), reps=10),
        bound_ms=bms, bound_by=by)
    return out


def mapping_batch_points(slam, frame, c2w, cfg, gen):
    """World points ``[P * (N_samples + N_surface), 3]`` of one mapping
    batch: ``cfg.mapping.pixels`` pixels of ``frame`` drawn from ``gen``,
    cast from pose ``c2w``, with stratified and surface samples."""
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


# ------------------------------------------------------------------ main
def decoder_macs(c_in: int, out_dim: int, T: int) -> int:
    """Multiply-adds per point of one MLP's value and ``T`` tangents, as K6
    computes them: the value through every layer (the feature term at
    ``c_in`` channels); a tangent through every layer without the detached
    half of the feature (``c_in - 32``) and with the embedding's ``p' @ B``
    and ``cos * (p' @ B)``."""
    E, H = dk.EMBED, dk.KERNEL_WIDTH
    dense = E * H + 3 * H * H + (E + H) * H + H * out_dim
    value = 3 * E + dense + 5 * c_in * H
    tangent = 4 * E + dense + 5 * H * H
    return value + T * tangent


def graphed(fn) -> torch.cuda.CUDAGraph:
    """``fn`` captured once (after a warm-up call) as a CUDA graph."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def decoder_rows(n: int = N_POINTS, T: int = 6, seed: int = 0):
    """K6 per MLP (middle, fine, color) at ``n`` points and ``T`` tangents,
    as kernel rows: the value of the T-tangent launch must equal the T = 0
    launch's bit for bit, the value be within ``dk.CARD_RTOL`` of the plain
    version on the card and the tangents too but for ``dk.KINKS`` of them
    (else it raises); in 15 alternating rounds the kernel against
    ``vmap(jvp)`` of the plain MLP, the decoders' Jacobian before K6 and no
    single call (``library_ms``), each a CUDA graph of one call; the plain
    version's time, the T = 0 launch's (``value_ms``) and the fp32 bound
    beside them. Card only."""
    gen = torch.Generator().manual_seed(seed)
    params = init_decoders(DecoderConfig(), gen=gen, device="cpu")
    lo, hi = np.asarray(BOUND, np.float32)[:, 0], np.asarray(BOUND, np.float32)[:, 1]
    pts = torch.from_numpy(lo) + torch.from_numpy(hi - lo) * torch.rand((n, 3), generator=gen)
    rows = []
    for level in ("middle", "fine", "color"):
        name = f"{level} N={n} T={T}"
        p = params[level]
        # Biases as a trained decoder has them (init leaves them 0).
        for part in p["linears"] + p["fc_c"] + [p["out"]]:
            part["b"] = 0.1 * torch.randn(part["b"].shape, generator=gen)
        p = tree_map(lambda t: t.cuda(), p)
        det_w = 32 if level == "fine" else 0
        feat = 0.3 * torch.randn((n, 32), generator=gen)
        det = 0.3 * torch.randn((n, det_w), generator=gen) if det_w else None
        pdot = 0.1 * torch.randn((T, n, 3), generator=gen)
        fdot = torch.randn((T, n, 32), generator=gen)
        card = [x.cuda() if x is not None else None for x in (pts, pdot, feat, fdot, det)]
        w = dk.pack_weights(p)
        O = p["out"]["w"].shape[1]
        x, xd, f, fd, dt = card
        val, tan = dk.decoder_jvp(w, x, xd, f, fd, dt, 32, O)
        val0, _ = dk.decoder_jvp(w, x, xd[:0], f, fd[:0], dt, 32, O)
        pval, ptan = dk.decoder_jvp_plain(w, x, xd, f, fd, dt, 32, O)
        torch.cuda.synchronize()
        if not torch.equal(val, val0):
            raise AssertionError(f"decoder_jvp[{name}]: the value of the T={T} launch "
                                 f"differs from the T=0 launch's ({max_err(val, val0):.3e})")
        check_close(f"decoder_jvp[{name}] value", val, pval, dk.CARD_RTOL,
                    dk.CARD_RTOL * float(pval.abs().max()))
        kinks = dk.tangents_off(tan, ptan)
        if kinks > dk.KINKS:
            raise AssertionError(f"decoder_jvp[{name}]: {kinks:.3e} of the tangents off "
                                 f"their plain version by more than {dk.CARD_RTOL}")

        def plain_mlp(a, b):
            return _mlp_forward(p, a, b if dt is None else torch.cat([b, dt], -1))

        def jacfwd_mlp():
            return torch.func.vmap(
                lambda u, v: torch.func.jvp(plain_mlp, (x, f), (u, v)))(xd, fd)

        # Each side one CUDA graph of one call, as the GN program runs it.
        kernel = graphed(lambda: dk.decoder_jvp(w, x, xd, f, fd, dt, 32, O))
        yardstick = graphed(jacfwd_mlp)
        times = paired_ms(kernel.replay, yardstick.replay)
        plain = device_ms(graphed(
            lambda: dk.decoder_jvp_plain(w, x, xd, f, fd, dt, 32, O)).replay)
        value_ms = device_ms(graphed(
            lambda: dk.decoder_jvp(w, x, xd[:0], f, fd[:0], dt, 32, O)).replay)
        flops = 2.0 * n * decoder_macs(32 + det_w, O, T)
        nbytes = 4.0 * n * ((1 + T) * (3 + 32 + O) + det_w) + 4.0 * w.numel()
        bms, by = bound_ms(nbytes, flops)
        rows.append(dict(
            name="decoder_jvp", case=name, points="uniform", level=level, n=n, T=T,
            max_abs_err=max(max_err(val, pval), max_err(tan, ptan)), **times,
            plain_ms=plain, bound_ms=bms, bound_by=by, value_ms=value_ms,
            gflop=flops / 1e9, tflops=flops / (times["ms"] * 1e9),
            tangent_scale=float(ptan.abs().max()), tangent_share_off=kinks,
            extra=f"library: vmap(jvp) of the plain MLP; T=0 launch {value_ms:.4f} ms; "
                  f"{flops / (times['ms'] * 1e9):.1f} TFLOP/s; tangents off "
                  f"{kinks:.2e} (at most {dk.KINKS})"))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pallas", action="store_true",
                    help="also the Pallas section: K1, K3-K5 beside their XLA twins")
    ap.add_argument("--decoders", action="store_true",
                    help="only K6 (decoder_rows): one JSON line per MLP, card only")
    ap.add_argument("--iters", type=int, default=8, help="graph replays timed per op")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to run the ops on the CPU")
    if args.decoders:
        if device.type != "cuda":
            raise RuntimeError("--decoders times K6 on the card; it has no CPU mode")
        log(f"# device: {torch.cuda.get_device_name(device)}")
        for row in decoder_rows():
            print(json.dumps(row), flush=True)
        return 0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    peaks = roofline.device_peaks(name)
    log(f"# device: {name}")
    log(f"# roofline peaks: {peaks.name} {peaks.flops_f32 / 1e12:.0f} f32-TFLOP/s, "
        f"{peaks.hbm_gbps:.0f} GB/s")
    gen = torch.Generator().manual_seed(0)
    bound = np.asarray(BOUND, np.float32)
    grids, bounds, adj = init_grids(bound, GridConfig(), gen=gen, device=device)
    params = init_decoders(DecoderConfig(), gen=gen, device=device)
    for lvl, g in grids.items():
        log(f"# grid {lvl}: {tuple(g.shape)} = {g.numel() * 4 / 1e6:.2f} MB")
    lo, hi = torch.from_numpy(bound[:, 0]), torch.from_numpy(bound[:, 1])
    pts = (lo + (hi - lo) * torch.rand((N_POINTS, 3), generator=gen)).to(device)
    run_ops(main_ops(params, grids, bounds, torch.as_tensor(adj, device=device), pts),
            device, peaks, args.iters)
    if args.pallas:
        run_ops(pallas_ops(grids, bounds, pts), device, peaks, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
