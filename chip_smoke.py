#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``niceslam_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--frames 8] [--iters-first 1500] [--profile] [--seeds 1]
                          [--multi-only | --pretrain-recipe | --reference-run]

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions; the
   kernels are built with ``nvcc`` from ``niceslam_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) into ``build/kernels`` and the
   build times and ``ptxas`` reports are printed.
2. kernels (the cases of ``niceslam_tpu_torch.kernel_bench.kernel_rows``):
   every kernel of both sampler routes (K1, K2 fused; K3, K4, K5
   packed) at the main path's shapes against its plain PyTorch version on
   the same card tensors, with the max error, the median device time (CUDA
   events), the plain version's time, the time of one PyTorch library call
   computing the same function where there is one (the kernel and the call
   timed in 15 alternating rounds: both medians and both spreads, and for
   K4 the verdict whether it loses to ``index_select`` by more than the
   two spreads), and the bound computed
   from bytes and operations; on uniform random points, and K1, K2 and K5
   again on the points of one mapping batch (frame 0 of the synthetic
   scene at its true pose: stratified and surface samples, which crowd
   into the voxels at the surface). K1, with and without its derivative
   output, also on one mesher chunk (65,536 lattice points in the mesher's
   order) and, for parity, at C = 3, C = 96 and in a misaligned grid (its
   scalar and looping variants); its bound counts the grid rows that the
   points touch, and K4's the table rows that its starts touch. The grid
   gradients of K2 and K5 must equal their fixed-point model
   (``ops/fixed_point.py``) bit for bit, also with the points in another
   order. K2 asked for the grid gradient alone,
   as the pretraining launches it (phase 12), at its largest fine grid
   (62x36x74x32) on one batch's 8,190 occupancy points: against its plain
   version, its model (also permuted) and, with an all-zero cotangent,
   exactly zero.
3. card vs CPU, under each route: the port on the card (kernels) against
   the port on the CPU (plain versions) on a small world with injected
   pixels: a Gauss-Newton tracking solve and the mapping loss with its
   gradients.
4. main path, under each route: ``NiceSLAM.step`` of the bench
   configuration (``bench.py``, strict sync) on the synthetic scene, its
   pose solves, mapping iterations, keyframe overlaps and frustum masks
   replayed as CUDA graphs (``slam/programs.py``), all captured by
   ``NiceSLAM.precompile()`` before frame 0, as the command line does (no
   keyframe program may be captured later; each graph's capture seconds,
   node count and launches per replay are printed, and the pool's
   memory), first
   on the fused route, then on the packed route, with the launch counts of
   every kernel (the route's kernels launched, the other route's not),
   per-frame seconds, peak device memory, per-frame position errors and the
   ATE; a lost track (``lost_track``) fails. Frames 0 and 1 of the fused
   run are run again from a new ``NiceSLAM`` and must give the same grids
   and poses bit for bit: one seed is one trajectory on the card. On the
   packed run's frame-0 map both routes' ``sample_grid`` values and grid
   gradients are compared on all four levels at a mapping batch's points.
5. mesher and a panel: ``extract_mesh`` at resolution 128 (2,097,152
   query points) on the fused run's final map (after its traced frames)
   under each route, timed once, and one query
   of the occupancy field per route, the two fields compared; under each
   route the query, ``extract_mesh`` and the vertex colours' query graphed
   against eager, bit for bit and with the same launches, the seconds of
   each; then ``postprocess_mesh`` and ``write_ply`` to a temporary
   directory; then one panel's ``render_image`` (the last frame, 640x480)
   graphed against eager, bit for bit. The process's graph pool is read
   after the fused main path, the meshes and the panel: one system's
   graphs with a mesh and a panel, as a command line with ``--mesh`` and
   ``--vis-dir`` holds them.
6. Adam (after the fused run of phase 4): one frame's Adam solve with
   ``configs/cofusion.yaml``'s tracking on that run's frame-0 map, on the
   card and on the CPU with the same injected pixels (poses within 1e-4);
   K2 launched without the grid gradient only; that launch's ``dv`` on the
   solve's first tracking batch against its plain version, timed.
7. async (after phase 6): the fused main path again in
   ``sync_method="async"`` with the frames through the prefetcher, after
   ``precompile()`` as the command line does; its
   trajectory and grids must equal phase 4's bit for bit. Frames 1+ run
   under ``torch.cuda.set_sync_debug_mode("warn")``: the calls that wait
   for the stream are counted by call site and must be none (the mode's
   one-time prototype notice is not a wait), beside the seconds per frame
   of both runs and the peak device memory.
8. async fault (after phase 5): a short async run (``iters_first`` cut to
   at most 100) whose first BA mapping event ``fault_hook`` turns to NaN:
   one ``map_rejected``, a finite map, and right after the rollback the
   grids, decoders, keyframe DB and the event frame's pose equal to those
   before the event bit for bit.
9. command line: ``niceslam_tpu_torch.__main__.main`` on
   ``configs/cofusion.yaml`` (synthetic scene, async, Adam tracking, 8
   frames, a checkpoint at frame 4, trajectory, mesh at resolution 64);
   a restore of the checkpoint equal to the state saved bit for bit; then
   ``--resume`` from it to frame 8 with ``--no-precompile`` (its graphs
   captured when first met, the prefetcher running).
10. real data: the synthetic scene written in the Co-Fusion layout at
   640x480 (PNG colour through ``io/png.py``, ZIP EXR depth, the
   ground-truth trajectory), read back (colour exact, depth bit for bit,
   poses within 1e-5) with the PNG and EXR decode times; upstream-format
   ``coarse.pt`` / ``middle_fine.pt`` written from the shipped ``.npz``,
   whose import must equal it bit for bit; then ``python -m
   niceslam_tpu_torch configs/cofusion.yaml`` in a subprocess on that
   layout with the ``.pt`` decoders (async, Adam tracking, BA, 6 frames,
   render panels every 2 frames, a checkpoint of the last frame): no lost
   track, the panels ``480 x 3200 x 3``, K1 and K2 launched and K3-K5 not;
   a second, 2-frame run with ``--profile-dir`` whose trace must hold the
   ``track`` and ``map`` ranges and K1/K2, with the card's busy share per
   frame; ``render_image`` of the final map on the card, graphed against
   eager (bit for bit, seconds and K1 launches per image both ways) and,
   on a 32-row band, held against the CPU.

11. multi-device, on the one card: ranks spawned as processes that
   share ``cuda:0`` and meet over gloo (NCCL refuses two ranks on one
   card). (a) On 2 and 4 ranks (``map`` = ranks): the halo sampler
   (``grid/shard.py``) on each rank's Z block of a grid of the fine and
   middle shapes (Z padded to the map axis), N = 48,000, on both routes:
   values bit for bit and gradients within 2e-5 of the unsharded sampler
   on the card, the route's kernels launched by every rank on its block;
   then a full-width mapping pass of frame 0's map (1000 px, a window of
   frames 0-1, BA on frame 1, the system's pass configuration) sharded at
   ``(map, kf)`` = (2, 1), (1, 2), (2, 2) against the same pass unsharded
   on the card, for the staged plans of 4 (middle, middle, fine, color)
   and 12 iterations: losses within 2e-4, the first row's summed gradients
   within 2e-5 of each leaf's largest, and with kf = 1 the grids, decoders
   and cameras within 2e-5 at the end (with kf = 2 printed: Adam amplifies
   the rounding of the slices' sum), every rank the same map. Each rank
   prints its seconds, peak memory, launches and its time in all_reduce.
   At (1, 2) the same pass also runs as the system's kf-sharded program
   (two CUDA graphs per stage around the eager all_reduce), which must
   equal the eager pass bit for bit, launches included; at (2, 1) and
   (2, 2) as the system's map-sharded program (``MapSegments``: 4 or 5
   graphs per stage around 3 or 4 eager all_reduces), graphed against its
   own bodies with ``capture=False``, bit for bit, launches included, and
   held against the unsharded pass as the eager pass is; ms per
   iteration, all_reduce ms and calls per iteration (the segment plan's:
   1, 3, 4), the captures, the graph pool and peak memory of each rank. On
   the 2 ranks, ``NiceSLAM`` attached to a (1, 2) and then a (2, 1) mesh
   at the bench configuration, ``precompile`` and the main path's frames
   graphed (the digest printed), then the cut (``CUT``) graphed and with
   ``capture=False``: the cut's digests equal, every run's ranks agree, no
   collective in ``precompile``, seconds per frame, the ATE under
   ``ATE_LOST_CM``, each rank's graph pool and peak memory. With
   ``rendering.N_importance = N_IMPORTANCE`` (phase 15): the 12-iteration
   pass at (2, 1) and (2, 2) on both routes, as the eager pass (held
   against the unsharded pass on the same route in its first row: loss
   and summed gradients; the later rows printed) and as the map program
   (its first loss held alike; one more segment and
   all_reduce: 4 or 5 a row), graphed against ``capture=False`` bit for
   bit, launches included; and a (2, 1) system on phase 15's cut, graphed
   and eager, one digest on both ranks.
   (b) ``NiceSLAM`` with ``parallel.track_role`` and ``parallel.stage_ep``
   on the devices ``[cuda:0, cuda:0]``, the fused strict main path: its
   digest must equal phase 4's. (c) ``python -m niceslam_tpu_torch
   configs/cofusion.yaml`` on 4 ranks (``map = 2, kf = 2``, synthetic
   scene, async, Adam, ``iters_first`` cut to 100, no color refinement, 5
   frames, checkpoints every 2 frames), then a resume from frame 2; then
   ``configs/apartment_multihost.yaml`` on 2 ranks on its own mesh (``map
   = 1``, ``kf = 0``: every rank on kf), 4096 rays, synthetic scene,
   ``iters_first`` cut to 300, 5 frames; then ``cofusion.yaml`` on 2
   ranks (``map = 2``, ``kf = 1``) at ``rendering.N_importance =
   N_IMPORTANCE``, 3 frames, whose passes must replay the importance
   segment: every rank exits 0 (the command fails when the ranks'
   trajectories differ), no lost track, ``fps_avg`` and each rank's
   launches, peak memory and graph pool printed. Every command line runs
   its passes graphed.

12. pretraining: one step of ``pretrain_decoders`` at the bench envelope
   and full width (batch 4096, ``GridConfig()``, ``DecoderConfig()``), card
   against CPU on one injected batch (loss within 1e-5 relative, every
   gradient within 2e-5 of its leaf's largest entry), then the packed route
   against the fused one on the card (K3-K5 launched); then the cut recipe
   below through ``pretrain`` graphed and eagerly (``capture=False``):
   decoders and every loss bit for bit, K1 11 and K2 7 a step both ways,
   seconds per step both ways, each envelope's capture seconds and node
   count, the pool's MiB; then ``pretrain_decoders.main`` (graphed) on the
   card cut to 3 scenes (one per
   envelope) of 50 steps: each scene's first and last loss, its terms,
   seconds per step beside a bound from ``utils/roofline.py`` and its peak
   device memory; K1 and K2 launched as the step's calls predict (K1 11 a
   step, K2 7, grid gradient only), K3-K5 not; no call inside a scene waits
   for the stream (``set_sync_debug_mode("warn")``); every scene's loss
   finite and falling; the written ``.npz`` loads and gives a finite field.

13. graphs against eager: the main path cut to ``CUT`` (2 frames,
   ``iters_first`` 100) graphed and with ``capture=False`` (every
   iteration and keyframe program launched from Python), fused, then
   packed, then async as phase 7 runs it: each eager run must give the
   digest and the launches of its graphed run. Seconds per frame and peak
   memory both ways; on the fused route one more frame (a mapping event)
   of the eager cut run under ``torch.profiler``, for the card's busy share
   eager, beside the graphed one of two more frames after phase 4's
   (tracking only, then a mapping event).

14. measurement entry points, each through its ``main`` as a user calls
   it, cut: ``niceslam_tpu_torch.bench`` at 12 frames x 2 seeds, async,
   no other ``BENCH_*`` variable set (its one stdout line with exactly the JAX bench's keys, a finite
   positive frames/s and speed of light, ``hbm_util`` and ``mfu`` in (0,
   1.05], each seed's logged ATE equal to its entry in ``ate_seeds_cm``
   and under ``ATE_LOST_CM``, the memory allocated at a seed's start, the
   graph pool and the peak memory not growing seed by seed);
   ``niceslam_tpu_torch.accuracy_sweep`` with one variant (the bench's
   operating point, 8 frames) and its depth and colour render check (the
   JAX sweep's record keys, no lost track by the ATE or the raw error);
   ``niceslam_tpu_torch.kernel_bench --pallas`` at 2 replays an op (a
   record with the JAX script's keys for each of its 28 ops, finite
   positive times and bounds).

15. the importance pass: phase 4's fused main path at
   ``rendering.N_importance = N_IMPORTANCE`` (graphed, strict): no lost
   track; no call inside a pose solve's or a mapping pass's program waits
   for the stream (``set_sync_debug_mode``, captures excepted: the
   importance pass's ``cumsum``, ``searchsorted``, ``sort`` and ``gather``
   run in the graphs); K1 launched exactly twice as often as in phase 4
   (each render evaluates two point sets) and K2 as often (it
   differentiates the second); seconds per frame beside phase 4's, graph
   pool and peak memory; one 640x480 panel graphed against eager, bit for
   bit; then the cut of phase 13 (``CUT``) graphed and with
   ``capture=False``: one digest, the same launches.
16. the cut reference envelope: ``ENVELOPE_FRAMES`` frames of the
   Co-Fusion layout at 640x480 (``niceslam_tpu_torch.make_fixture_dataset``,
   the long run's motion per frame) through the command line with the
   reference run's overrides (``LONGRUN_SETS``: async, the bench's budgets,
   ``lock_after``) cut by ``ENVELOPE_SETS``: a keyframe ring of 4 slots that
   reuses a slot, voxels locked after 2 events (each event must leave the
   grid values of the voxels locked when it starts equal bit for bit), a
   checkpoint at frame 6 and a resume from it to the end (its first 7
   poses equal to the run's), the colour refine's 5 passes on the last
   frame, no lost track in either run.

Phases 4, 7, 8, 9, 10, 11 (b), 12, 15 and 16 run graphed, as ``NiceSLAM``,
``render_image``, the mesher and ``pretrain_decoders`` do on a card; so
do phase 11's command lines, its systems and its programs, every pass
there a few graphs around eager all_reduces; the halo sampler and the
sharded passes of phase 11 (a) run eagerly, as the references of those
programs. Every graph of the card, whichever object holds
it, lies in the card's one pool (``slam/programs.py``): the process's pool
is read where each phase ends (after the main path, the meshes of phase 5
and the panel of phase 10 among them) and summed up in one line.

``--profile`` adds a phase after the fused main path: two more every_frame
groups, the first timed, the second under ``torch.profiler``, for the
card's busy share and the kernels that take its time (slow: the profiler's
host side takes minutes to digest the ~10^5 kernels of a group).
``--seeds N`` runs the fused main path again for seeds 1 to N-1 and prints
the ATE of every seed. ``--multi-only`` runs phases 1, 4 (fused) and 11.
``--pretrain-recipe`` runs phase 1, then ``pretrain_decoders.main`` at its
defaults, graphed (the full recipe: 24 scenes of 400 steps at batch 4096, written to
``output/pretrained_decoders_torch.npz``), then phase 4 (fused) with the
decoders just written and with the shipped ones, and prints one JSON line:
the recipe's wall seconds, steps per second and the ATE of both runs (a
lost track is reported there, not raised). ``--reference-run`` runs phase
1, then the reference-scale run of ``LONGRUN_r05.json`` (the 849-frame
Co-Fusion layout written by ``make_fixture_dataset``, the command line on
``configs/cofusion_synth849.yaml`` with ``LONGRUN_SETS``, then a resume
from its frame-500 checkpoint to frame 530): the fixture's write seconds,
``fps_avg``, the ATE over the first orbit and the whole run, the mapping
events and rollbacks, the frame at which the ring first reused a slot, the
voxels locked at the end, the graph pool and peak memory at frames 100,
400, 800 and the last, and the resume's ATE; it fails on a non-zero exit, a
non-finite pose or a lost track on the first orbit (after printing every
figure), and ends with the ``nvidia-smi`` line and the usual last line
(~5 min).

It then prints the kernels' JSON line, the card's ``nvidia-smi`` line and,
last, ``{"ok": true, "device": {...}}``. It needs one CUDA device and the
rest of the repository beside it; without either it fails.
"""
import argparse
import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from niceslam_tpu_torch import accuracy_sweep, bench, kernel_bench
from niceslam_tpu_torch.bench import bench_config
from niceslam_tpu_torch.kernel_bench import (
    DERIV_OPS,
    FWD_OPS,
    bound_ms,
    check_close,
    corner_rows_touched,
    device_ms,
    grid_sample_inputs,
    kernel_rows,
    log_kernel_row,
    main_path_grid_shapes,
    mapping_batch_points,
    max_err,
    paired_ms,
    pretrain_scene_on_card,
)

ROOT = os.path.dirname(os.path.abspath(__file__))

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



POOL_READINGS = {}


def log_pool(where: str):
    """The process's graph pool where a phase ends (every card's pool,
    shared by every graph on it: ``slam/programs.pool_bytes``), in MiB,
    kept for the summary line."""
    from niceslam_tpu_torch.slam.programs import pool_bytes

    gc.collect()
    POOL_READINGS[where] = round(pool_bytes() / 2**20, 1)
    log(f"graph pool after {where}: {POOL_READINGS[where]:.1f} MiB reserved "
        f"(all memory reserved {torch.cuda.memory_reserved() / 2**20:.1f} MiB)")


def start_peak(tag: str):
    """Start a reading of peak device memory. The allocator counts a cached
    block that it reuses unsplit at its whole size, so the peak would
    depend on the blocks that earlier phases left in its cache: those are
    returned to the card first (after the collector frees any tensors held
    in reference cycles)."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{tag}: device memory allocated at the start "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB")
    torch.cuda.reset_peak_memory_stats()


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
def new_slam(cfg, n_frames: int, seed: int, capture=None):
    """A ``NiceSLAM`` on the bench's 36-frame trajectory that runs the first
    ``n_frames`` of it, on the card (the default device); its programs run
    as CUDA graphs unless ``capture`` is False."""
    from niceslam_tpu_torch.io.datasets.synthetic import SyntheticBoxReader
    from niceslam_tpu_torch.slam.system import NiceSLAM

    reader = SyntheticBoxReader(cfg, n_frames=36)
    slam = NiceSLAM(cfg, reader=reader, seed=seed, capture=capture)
    slam.n_imgs = n_frames
    return slam, reader


def snapshot(slam) -> dict:
    """The map's grids (copies on the card) and the poses so far."""
    return dict(grids={lvl: g.detach().clone() for lvl, g in slam.state.grids.items()},
                poses=np.stack(slam.est_c2w))


def phase_main_path(cfg, n_frames: int, seed: int = 0, route: str = "fused",
                    keep: int = 0, capture=None, label: str = "", watch=None):
    """``NiceSLAM.step`` over ``n_frames`` under ``route`` (graphed, or eager
    with ``capture=False``); with ``keep`` the result holds a
    :func:`snapshot` after frame ``keep - 1`` and the grids after frame 0
    (on the host). ``label`` names the run in the log; ``watch``, a
    context manager, is entered around the frames (not ``precompile``)."""
    from niceslam_tpu_torch.ops.trilerp_kernels import FWD_TALLY as tally
    from niceslam_tpu_torch.ops.trilinear import sampler_route

    slam, reader = new_slam(cfg, n_frames, seed, capture)
    frames = [reader[k] for k in range(n_frames)]
    kept = kept0 = None
    tag = f"[{route}]{' eager' if capture is False else ''}{label} seed {seed}"
    t0 = time.perf_counter()
    with sampler_route(route):
        slam.precompile()
    torch.cuda.synchronize()
    n_pre = len(slam._programs.captures)
    log(f"{tag}: precompile {time.perf_counter() - t0:.3f} s, {n_pre} graphs")
    torch.cuda.synchronize()
    start_peak(tag)
    start_bytes = torch.cuda.memory_allocated()
    clear_tallies()
    dts = []
    with watch if watch is not None else contextlib.nullcontext():
        for k, frame in enumerate(frames):
            dts.append(_main_path_frame(slam, frame, k, route, tag, cfg))
            if keep and k == 0:
                # On the host: not part of the run's device memory.
                kept0 = {k: v.cpu() for k, v in slam.state.grids.items()}
            if k == keep - 1:
                kept = snapshot(slam)
    peak = torch.cuda.max_memory_allocated()
    launches = all_launches()
    log(f"{tag}: main-path launches: {launches}")
    if launches["trilerp_fwd"]:
        if sum(tally.values()) != launches["trilerp_fwd"]:
            raise AssertionError(f"{tag}: K1's tally {dict(tally)} does not add up to "
                                 f"{launches['trilerp_fwd']}")
        log(f"{tag}: K1 launches by variant, derivative output and N: " + ", ".join(
            f"{var} deriv={int(d)} N={n}: {c}" for (var, d, n), c in sorted(tally.items())))
        log(f"{tag}: K2 launches by the gradients asked for: {k2_tally()}")
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
    log(f"{tag}: sha1 of the poses and the grids: {digest(poses, slam.state.grids)}")
    # Accuracy is judged over seeds, against the tripwire's bounds, by
    # tests/test_torch_slam.py; here only a lost track fails.
    lost = lost_track(ate_cm, err_cm)
    if lost:
        raise AssertionError(f"{tag}: the track is lost: {lost}")
    log_captures(tag, slam)
    check_keyframe_captures(tag, slam, n_pre)
    return dict(launches=launches, slam=slam, reader=reader, ate_cm=ate_cm, dts=dts,
                peak_bytes=peak, start_bytes=start_bytes, kept=kept, kept0=kept0,
                seed=seed, route=route, n_frames=n_frames, poses=poses,
                grids=slam.state.grids)


def _main_path_frame(slam, frame, k: int, route: str, tag: str, cfg) -> float:
    """One frame of :func:`phase_main_path`; returns its seconds."""
    from niceslam_tpu_torch.ops.trilerp_kernels import BWD_TALLY as bwd_tally
    from niceslam_tpu_torch.ops.trilerp_kernels import FWD_TALLY as tally
    from niceslam_tpu_torch.ops.trilinear import sampler_route

    t0 = time.perf_counter()
    with sampler_route(route):
        slam.step(frame)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ev = [e for e in slam.events if e.get("frame") == k]
    fr = ev[-1]
    log(f"{tag} frame {k}: {dt:.3f} s (track {fr['dt_track']:.3f} s, map "
        f"{fr['dt_map']:.3f} s)  " + " ".join(
            f"{e['event']}({'coarse' if e.get('coarse') else 'staged'})" for e in ev[:-1]))
    if k == 0 and route == "packed":
        # Not part of the main path: its launches are taken out again.
        counts, split, split2 = all_launches(), dict(tally), dict(bwd_tally)
        compare_routes_on_map(slam, frame, cfg)
        set_launches(counts)
        tally.clear()
        tally.update(split)
        bwd_tally.clear()
        bwd_tally.update(split2)
    return dt


def log_captures(tag: str, slam):
    """Every graph the run captured: what it runs, its warm-up and capture
    seconds, node count and launches per replay; the pools' reserved
    memory."""
    from niceslam_tpu_torch.slam.programs import pool_bytes

    progs = slam._programs
    for c in progs.captures:
        log(f"{tag}: captured {c.signature}: {c.seconds:.3f} s, {c.nodes} nodes, "
            f"launches per replay {c.launches}")
    if progs.capture:
        log(f"{tag}: the card's graph pool (every graph of the process) "
            f"{pool_bytes() / 2**20:.1f} MiB reserved")


KEYFRAME_PROGRAMS = ("keyframe_overlap", "frustum_masks")


def check_keyframe_captures(tag: str, slam, n_pre: int):
    """With graphs, ``precompile`` (the first ``n_pre`` captures) captured
    the keyframe overlap and the frustum masks, and the run captured no
    keyframe program after it."""
    if not slam._programs.capture:
        return
    sigs = [c.signature.split()[0] for c in slam._programs.captures]
    late = [s for s in sigs[n_pre:] if s in KEYFRAME_PROGRAMS]
    if late or not all(name in sigs[:n_pre] for name in KEYFRAME_PROGRAMS):
        raise AssertionError(f"{tag}: keyframe programs captured by precompile "
                             f"{[s for s in sigs[:n_pre] if s in KEYFRAME_PROGRAMS]}, later {late}")
    log(f"{tag}: the keyframe programs were captured by precompile, none later")


def digest(poses: np.ndarray, grids: dict) -> str:
    """sha1 of a run's poses (float32) and grids: one seed is one trajectory
    on the card, so two commits that compute the same bits print the same
    digest."""
    import hashlib

    h = hashlib.sha1(np.ascontiguousarray(poses, np.float32).tobytes())
    for lvl in sorted(grids):
        h.update(grids[lvl].detach().cpu().numpy().tobytes())
    return h.hexdigest()


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
    under each route the query and the vertex colours graphed (the
    process-wide programs) against eager (``Programs(capture=False)``), bit
    for bit, with the seconds of each; ``postprocess_mesh`` and
    ``write_ply`` of the packed mesh."""
    from niceslam_tpu_torch.eval import mesher
    from niceslam_tpu_torch.ops.trilinear import sampler_route
    from niceslam_tpu_torch.slam.programs import Programs, pool_bytes, shared_programs

    st = slam.state
    args = (st.decoders, st.grids, slam.bounds, slam.scene_bound)
    fields, meshes = {}, {}

    def timed(fn, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for route in ("fused", "packed"):
        eager = Programs(capture=False)
        with sampler_route(route):
            torch.cuda.synchronize()
            start_peak(f"mesher [{route}]")
            (occ, _), t_first = timed(mesher.query_occupancy_grid, *args, resolution=resolution)
            set_launches({})
            (occ, _), t_query = timed(mesher.query_occupancy_grid, *args, resolution=resolution)
            launches = all_launches()
            peak = torch.cuda.max_memory_allocated()
            set_launches({})
            (occ_e, _), t_query_e = timed(mesher.query_occupancy_grid, *args,
                                          resolution=resolution, programs=eager)
            launches_e = all_launches()
            meshes[route], t_all = timed(mesher.extract_mesh, *args, resolution=resolution,
                                         level=cfg.meshing.level_set)
            mesh_e, t_all_e = timed(mesher.extract_mesh, *args, resolution=resolution,
                                    level=cfg.meshing.level_set, programs=eager)
            vf = meshes[route][0].astype(np.float32)
            cols, t_col = timed(mesher.query_chunks, *args[:3], vf, 65536, "color", "rgb")
            cols_e, t_col_e = timed(mesher.query_chunks, *args[:3], vf, 65536, "color", "rgb",
                                    programs=eager)
        check_route_launches(f"mesher [{route}]", route, launches, forward_only=True)
        if not np.isfinite(occ).all():
            raise AssertionError(f"mesher [{route}]: non-finite occupancy")
        verts, faces, colors = meshes[route]
        if not (len(verts) > 0 and len(faces) > 0):
            raise AssertionError(f"mesher [{route}]: empty mesh")
        if launches != launches_e:
            raise AssertionError(f"mesher [{route}]: query launches graphed {launches}, eager "
                                 f"{launches_e}")
        if not (np.array_equal(occ, occ_e) and np.array_equal(cols, cols_e) and all(
                np.array_equal(a, b) for a, b in zip(meshes[route], mesh_e))):
            raise AssertionError(f"mesher [{route}]: the graphed query or vertex colours "
                                 f"differ from the eager ones")
        fields[route] = occ
        log(f"mesher [{route}]: {occ.size} query points in {-(-occ.size // 65536)} chunks: "
            f"query graphed {t_query:.3f} s (first, with its capture, {t_first:.3f} s), eager "
            f"{t_query_e:.3f} s (launches {launches} both ways, peak device memory "
            f"{peak / 2**20:.1f} MiB); extract_mesh graphed {t_all:.3f} s, eager "
            f"{t_all_e:.3f} s, of which {t_all - t_query:.3f} / {t_all_e - t_query_e:.3f} s "
            f"past the query (marching tetrahedra on the host, vertex colors): {len(verts)} "
            f"verts, {len(faces)} faces; the vertex colours' query graphed {t_col:.3f} s, eager "
            f"{t_col_e:.3f} s; the field, vertices, faces and colours equal graphed and eager "
            f"bit for bit")
    for c in shared_programs("cuda").captures:
        if c.signature.startswith("mesher_chunk"):
            log(f"mesher: captured {c.signature}: {c.seconds:.3f} s, {c.nodes} nodes, "
                f"launches per replay {c.launches}")
    log(f"mesher: the card's graph pool {pool_bytes() / 2**20:.1f} "
        f"MiB reserved")
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


def phase_panel(slam, reader):
    """One panel's render as the visualizer makes it (``render_image`` of
    the map at the last pose, guided by that frame's depth) through the
    process-wide programs, graphed against eager: bit for bit, with the
    seconds of each (the graphed one with its capture)."""
    from niceslam_tpu_torch.render.renderer import render_image
    from niceslam_tpu_torch.slam.programs import Programs

    k = len(slam.est_c2w) - 1
    c2w = torch.as_tensor(slam.est_c2w[k], dtype=torch.float32, device="cuda")
    depth = torch.as_tensor(reader[k].depth, dtype=torch.float32, device="cuda")
    fields = ("rgb", "depth", "depth_var", "weights")
    outs, secs = {}, {}
    for way, progs in (("graphed", None), ("eager", Programs(capture=False))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_image(slam.state.decoders, slam.state.grids, slam.bounds, slam.scene_bound,
                           slam.intr, c2w, depth, "color", slam.rcfg, programs=progs)
        torch.cuda.synchronize()
        outs[way], secs[way] = out, time.perf_counter() - t0
    differ = [f for f in fields
              if not torch.equal(getattr(outs["graphed"], f), getattr(outs["eager"], f))]
    if differ or not bool(torch.isfinite(outs["graphed"].rgb).all()):
        raise AssertionError(f"panel: graphed and eager differ in {differ}, or rgb not finite")
    log(f"panel: render_image of frame {k} at {slam.intr.W}x{slam.intr.H}, graphed (with its "
        f"capture) {secs['graphed']:.3f} s, eager {secs['eager']:.3f} s, equal bit for bit in "
        f"{', '.join(fields)}")


# ------------------------------------------------------------ phases 6-9
def k2_tally() -> dict:
    """K2's launches by the gradients asked for (``dgrid``, ``dv``) since
    the counts were last cleared."""
    from niceslam_tpu_torch.ops.trilerp_kernels import BWD_TALLY

    return {f"dgrid={int(d)} dv={int(v)}": c for (d, v), c in sorted(BWD_TALLY.items())}


def clear_tallies():
    from niceslam_tpu_torch.ops.trilerp_kernels import BWD_TALLY, FWD_TALLY

    set_launches({})
    FWD_TALLY.clear()
    BWD_TALLY.clear()


def state_copy(slam) -> dict:
    """Copies of the published map (grids, decoders), the keyframe DB and its
    host mirrors."""
    from niceslam_tpu_torch.models.decoders import tree_leaves

    kf = dataclasses.asdict(slam.state.keyframes)
    return dict(
        grids={k: v.clone() for k, v in slam.state.grids.items()},
        decoders=[t.clone() for t in tree_leaves(slam.state.decoders)],
        kf={k: v.clone() if torch.is_tensor(v) else v for k, v in kf.items()},
        kf_count=slam._kf_count, kf_slots=slam._kf_slot_frame.copy(),
    )


def state_diffs(a: dict, b: dict) -> list:
    """The names of the parts of two :func:`state_copy` results that differ
    in any bit."""
    out = [f"grid {k}" for k in a["grids"] if not torch.equal(a["grids"][k], b["grids"][k])]
    if len(a["decoders"]) != len(b["decoders"]) or not all(
            torch.equal(x, y) for x, y in zip(a["decoders"], b["decoders"])):
        out.append("decoders")
    for k, v in a["kf"].items():
        w = b["kf"][k]
        if not (torch.equal(v, w) if torch.is_tensor(v) else v == w):
            out.append(f"keyframes.{k}")
    if a["kf_count"] != b["kf_count"] or not np.array_equal(a["kf_slots"], b["kf_slots"]):
        out.append("keyframe bookkeeping")
    return out


def phase_adam(run: dict, cfg):
    """One frame's Adam solve with ``configs/cofusion.yaml``'s tracking (200
    px, 10 iterations, lr 1e-3, separate learning rates) on the fused strict
    run's frame-0 map, from frame 0's pose to frame 1, on the card and on the
    CPU with the same injected pixels; then K2 without the grid gradient
    (its per-point ``dv`` pass, as the Adam tracker's backward launches it)
    on the tracking batch of the solve's first iteration, against its plain
    version."""
    from niceslam_tpu_torch.config.schema import load_config
    from niceslam_tpu_torch.models.decoders import tree_map
    from niceslam_tpu_torch.ops import trilerp_kernels as tk
    from niceslam_tpu_torch.slam.tracker import track_config, track_frame

    slam, reader = run["slam"], run["reader"]
    ccfg = load_config(os.path.join(ROOT, "configs", "cofusion.yaml"),
                       overrides={"tracking.method": "adam"})
    tcfg = track_config(ccfg.tracking)
    log(f"adam: tracking config of configs/cofusion.yaml: pixels {tcfg.pixels}, iters "
        f"{tcfg.iters}, lr {tcfg.lr}, separate_LR {tcfg.separate_LR}")
    f0, f1 = reader[0], reader[1]
    rng = np.random.default_rng(4)
    intr = slam.intr
    px = [(rng.integers(tcfg.ignore_edge_W, intr.W - tcfg.ignore_edge_W, tcfg.pixels),
           rng.integers(tcfg.ignore_edge_H, intr.H - tcfg.ignore_edge_H, tcfg.pixels))
          for _ in range(tcfg.iters)]
    grids0 = {dev: {k: v.to(dev) for k, v in run["kept0"].items()} for dev in ("cuda", "cpu")}
    seen = []
    bwd = tk.trilerp_bwd

    def spy(grid, v, g, need_dgrid=True, need_dv=True):
        if len(seen) < 3:  # the first iteration's levels: middle, fine, color
            lvl = next(k for k, t in grids0["cuda"].items() if t.data_ptr() == grid.data_ptr())
            seen.append((lvl, grid.clone(), v.clone(), g.clone()))
        return bwd(grid, v, g, need_dgrid, need_dv)

    def solve(dev):
        to = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt).to(dev)  # noqa: E731
        return track_frame(
            tree_map(lambda t: t.to(dev), slam.state.decoders), grids0[dev],
            {k: v.to(dev) for k, v in slam.bounds.items()}, slam.scene_bound.to(dev), intr,
            to(f1.color), to(f1.depth), to(f0.gt_c2w), tcfg, slam.rcfg,
            pixels=[(to(i, torch.long), to(j, torch.long)) for i, j in px],
        )

    torch.cuda.synchronize()
    clear_tallies()
    tk.trilerp_bwd = spy
    try:
        pose, losses = solve("cuda")
        torch.cuda.synchronize()
    finally:
        tk.trilerp_bwd = bwd
    launches, tally = all_launches(), k2_tally()
    check_route_launches("adam solve", "fused", launches)
    if set(tally) != {"dgrid=0 dv=1"}:
        raise AssertionError(f"adam solve: K2 asked for a grid gradient: {tally}")
    t0 = time.perf_counter()
    solve("cuda")
    torch.cuda.synchronize()
    gn = [e["dt_track"] for e in slam.events
          if e["event"] == "frame" and e["frame"] > 0 and e["dt_map"] == 0.0]
    log(f"adam: launches {launches}; K2 by gradients {tally}; one frame's solve again: "
        f"{time.perf_counter() - t0:.3f} s (GN tracking of the strict run's track-only "
        f"frames: {gn} s)")
    t0 = time.perf_counter()
    cpose, closses = solve("cpu")
    log(f"adam: the same solve on the CPU in {time.perf_counter() - t0:.3f} s")
    dpose = max_err(pose.cpu(), cpose)
    moved = float(np.abs(cpose.numpy() - f0.gt_c2w).max())
    log(f"adam: pose card vs CPU max abs diff {dpose:.3e} (tolerance 1e-4; the pose "
        f"moved {moved:.3e} from the warm start); losses card {losses.cpu().numpy()}, "
        f"CPU {closses.numpy()}; best iterate {int(losses.argmin())} / {int(closses.argmin())}")
    if not dpose <= 1e-4:
        raise AssertionError(f"adam: the card's pose differs from the CPU's by {dpose:.3e}")
    if not moved > 1e-4:
        raise AssertionError(f"adam: the solve did not move the pose ({moved:.2e})")
    err_cm = 100 * float(np.linalg.norm(pose.cpu().numpy()[:3, 3] - f1.gt_c2w[:3, 3]))
    log(f"adam: frame 1 position error {err_cm:.3f} cm (warm start "
        f"{100 * float(np.linalg.norm(f0.gt_c2w[:3, 3] - f1.gt_c2w[:3, 3])):.3f} cm)")

    rows = []
    for lvl, grid, v, g in seen:
        n, C = v.shape[0], grid.shape[-1]
        name = f"{lvl} tracking batch N={n}"
        _, dv = tk.trilerp_bwd(grid, v, g, need_dgrid=False)
        _, rdv = tk.trilerp_bwd_plain(grid, v, g, need_dgrid=False)
        torch.cuda.synchronize()
        check_close(f"trilerp_bwd dv only [{name}]", dv, rdv, 2e-5, 2e-5)
        vol, nrm = grid_sample_inputs(grid, v)
        lib_gout = g.t().reshape(1, C, n, 1, 1).contiguous()
        touched = corner_rows_touched(grid, v)
        bms, by = bound_ms(4 * (touched * C + 3 * n + n * C + 3 * n),
                           n * C * (FWD_OPS + DERIV_OPS + 6))
        rows.append(dict(
            name="trilerp_bwd", case=f"{name} need_dgrid=0", points="tracking",
            max_abs_err=max_err(dv, rdv),
            **paired_ms(lambda: tk.trilerp_bwd(grid, v, g, need_dgrid=False),
                        lambda: torch.ops.aten.grid_sampler_3d_backward(
                            lib_gout, vol, nrm, 0, 1, True, [False, True])),
            plain_ms=device_ms(lambda: tk.trilerp_bwd_plain(grid, v, g, need_dgrid=False),
                               reps=10),
            bound_ms=bms, bound_by=by, extra=f"{touched} rows touched"))
    for r in rows:
        log_kernel_row(r)
    return rows


# What ``set_sync_debug_mode("warn")`` says of a call that waits for the
# stream. The mode's first use in a process also warns that it is a
# prototype ("does not yet detect all synchronizing operations"), at the
# line that sets the mode: that notice is no wait.
SYNC_WARNING = "called a synchronizing CUDA operation"


def sync_site(filename: str, lineno: int) -> str:
    """Where a call that waited for the stream was made: the innermost frame
    of the package on the stack, else of this repository (``file:line``),
    and the library's line that reported it where that is another."""
    import traceback

    here = f"{os.path.relpath(filename, ROOT)}:{lineno}"
    stack = traceback.extract_stack()[:-2]  # without this function and its caller
    for prefix in (os.path.join(ROOT, "niceslam_tpu_torch"), ROOT):
        for fr in reversed(stack):
            if fr.filename.startswith(prefix):
                site = f"{os.path.relpath(fr.filename, ROOT)}:{fr.lineno}"
                return site if site == here else f"{site} ({os.path.basename(filename)}:{lineno})"
    return here


def phase_async(cfg, strict: dict, capture=None):
    """The main path in ``sync_method="async"`` (fused route, frames through
    the prefetcher; graphed, or eager with ``capture=False``): its flushed
    trajectory and map must equal the strict run's bit for bit. Frames 1+
    run under ``set_sync_debug_mode("warn")``: each call that waits for the
    stream is counted by call site; every read of a deferred host copy is
    counted, and whether it had to wait."""
    import warnings
    from collections import Counter

    from niceslam_tpu_torch.core.transfer import HostCopy
    from niceslam_tpu_torch.io.prefetch import Prefetcher

    n = strict["n_frames"]
    acfg = dataclasses.replace(cfg, sync_method="async")
    slam, reader = new_slam(acfg, n, 0, capture)
    tag = f"[fused]{' eager' if capture is False else ''} async seed 0"
    slam.precompile()  # as the command line does, before the prefetcher starts
    n_pre = len(slam._programs.captures)
    reads = Counter()
    numpy = HostCopy.numpy

    def counted(self):
        reads["waited" if self.event is not None and not self.event.query() else "ready"] += 1
        return numpy(self)

    def record(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            sites[sync_site(filename, lineno)] += 1

    torch.cuda.synchronize()
    start_peak(tag)
    start = torch.cuda.memory_allocated()
    clear_tallies()
    dts, sites = [], Counter()
    pf = Prefetcher(reader, device="cuda", end=n)
    HostCopy.numpy = counted
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            for k, frame in enumerate(pf):
                if k == 1:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    warnings.showwarning = record
                    torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                slam.step(frame)
                if k == 0:
                    torch.cuda.synchronize()
                dts.append(time.perf_counter() - t0)
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    finally:
        torch.cuda.set_sync_debug_mode(0)
        HostCopy.numpy = numpy
        pf.close()
    peak = torch.cuda.max_memory_allocated()
    launches = all_launches()
    check_route_launches(f"main path {tag}", "fused", launches)
    res = slam.result()
    poses = np.stack(res["est_c2w"])
    log(f"{tag}: host seconds per frame (frame 0 to the card's end, then queueing only): "
        f"{[round(d, 4) for d in dts]}")
    log(f"{tag}: frames 1-{n - 1}: {wall:.3f} s to the card's end (strict: "
        f"{sum(strict['dts'][1:]):.3f} s; per frame {[round(d, 4) for d in strict['dts']]})")
    log(f"{tag}: calls that waited for the stream in frames 1-{n - 1}: "
        f"{sum(sites.values())} {dict(sites.most_common())}")
    log(f"{tag}: deferred host copies read: {dict(reads)}")
    log(f"{tag}: peak device memory {peak / 2**20:.1f} MiB (max_memory_allocated), "
        f"{(peak - start) / 2**20:.1f} MiB over the start (strict: "
        f"{(strict['peak_bytes'] - strict['start_bytes']) / 2**20:.1f}); "
        f"launches {launches}; K2 by gradients {k2_tally()}")
    if not np.array_equal(poses, strict["poses"]):
        raise AssertionError(f"{tag}: the trajectory differs from the strict run's "
                             f"(max abs diff {np.abs(poses - strict['poses']).max():.3e})")
    diffs = [lvl for lvl, g in slam.state.grids.items()
             if not torch.equal(g, strict["grids"][lvl])]
    if diffs:
        raise AssertionError(f"{tag}: grids {diffs} differ from the strict run's")
    rejected = [e for e in slam.events if e["event"] == "map_rejected"]
    if rejected:
        raise AssertionError(f"{tag}: mapping passes rejected: {rejected}")
    if sites:
        raise AssertionError(f"{tag}: calls in frames 1-{n - 1} waited for the stream: "
                             f"{dict(sites)}")
    log_captures(tag, slam)
    check_keyframe_captures(tag, slam, n_pre)
    log(f"{tag}: trajectory and grids equal to the strict run's bit for bit; ATE "
        f"{100 * res['ate_rmse']:.4f} cm")
    return dict(wall=wall, sites=sites, peak_bytes=peak, dts=dts, launches=launches,
                digest=digest(poses, slam.state.grids))


def phase_async_fault(cfg, n_frames: int, iters_first: int):
    """A short async run in which ``fault_hook`` turns one BA mapping event's
    outputs (grids, cameras, losses) to NaN: the event must be rejected at
    the next one, the map stay finite, and the state right after the
    rollback equal the state before the event bit for bit."""
    fault_at = cfg.mapping.bootstrap_frames  # the first event with BA
    log(f"cut: async fault run: mapping.iters_first {cfg.mapping.iters_first} -> "
        f"{iters_first}, {n_frames} frames, NaN outputs of the event at frame {fault_at}")
    acfg = dataclasses.replace(cfg, sync_method="async", mapping=dataclasses.replace(
        cfg.mapping, iters_first=iters_first))
    slam, reader = new_slam(acfg, n_frames, 0)
    saved, faults = {}, []

    def corrupt(idx, outs):
        grids, decoders, cams, losses = outs
        if idx == fault_at:
            faults.append(idx)
            grids = {k: g * float("nan") for k, g in grids.items()}
            cams, losses = cams * float("nan"), losses * float("nan")
        return grids, decoders, cams, losses

    map_frame, verify = slam.map_frame, slam._verify_pending

    def spy_map_frame(frame, first=False):
        if len(slam.est_c2w) - 1 == fault_at:
            saved["pre"] = state_copy(slam)
            saved["pose"] = slam.est_c2w[fault_at].clone()
            saved["ba"] = slam._kf_count > acfg.mapping.BA_min_keyframes
        map_frame(frame, first)

    def spy_verify():
        k = len(slam.events)
        verify()
        if any(e["event"] == "map_rejected" for e in slam.events[k:]):
            saved["post"] = state_copy(slam)
            saved["post_pose"] = slam.est_c2w[fault_at].clone()

    slam.fault_hook = corrupt
    slam.map_frame, slam._verify_pending = spy_map_frame, spy_verify
    t0 = time.perf_counter()
    clear_tallies()
    res = slam.run(n_frames)
    launches = all_launches()
    check_route_launches("async fault run", "fused", launches)
    rejected = [e for e in slam.events if e["event"] == "map_rejected"]
    log(f"async fault: {n_frames} frames in {time.perf_counter() - t0:.3f} s; faulted "
        f"passes {faults}; BA in the event {saved.get('ba')}; rejected {rejected}")
    if not (faults and len(rejected) == 1 and rejected[0]["frame"] == fault_at):
        raise AssertionError(f"async fault: want one map_rejected at frame {fault_at}, "
                             f"got {rejected}")
    if "post" not in saved or not saved["ba"]:
        raise AssertionError("async fault: no rollback seen, or no BA in the faulty event")
    diffs = state_diffs(saved["post"], saved["pre"])
    if diffs or not torch.equal(saved["post_pose"], saved["pose"]):
        raise AssertionError(f"async fault: after the rollback {diffs or 'the pose'} "
                             f"differ from the pre-event state")
    poses = np.stack(res["est_c2w"])
    if not (np.isfinite(poses).all() and bool(torch.isfinite(slam.state.keyframes.est_c2w).all())
            and all(bool(torch.isfinite(g).all()) for g in slam.state.grids.values())):
        raise AssertionError("async fault: non-finite map or poses after the rollback")
    log(f"async fault: after the rollback the grids, decoders, keyframe DB (with the BA "
        f"poses) and the event frame's pose equal the pre-event state bit for bit; map "
        f"and poses finite; ATE {100 * res['ate_rmse']:.4f} cm")


def ply_counts(path: str):
    """(vertices, faces) from an ASCII PLY header."""
    counts = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("element"):
                _, kind, k = line.split()
                counts[kind] = int(k)
            if line.startswith("end_header"):
                break
    return counts.get("vertex", 0), counts.get("face", 0)


def phase_cli(frames: int = 8):
    """``python -m niceslam_tpu_torch`` in-process: ``configs/cofusion.yaml``
    on the synthetic scene, async, Adam tracking, a checkpoint every 4
    frames, trajectory and mesh; then a resume from the frame-4 checkpoint.
    The state the first run saved must equal a restore of it bit for bit."""
    import contextlib
    import io

    import niceslam_tpu_torch.__main__ as cli
    from niceslam_tpu_torch.config.schema import load_config
    from niceslam_tpu_torch.slam.system import NiceSLAM

    overrides = ["dataset=synthetic", "sync_method=async", "tracking.method=adam",
                 "mapping.ckpt_freq=4", "meshing.clean_mesh=false"]
    log("cli: meshing.clean_mesh=false: the cleanup culls the whole mesh of the synthetic "
        "scene (its frustum test takes camera z forward; ROADMAP, queue 3)")
    saved = {}
    save = cli.save_checkpoint

    def capture(path, state, est_c2w, gt_c2w, frame_idx, **kw):
        save(path, state, est_c2w, gt_c2w, frame_idx, **kw)
        saved[path] = dict(state=state_copy(_Holder(state)), poses=np.stack(est_c2w))

    config = os.path.join(ROOT, "configs", "cofusion.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        def run(extra, tag):
            argv = [config, "--frames", str(frames),
                    "--log", os.path.join(tmp, f"{tag}.jsonl"),
                    "--ckpt-dir", os.path.join(tmp, "ck"),
                    "--trajectory", os.path.join(tmp, f"{tag}.npy"),
                    "--mesh", os.path.join(tmp, f"{tag}.ply"), "--mesh-resolution", "64",
                    *extra]
            for o in overrides:
                argv += ["--set", o]
            out = io.StringIO()
            clear_tallies()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv)
            dt = time.perf_counter() - t0
            launches = all_launches()
            lines = out.getvalue().strip().splitlines()
            last = json.loads(lines[-1])
            log(f"cli [{tag}]: rc {rc} in {dt:.1f} s; {lines[-2]}; last line {lines[-1]}; "
                f"launches {launches}; K2 by gradients {k2_tally()}")
            check_route_launches(f"cli [{tag}]", "fused", launches)
            traj = np.load(os.path.join(tmp, f"{tag}.npy"))
            nv, nf = ply_counts(os.path.join(tmp, f"{tag}.ply"))
            if not (rc == 0 and set(last) == {"frames", "fps_avg", "ate_rmse_cm"}
                    and last["frames"] == frames and traj.shape == (frames, 4, 4)
                    and np.isfinite(traj).all() and nv > 0 and nf > 0):
                raise AssertionError(f"cli [{tag}]: rc {rc}, last line {last}, trajectory "
                                     f"{traj.shape}, mesh {nv} verts {nf} faces")
            log(f"cli [{tag}]: {frames} finite poses, mesh {nv} verts {nf} faces; Adam's ATE "
                f"{last['ate_rmse_cm']} cm")
            return traj

        cli.save_checkpoint = capture
        try:
            traj = run([], "run")
        finally:
            cli.save_checkpoint = save
        ck = os.path.join(tmp, "ck", "frame_000004")
        if list(saved) != [ck]:
            raise AssertionError(f"cli: checkpoints written {list(saved)}, want [{ck}]")
        fresh = NiceSLAM(load_config(config, overrides=cli.parse_overrides(overrides)))
        start = fresh.restore(ck)
        diffs = state_diffs(state_copy(fresh), saved[ck]["state"])
        if start != 5 or diffs or not np.array_equal(np.stack(fresh.est_c2w),
                                                     saved[ck]["poses"]):
            raise AssertionError(f"cli: restore of {ck} (next frame {start}) differs from the "
                                 f"saved state: {diffs or 'poses'}")
        log(f"cli: a restore of {os.path.basename(ck)} equals the state that was saved bit for bit: grids, decoders, keyframe DB, "
            f"its bookkeeping, poses")
        del fresh
        traj2 = run(["--resume", ck, "--no-precompile"], "resume")
        if not np.array_equal(traj2[:5], traj[:5]):
            raise AssertionError("cli: the resumed trajectory does not start with the "
                                 "saved one")


class _Holder:
    """A ``NiceSLAM``-shaped view of a saved ``MapState`` for
    :func:`state_copy` (the host mirrors rebuilt from the DB, as ``restore``
    does)."""

    def __init__(self, state):
        self.state = state
        self._kf_count = int(state.keyframes.count)
        self._kf_slot_frame = state.keyframes.frame_idx.cpu().numpy().astype(np.int64)


# ---------------------------------------------------------------- phase 13
# The cut main path (frames, mapping.iters_first) that phases 13 and 15 run
# graphed and eagerly, and phase 11's system with the importance pass: frame
# 0's pass and one frame of tracking and mapping.
CUT = (2, 100)


def cut_config(cfg, iters_first: int):
    return dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping,
                                                                 iters_first=iters_first))


def frame_seconds(dts) -> str:
    """Seconds of frame 0, frames 1-5, frame 6 and frame 7 (PERF.md §5's
    columns) where the run has them, and after frame 0 in all."""
    parts = [f"0: {dts[0]:.3f}"]
    if len(dts) >= 8:
        parts += [f"1-5: {min(dts[1:6]):.3f}-{max(dts[1:6]):.3f}", f"6: {dts[6]:.3f}",
                  f"7: {dts[7]:.3f}"]
    return ", ".join(parts + [f"after 0: {sum(dts[1:]):.3f}"])


def trace_busy(slam, reader, tag: str, n: int = 2):
    """``n`` more frames of a finished strict main path under
    ``torch.profiler`` (after 8 frames: a tracking-only frame, then the
    last frame's mapping event): the card's busy share, its kernel and copy time over
    the wall of the profiled frames (synchronised); None where the trace
    holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    first = len(slam.est_c2w)
    slam.n_imgs = first + n
    frames = [reader[k] for k in range(first, first + n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for frame in frames:
            slam.step(frame)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    share = busy / wall if busy > 0 else None
    log(f"{tag}: frames {first}-{first + n - 1} under the profiler: wall {wall:.3f} s, device "
        f"time {busy:.4f} s in {sum(e.count for e in kern)} kernels and copies, busy share "
        + (f"{share:.4f}" if share is not None else "not measured (no device time traced)"))
    return share


def phase_graphs(cfg, graphed_busy):
    """The main path cut to ``CUT`` (frames, ``iters_first``) graphed and
    eagerly (``capture=False``) in this call, on the fused route, then the
    packed one, then async: equal digests and equal launches of every
    kernel; seconds per frame and peak memory both ways; on the fused route
    the eager run's busy share over one more traced frame (a mapping
    event), beside the 8-frame graphed run's (``graphed_busy``)."""
    frames, iters_first = CUT
    ccfg = cut_config(cfg, iters_first)
    strict = {}
    for route in ("fused", "packed"):
        g, e = (phase_main_path(ccfg, frames, route=route, capture=c, label=" cut")
                for c in (None, False))
        g_digest, e_digest = digest(g["poses"], g["grids"]), digest(e["poses"], e["grids"])
        log(f"graphs [{route}] cut: seconds per frame graphed {frame_seconds(g['dts'])}; eager "
            f"{frame_seconds(e['dts'])}")
        log(f"graphs [{route}] cut: peak device memory graphed {g['peak_bytes'] / 2**20:.1f} MiB "
            f"({(g['peak_bytes'] - g['start_bytes']) / 2**20:.1f} over its start), eager "
            f"{e['peak_bytes'] / 2**20:.1f} MiB "
            f"({(e['peak_bytes'] - e['start_bytes']) / 2**20:.1f} over its start)")
        log(f"graphs [{route}] cut: sha1 graphed {g_digest}, eager {e_digest}")
        if g_digest != e_digest:
            raise AssertionError(f"graphs [{route}]: the graphed and eager main paths differ")
        if g["launches"] != e["launches"]:
            raise AssertionError(f"graphs [{route}]: launches graphed {g['launches']}, eager "
                                 f"{e['launches']}")
        if route == "fused":
            busy = trace_busy(e["slam"], e["reader"], "graphs [fused] cut eager", n=1)
            log(f"graphs [fused]: busy share graphed {graphed_busy} (frames 8-9 of phase 4), "
                f"eager {busy} (frame {frames} of the cut)")
            strict = {"graphed": g, "eager": e}
        del g["slam"], e["slam"]
    a = {way: phase_async(ccfg, strict[way], capture=c)
         for way, c in (("graphed", None), ("eager", False))}
    log(f"graphs [fused] async cut: sha1 graphed {a['graphed']['digest']}, eager "
        f"{a['eager']['digest']}; host seconds per frame graphed "
        f"{[round(d, 4) for d in a['graphed']['dts']]}, eager "
        f"{[round(d, 4) for d in a['eager']['dts']]}")
    if (a["eager"]["digest"] != a["graphed"]["digest"]
            or a["eager"]["launches"] != a["graphed"]["launches"]):
        raise AssertionError(f"graphs async: graphed {a['graphed']['digest']} "
                             f"{a['graphed']['launches']}, eager {a['eager']['digest']} "
                             f"{a['eager']['launches']}")
    log("graphs: the graphed main path equals the eager one bit for bit, with the same "
        "launches, on both routes and in both sync methods")


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


# ---------------------------------------------------------------- phase 10
# ``python -m niceslam_tpu_torch`` in a subprocess, watched by
# :func:`envelope_cli`, which reports every kernel's launch count on standard
# error once the command line's own ``main`` ends.
CLI_WATCHED = "import sys, chip_smoke\nsys.exit(chip_smoke.envelope_cli(sys.argv[1:]))\n"
# The kernels' names in a profiler trace (csrc/trilerp.cu: K1, and K2's two
# kernels).
K1_K2_NAMES = ("trilerp_fwd_kernel", "trilerp_bwd_points_kernel", "trilerp_bwd_fill_kernel")


def write_cofusion_layout(root: str, n_frames: int, cfg):
    """The synthetic scene in the Co-Fusion layout at the configuration's
    size (``niceslam_tpu_torch.make_fixture_dataset``: ``colour/Color0NNN.png``,
    ``depth_noise/Depth0NNN.exr``, ``trajectories/gt-cam-0.txt``): the first
    frames of the synthetic reader's 60-frame trajectory (the arc cut to
    ``n_frames / 60`` of its 0.3). Returns the
    colour (uint8), depth and OpenGL poses written."""
    from niceslam_tpu_torch import make_fixture_dataset as fixture

    c = cfg.cam
    poses, colors, depths = fixture.write_layout("cofusion", root, n_frames, c.H, c.W, c.fx,
                                                 arc=0.3 * n_frames / 60, keep=True)
    return colors, depths, poses


def check_layout_reads_back(root: str, cfg, colors, depths, poses):
    """The Co-Fusion reader gives back what was written: colour as
    ``uint8 / 255``, depth bit for bit, poses within 1e-5; PNG and EXR
    decode times on this host."""
    from niceslam_tpu_torch.io import native_loader, png
    from niceslam_tpu_torch.io.datasets.base import get_dataset
    from niceslam_tpu_torch.io.datasets.cofusion import CoFusionReader

    reader = get_dataset(dataclasses.replace(cfg, data_input_folder=root))
    if not (isinstance(reader, CoFusionReader) and len(reader) == len(poses)):
        raise AssertionError(f"real data: reader {type(reader).__name__} of {len(reader)} frames")
    t0 = time.perf_counter()
    png.read_png_rgb(reader.color_paths[0])
    native_loader.read_exr(reader.depth_paths[0])
    log(f"real data: first decode with the host libraries' build "
        f"{time.perf_counter() - t0:.2f} s")
    for k in range(len(reader)):
        f = reader[k]
        if not np.array_equal(f.color, (colors[k] / 255.0).astype(np.float32)):
            raise AssertionError(f"real data: frame {k} colour differs from what was written")
        if not np.array_equal(f.depth, depths[k]):
            raise AssertionError(f"real data: frame {k} depth differs from what was written")
        err = float(np.abs(f.gt_c2w - poses[k]).max())
        if not err <= 1e-5:
            raise AssertionError(f"real data: frame {k} pose off by {err:.2e} (> 1e-5)")
    size = f"{cfg.cam.W}x{cfg.cam.H}"
    png_ms = [1e3 * t for t in timed_each(png.read_png_rgb, reader.color_paths)]
    exr_ms = [1e3 * t for t in timed_each(native_loader.read_exr, reader.depth_paths)]
    log(f"real data: {len(reader)} frames read back: colour exact, depth bit for bit, poses "
        f"within 1e-5; decode ms per frame on this host: PNG ({size} RGB, io/png.py) "
        f"median {statistics.median(png_ms):.2f} {[round(t, 2) for t in png_ms]}, EXR "
        f"({size} float ZIP, native/exr.cpp) median {statistics.median(exr_ms):.2f} "
        f"{[round(t, 2) for t in exr_ms]}")


def timed_each(fn, args):
    out = []
    for a in args:
        t0 = time.perf_counter()
        fn(a)
        out.append(time.perf_counter() - t0)
    return out


def write_pt_decoders(tmp: str):
    """``coarse.pt`` and ``middle_fine.pt`` under upstream names from the
    shipped ``.npz``; their import must equal the ``.npz`` load bit for bit."""
    from niceslam_tpu_torch.models.decoders import DecoderConfig, init_decoders
    from niceslam_tpu_torch.models.pretrained import (
        _flatten_with_keys, load_decoders_npz, load_pretrained_decoders, upstream_state_dict,
    )

    npz = os.path.join(ROOT, "models", "pretrained_decoders.npz")
    ref = load_decoders_npz(npz, init_decoders(DecoderConfig(), device="cuda"))
    sd = upstream_state_dict(ref)
    paths = (os.path.join(tmp, "coarse.pt"), os.path.join(tmp, "middle_fine.pt"))
    torch.save({k: v for k, v in sd.items() if k.startswith("coarse_")}, paths[0])
    torch.save({k: v for k, v in sd.items() if not k.startswith("coarse_")}, paths[1])
    got = load_pretrained_decoders(init_decoders(DecoderConfig(), device="cuda"), *paths)
    for lvl in ("coarse", "middle", "fine"):
        want = dict(_flatten_with_keys(ref[lvl]))
        have = dict(_flatten_with_keys(got[lvl]))
        if want.keys() != have.keys() or not all(
                have[k].is_cuda and torch.equal(have[k], want[k]) for k in want):
            raise AssertionError(f"real data: the .pt import of {lvl} differs from the .npz")
    log(f"real data: {len(sd)} upstream tensors in coarse.pt and middle_fine.pt; their import "
        f"equals the .npz load of coarse, middle and fine bit for bit")
    return paths


def run_cli(argv, tag: str, timeout: int):
    """The command line in a subprocess on the card, watched
    (:func:`envelope_cli`); returns its standard output lines, the kernels'
    launch counts, its wall seconds and its standard error."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_WATCHED, *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli [{tag}]: rc {proc.returncode}\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-6000:]}")
    launches = json.loads(next(line for line in proc.stderr.splitlines()[::-1]
                               if line.startswith("launches "))[len("launches "):])
    lines = proc.stdout.strip().splitlines()
    log(f"cli [{tag}]: rc 0 in {dt:.1f} s (process included); last line {lines[-1]}; "
        f"launches {launches}")
    check_route_launches(f"cli [{tag}]", "fused", launches)
    return lines, launches, dt, proc.stderr


def busy_shares(trace_path: str):
    """Per frame of a profiled run: (wall ms, kernel ms) from the trace. A
    frame runs from the start of its ``track`` range to the start of the
    next one (the last to the end of its last kernel or range); its kernel
    time is that of the kernels inside that window."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") in ("track", "map")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {e["name"] for e in kernels}
    missing = [n for n in K1_K2_NAMES if not any(n in k for k in names)]
    have = {e["name"] for e in ranges}
    if missing or have != {"track", "map"}:
        raise AssertionError(f"profile: the trace lacks {missing} or the track/map ranges "
                             f"(has {sorted(have)})")
    starts = sorted(float(e["ts"]) for e in ranges if e["name"] == "track")
    end = max(float(e["ts"]) + float(e["dur"]) for e in ranges + kernels)
    out = []
    for a, b in zip(starts, starts[1:] + [end]):
        busy = sum(max(0.0, min(b, float(e["ts"]) + float(e["dur"])) - max(a, float(e["ts"])))
                   for e in kernels)
        out.append(((b - a) / 1e3, busy / 1e3))
    return out, len(kernels)


def phase_real_data(frames: int = 6):
    """The real-data run path: the Co-Fusion layout written to disk at
    640x480, upstream ``.pt`` decoders, the command line on
    ``configs/cofusion.yaml`` (async, Adam tracking, BA) with render panels,
    a short profiled run, and ``render_image`` of the final map on the card
    against the CPU."""
    from niceslam_tpu_torch.config.schema import load_config
    from niceslam_tpu_torch.io import png
    from niceslam_tpu_torch.models.decoders import tree_map
    from niceslam_tpu_torch.render.renderer import render_image
    from niceslam_tpu_torch.slam.programs import Programs, pool_bytes, shared_programs
    from niceslam_tpu_torch.slam.system import NiceSLAM

    config = os.path.join(ROOT, "configs", "cofusion.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "room")
        overrides = {"data.input_folder": data, "sync_method": "async",
                     "tracking.method": "adam"}
        cfg = load_config(config, overrides=dict(overrides))
        t0 = time.perf_counter()
        colors, depths, poses = write_cofusion_layout(data, frames, cfg)
        log(f"real data: wrote {frames} frames of the Co-Fusion layout at "
            f"{cfg.cam.W}x{cfg.cam.H} in {time.perf_counter() - t0:.2f} s")
        check_layout_reads_back(data, cfg, colors, depths, poses)
        pt = write_pt_decoders(tmp)
        overrides.update(pretrained_coarse=pt[0], pretrained_middle_fine=pt[1])

        def argv(extra, **more):
            out = [config, *extra]
            for k, v in {**overrides, **more}.items():
                out += ["--set", f"{k}={v}"]
            return out

        # The run: every frame's panel from frame 2 on (vis_freq 2,
        # no_vis_on_first_frame), the last frame's map checkpointed.
        vis, ck = os.path.join(tmp, "vis"), os.path.join(tmp, "ck")
        lines, _, dt, _ = run_cli(argv(
            ["--frames", str(frames), "--log", os.path.join(tmp, "run.jsonl"),
             "--trajectory", os.path.join(tmp, "traj.npy"), "--vis-dir", vis,
             "--ckpt-dir", ck], **{"mapping.vis_freq": 2, "mapping.ckpt_freq": frames - 1}),
            "cofusion layout", timeout=400)
        last = json.loads(lines[-1])
        traj = np.load(os.path.join(tmp, "traj.npy"))
        if not (set(last) == {"frames", "fps_avg", "ate_rmse_cm"} and last["frames"] == frames
                and traj.shape == (frames, 4, 4) and np.isfinite(traj).all()):
            raise AssertionError(f"cli [cofusion layout]: last line {last}, trajectory "
                                 f"{traj.shape}")
        err_cm = 100.0 * np.linalg.norm(traj[:, :3, 3] - np.stack(poses)[:, :3, 3], axis=1)
        lost = lost_track(last["ate_rmse_cm"], err_cm)
        log(f"cli [cofusion layout]: position error per frame (cm) "
            f"{[round(float(e), 2) for e in err_cm]}, ATE {last['ate_rmse_cm']} cm")
        if lost:
            raise AssertionError(f"cli [cofusion layout]: the track is lost: {lost}")
        want = [f"frame_{k:06d}.png" for k in range(2, frames, 2)]
        if sorted(os.listdir(vis)) != want:
            raise AssertionError(f"cli [cofusion layout]: panels {sorted(os.listdir(vis))}, "
                                 f"want {want}")
        for name in want:
            panel = png.read_png_rgb(os.path.join(vis, name))
            if panel.shape != (cfg.cam.H, 5 * cfg.cam.W, 3) or panel.min() == panel.max():
                raise AssertionError(f"cli [cofusion layout]: panel {name} {panel.shape}, "
                                     f"values {panel.min()}-{panel.max()}")
        log(f"cli [cofusion layout]: {len(want)} panels {want}, each {cfg.cam.H} x "
            f"{5 * cfg.cam.W} x 3 and not of one value")

        # A short profiled run (2 frames, iters_first 50, no color
        # refinement, so that the trace stays small).
        prof = os.path.join(tmp, "prof")
        run_cli(argv(["--frames", "2", "--log", os.path.join(tmp, "prof.jsonl"),
                      "--profile-dir", prof],
                     **{"mapping.iters_first": 50, "mapping.color_refine": "false"}),
                "profile", timeout=300)
        trace_path = os.path.join(prof, "trace.json")
        shares, n_kern = busy_shares(trace_path)
        log(f"profile: trace {os.path.getsize(trace_path) / 2**20:.1f} MiB, {n_kern} kernels, "
            f"with the track and map ranges and {', '.join(K1_K2_NAMES)}")
        for k, (wall, busy) in enumerate(shares):
            log(f"profile: frame {k}: wall {wall:.1f} ms, kernel time {busy:.1f} ms, "
                f"busy share {busy / wall:.4f}")

        # render_image of the final map at the last pose: the whole image on
        # the card, timed; a 32-row band at full width (rows 224-255: two
        # whole chunks, the same rays as in the whole image) on the card and
        # on the CPU.
        slam = NiceSLAM(load_config(config, overrides=dict(overrides)))
        ckpt = os.path.join(ck, f"frame_{frames - 1:06d}")
        if slam.restore(ckpt) != frames:
            raise AssertionError(f"render: {ckpt} is not the last frame's")
        st, intr = slam.state, slam.intr
        c2w = torch.as_tensor(slam.est_c2w[-1], dtype=torch.float32, device="cuda")
        depth = torch.from_numpy(depths[-1]).cuda()
        fields = ("rgb", "depth", "depth_var", "weights")
        ways = {}
        for way, progs in (("graphed", None), ("eager", Programs(capture=False))):
            set_launches({})
            secs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = render_image(st.decoders, st.grids, slam.bounds, slam.scene_bound, intr,
                                   c2w, depth, "color", slam.rcfg, programs=progs)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            launched = all_launches()
            check_route_launches(f"render_image {way}", "fused", launched, forward_only=True)
            ways[way] = (out, secs, launched["trilerp_fwd"] // len(secs))
        out = ways["graphed"][0]
        if not (out.rgb.shape == (intr.H, intr.W, 3) and bool(torch.isfinite(out.rgb).all())
                and bool(torch.isfinite(out.depth).all())):
            raise AssertionError(f"render: rgb {tuple(out.rgb.shape)} or not finite")
        same = [k for k in fields if torch.equal(getattr(out, k), getattr(ways["eager"][0], k))]
        if same != list(fields) or ways["graphed"][2] != ways["eager"][2]:
            raise AssertionError(f"render: graphed and eager equal only in {same}, K1 per "
                                 f"image {ways['graphed'][2]} / {ways['eager'][2]}")
        band = intr._replace(H=32, cy=intr.cy - 224)

        def band_render(dev):
            to = lambda t: t.to(dev)  # noqa: E731
            o = render_image(tree_map(to, st.decoders), tree_map(to, st.grids),
                             tree_map(to, slam.bounds), to(slam.scene_bound), band,
                             to(c2w), to(depth[224:256]), "color", slam.rcfg)
            return {k: getattr(o, k).cpu() for k in ("rgb", "depth", "depth_var", "weights")}

        gpu, t0 = band_render("cuda"), time.perf_counter()
        cpu = band_render("cpu")
        t_cpu = time.perf_counter() - t0
        for k in cpu:
            rel = max_err(gpu[k], cpu[k]) / max(float(cpu[k].abs().max()), 1e-12)
            log(f"render: band {k:<10} card vs CPU max rel err {rel:.3e}")
            if not rel <= 1e-4:
                raise AssertionError(f"render: {k} card vs CPU differs by {rel:.3e} (> 1e-4)")
        for way, (_, secs, k1) in ways.items():
            log(f"render: render_image {intr.W}x{intr.H} on the card, {way}: seconds per image "
                f"{[round(t, 4) for t in secs]} (the first includes warm-up"
                f"{' and the capture' if way == 'graphed' else ''}), K1 launches {k1} per image")
        for c in shared_programs("cuda").captures:
            if c.signature.startswith("render_chunk"):
                log(f"render: captured {c.signature}: {c.seconds:.3f} s, {c.nodes} nodes, "
                    f"launches per replay {c.launches}")
        log(f"render: graphed and eager images equal bit for bit in {', '.join(fields)}; the "
            f"32-row band on the CPU {t_cpu:.2f} s; the card's graph pool "
            f"{pool_bytes() / 2**20:.1f} MiB reserved")
        del slam, out
    return dt


# ---------------------------------------------------------------- phase 11
# Ranks of the multi-rank phase: spawned processes that share cuda:0 and
# meet over gloo (NCCL refuses two ranks on one card). Each runs a list of
# jobs and writes its results, with its seconds, peak device memory and the
# time it spent in all_reduce, to a JSON file.
RANK_TIMEOUT_S = 180
# Frame 0's mapping iterations of the 2-rank command line on the shipped
# mesh (configs/apartment_multihost.yaml: 4096 rays a row, a window of 12).
KF_CLI_ITERS_FIRST = 300
# This rank's host seconds in all_reduce (synchronised before and after
# each call) and its number of calls.
ALL_REDUCE = {"s": 0.0, "calls": 0}


def _rank_main(rank, world, init, jobs, out_dir):
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    try:
        import niceslam_tpu_torch  # noqa: F401  (sets TF32 off)

        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{init}", world_size=world,
                                rank=rank, timeout=timedelta(seconds=RANK_TIMEOUT_S))
        plain_all_reduce = dist.all_reduce

        def timed_all_reduce(*a, **kw):
            torch.cuda.synchronize()  # charge the collective, not the kernels before it
            t0 = time.perf_counter()
            out = plain_all_reduce(*a, **kw)
            torch.cuda.synchronize()
            ALL_REDUCE["s"] += time.perf_counter() - t0
            ALL_REDUCE["calls"] += 1
            return out

        dist.all_reduce = timed_all_reduce
        results = []
        for name, kw in jobs:
            ALL_REDUCE.update(s=0.0, calls=0)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = RANK_JOBS[name](rank=rank, **kw)
            torch.cuda.synchronize()
            res.update(seconds=time.perf_counter() - t0, all_reduce_s=ALL_REDUCE["s"],
                       all_reduce_calls=ALL_REDUCE["calls"],
                       peak_mib=torch.cuda.max_memory_allocated() / 2**20)
            results.append(res)
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_rank_jobs(world: int, jobs, deadline_s: float = 240.0):
    """Run ``jobs`` (``[(name, kwargs)]``) on ``world`` ranks on cuda:0
    (``runtime.spawn_ranks``); returns ``results[rank][job]``. A failed rank
    or the deadline kills them all and raises with the ranks' errors."""
    from niceslam_tpu_torch.parallel.runtime import spawn_ranks

    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "rendezvous")
        try:
            spawn_ranks(_rank_main, range(world), (world, init, jobs, tmp), deadline_s)
        except RuntimeError as e:
            errs = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp))
                    if f.endswith(".err")]
            raise AssertionError(f"{e}\n" + "\n".join(errs)) from None
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out


def _halo_job(shape, route, n_map, n_pts=48_000, seed=0, rank=0):
    """The halo sampler on this rank's block of a grid of ``shape`` padded
    to ``n_map`` rows (``pad_grid_for_sharding``), against the unsharded
    sampler on the whole grid, both on the card: the launches of the
    sharded call only, its errors and times."""
    from niceslam_tpu_torch.grid.shard import block_of, sample_grid_sharded
    from niceslam_tpu_torch.ops.trilinear import sample_grid, sampler_route
    from niceslam_tpu_torch.parallel.mesh import make_mesh
    from niceslam_tpu_torch.parallel.sharded_mapper import pad_grid_for_sharding

    g = torch.Generator().manual_seed(seed)
    bound = torch.tensor([[-2.0, 2.0], [-1.5, 1.5], [-3.0, 3.0]])
    grid, bound = pad_grid_for_sharding(torch.randn(shape, generator=g), bound, n_map)
    pts = torch.rand((n_pts, 3), generator=g) * (bound[:, 1] - bound[:, 0]) + bound[:, 0]
    pts[:64, 2] = bound[2, 1]  # vz == nz - 1: the border start
    ct = torch.randn((n_pts, shape[-1]), generator=g)
    grid, bound, pts, ct = (t.cuda() for t in (grid, bound, pts, ct))
    mesh = make_mesh(n_map, 1)

    def run(sharded):
        gr = (block_of(grid, mesh) if sharded else grid).clone().requires_grad_(True)
        p = pts.clone().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sampler_route(route):
            out = (sample_grid_sharded(gr, p, bound, mesh) if sharded
                   else sample_grid(gr, p, bound))
            torch.sum(out * ct).backward()
        torch.cuda.synchronize()
        return out.detach(), gr.grad, p.grad, (time.perf_counter() - t0) * 1e3

    run(False)  # warm both
    run(True)
    want, want_g, want_p, ms_plain = run(False)
    set_launches({})
    out, d_blk, d_p, ms = run(True)
    launches = all_launches()
    check_route_launches(f"halo {route} map={n_map} {tuple(shape)}", route, launches)
    err_g = max_err(d_blk, block_of(want_g, mesh))
    err_p = max_err(d_p, want_p)
    if not torch.equal(out, want) or err_g > 2e-5 or err_p > 2e-5:
        raise AssertionError(f"halo {route} map={n_map} {tuple(shape)}: values "
                             f"{'equal' if torch.equal(out, want) else max_err(out, want)}, "
                             f"grid grad {err_g:.3e}, point grad {err_p:.3e}")
    return dict(job="halo", route=route, n_map=n_map, shape=list(shape), zb=int(d_blk.shape[0]),
                launches=launches, err_grid=err_g, err_pts=err_p, ms=ms, ms_unsharded=ms_plain)


def pass_state(pp, grids=None) -> dict:
    """A pass's parameters: the (assembled) grids, cameras and decoders."""
    from niceslam_tpu_torch.models.decoders import tree_leaves

    return dict(grids={k: v.detach().clone() for k, v in (grids or pp.params["grids"]).items()},
                cams=pp.params["cams"].detach().clone(),
                decoders=[t.detach().clone() for t in tree_leaves(pp.params["decoders"])])


def state_errs(a: dict, b: dict) -> dict:
    out = {f"grid/{k}": max_err(v, b["grids"][k]) for k, v in a["grids"].items()}
    out["cams"] = max_err(a["cams"], b["cams"])
    out["decoders"] = max([max_err(x, y) for x, y in zip(a["decoders"], b["decoders"])],
                          default=0.0)
    return out


@contextlib.contextmanager
def first_grads():
    """Keep copies of the gradients that the first row of a pass steps on
    (summed over the kf group, on a mesh): wraps ``mapper.mapping_step``,
    which every eager iteration calls. Yields the list that receives
    them."""
    from niceslam_tpu_torch.slam import mapper

    kept, plain = [], mapper.mapping_step

    def hook(pp, opt_state, tab, inp, loss, grads, zero):
        if not kept:
            kept.append([None if g is None else g.detach().clone() for g in grads])
        return plain(pp, opt_state, tab, inp, loss, grads, zero)

    mapper.mapping_step = hook
    try:
        yield kept
    finally:
        mapper.mapping_step = plain


def grad_errs(pp, got, want, mesh) -> dict:
    """Per kind of leaf, the largest ``max|got - want| / max|want|`` of the
    first row's gradients (``want`` of the whole grids, ``got`` of this
    rank's blocks)."""
    from niceslam_tpu_torch.grid.shard import block_of

    out = {}
    for (kind, _), g, w in zip(pp.groups, got, want):
        if g is None or w is None:
            if (g is None) != (w is None):
                raise AssertionError(f"first-row gradients: {kind} None on one side only")
            continue
        if kind == "grids":
            w = block_of(w, mesh)
        out[kind] = max(out.get(kind, 0.0), max_err(g, w) / max(float(w.abs().max()), 1e-30))
    return out


def _timed(fn):
    """``(fn(), host ms, all_reduce ms, all_reduce calls)``, synchronised."""
    torch.cuda.synchronize()
    ar0, calls0, t0 = ALL_REDUCE["s"], ALL_REDUCE["calls"], time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, 1e3 * (time.perf_counter() - t0), 1e3 * (ALL_REDUCE["s"] - ar0),
            ALL_REDUCE["calls"] - calls0)


def _mapping_job(path, n_map, n_kf, which, route="fused", rank=0):
    """The sharded ``run_schedule`` of pass ``which`` saved at ``path``, on
    ``route``; returns its losses, its first row's summed gradients and its
    final parameters against the unsharded pass saved there. With one map
    block the system's kf-sharded program too, graphed (its second run,
    after the capture), which must equal the eager pass bit for bit,
    launches included; both timed, with their all_reduce time. A pass with
    the importance pass is held against the unsharded one on its route in
    its first row only (its loss and summed gradients, and the map
    program's first loss): both start from the same parameters there, but
    after the first step the two place the last importance sample of a few
    rays a bin apart (``tests/test_torch_importance.py``), which the
    free-space term supervises, so the later rows are printed."""
    from niceslam_tpu_torch.ops.trilinear import sampler_route

    with sampler_route(route):
        return _mapping_job_on_route(path, n_map, n_kf, which, route, rank)


def _mapping_job_on_route(path, n_map, n_kf, which, route, rank):
    from niceslam_tpu_torch.models.decoders import tree_leaves
    from niceslam_tpu_torch.parallel.mesh import make_mesh
    from niceslam_tpu_torch.parallel.runtime import MapKfRuntime
    from niceslam_tpu_torch.slam import programs
    from niceslam_tpu_torch.slam.mapper import init_opt_state, make_pass_params, stack_draws

    a = torch.load(path, map_location="cuda:0", weights_only=False)
    sched, ref = a["passes"][which]
    rt = MapKfRuntime(make_mesh(n_map, n_kf), "cuda:0", "gloo")
    pp = make_pass_params(rt.split(a["grids"]), a["decoders"], a["cams"], a["pcfg"])
    opt = init_opt_state(pp)
    set_launches({})
    with first_grads() as kept:
        losses, ms, ar_ms, _ = _timed(lambda: rt.run_schedule(
            pp, opt, sched, rt.split(a["masks"]), a["bounds"], a["scene_bound"], a["intr"],
            a["colors"], a["depths"], a["valid"], a["fixed"], a["pcfg"], a["rcfg"],
            pixels=a["pixels"]))
    launches = all_launches()
    check_route_launches(f"sharded pass {n_map}x{n_kf}", route, launches)
    grids = rt.assemble(pp.params["grids"])
    lo, ref_lo = losses.cpu(), ref["losses"].cpu()
    imp = a["rcfg"].n_importance

    def loss_errs(got):
        """Each row's loss error over its tolerance (2e-4)."""
        return (got - ref_lo).abs() / (2e-4 + 2e-4 * ref_lo.abs())

    out = dict(job="mapping", n_map=n_map, n_kf=n_kf, launches=launches, route=route,
               importance=imp, diffs=state_errs(pass_state(pp, grids), ref),
               held=n_kf == 1 and not imp,
               grad_err=grad_errs(pp, kept[0], ref["grads"], rt.mesh),
               loss_first_equal=bool(lo[0] == ref_lo[0]),
               loss_err=float(loss_errs(lo).max()), loss_first_err=float(loss_errs(lo)[0]),
               digest=digest(np.zeros((1, 4, 4), np.float32), grids),
               iters=int(len(lo)), ms=ms, all_reduce_ms=ar_ms)
    blocks = (lambda t: t) if n_map == 1 else rt.split
    kf = rt.kf_slice(a["pcfg"].n_pixels)
    draws = stack_draws([a["pixels"][it] for it in range(len(sched))], "cuda:0")

    def program(capture):
        progs = programs.Programs(capture=capture)
        prog = progs.map_program(
            (a["cams"].shape[0], False, True), "cuda:0", a["pcfg"], a["intr"], a["rcfg"],
            blocks(a["grids"]), a["decoders"], a["cams"], len(sched), kf=kf)
        return progs, lambda: prog.run(
            blocks(a["grids"]), a["decoders"], a["cams"], blocks(a["masks"]), a["bounds"],
            a["scene_bound"], a["colors"], a["depths"], a["valid"], a["fixed"], sched, draws)

    if n_map == 1:
        # The kf program's reference is the eager pass, bit for bit.
        want = (losses, pp.params["grids"], pp.params["decoders"], pp.params["cams"])
        want_launches, ref_ms, ref_ar_ms = launches, ms, ar_ms
    else:
        # The map program's reference is its own bodies run eagerly, bit for
        # bit; the eager pass adds the same gradient terms in another order.
        _, eager = program(False)
        set_launches({})
        want, ref_ms, ref_ar_ms, _ = _timed(eager)
        want_launches = all_launches()
        check_route_launches(f"map program {n_map}x{n_kf}", route, want_launches)
        lo_p = want[3].cpu()
        out.update(
            program_loss_err=float(loss_errs(lo_p).max()),
            program_loss_first_err=float(loss_errs(lo_p)[0]),
            program_diffs=state_errs(dict(grids=rt.assemble(want[0]), cams=want[2],
                                          decoders=tree_leaves(want[1])), ref))
        want = (want[3], want[0], want[1], want[2])
    progs, graphed = program(True)
    _, ms_first, _, _ = _timed(graphed)  # captures the graphs of each stage
    set_launches({})
    (g, d, c, glo), ms_g, ar_ms_g, calls = _timed(graphed)
    glaunches = all_launches()
    w_lo, w_g, w_d, w_c = want
    equal = (torch.equal(glo, w_lo) and torch.equal(c, w_c)
             and all(torch.equal(g[k], v) for k, v in w_g.items())
             and all(torch.equal(x, y) for x, y in zip(tree_leaves(d), tree_leaves(w_d))))
    # The segment plan's collectives.
    per_row = 1 if n_map == 1 else 3 + (n_kf > 1) + (imp > 0)
    if not equal or glaunches != want_launches or calls != per_row * len(sched):
        raise AssertionError(
            f"{'kf' if n_map == 1 else 'map'} program {n_map}x{n_kf} rank {rank}: graphed "
            f"equal to its reference {equal}, launches {glaunches} against {want_launches}, "
            f"{calls} all_reduces for {len(sched)} rows")
    out.update(graphed_ms=ms_g, graphed_all_reduce_ms=ar_ms_g, graphed_first_ms=ms_first,
               graphed_all_reduce_calls=calls, reference_ms=ref_ms,
               reference_all_reduce_ms=ref_ar_ms,
               captures=[[cp.signature, cp.seconds, cp.nodes] for cp in progs.captures],
               graphed_equal=equal, pool_mib=programs.pool_bytes() / 2**20)
    return out


def _system_job(frames: int, iters_first: int, n_map: int = 1, n_kf: int = 2,
                importance: bool = False, cut=None, rank=0):
    """``NiceSLAM`` on the bench configuration (with ``importance`` at
    ``N_IMPORTANCE``) attached to this rank of an ``n_map x n_kf`` mesh,
    ``frames`` frames graphed (after ``precompile``), then with
    ``capture=False``; with ``cut`` (frames, ``iters_first``) the eager run
    is that cut, beside a graphed run of it (``graphed cut``): each run's
    per-frame seconds, digest, ATE, the process's graph pool and peak
    memory."""
    from niceslam_tpu_torch.config.schema import ParallelConfig
    from niceslam_tpu_torch.io.datasets.synthetic import SyntheticBoxReader
    from niceslam_tpu_torch.parallel.mesh import make_mesh
    from niceslam_tpu_torch.parallel.runtime import MapKfRuntime
    from niceslam_tpu_torch.slam import programs
    from niceslam_tpu_torch.slam.system import NiceSLAM

    cfg = bench_config(sync="strict")
    cfg = dataclasses.replace(cfg, parallel=ParallelConfig(n_processes=2, map=n_map, kf=n_kf))
    if importance:
        cfg = with_importance(cfg)
    rt = MapKfRuntime(make_mesh(n_map, n_kf), "cuda:0", "gloo", rank, 2)
    out = dict(job="system", mesh=f"{n_map}x{n_kf}{f' imp{N_IMPORTANCE}' if importance else ''}")
    runs = [("graphed", None, frames, iters_first)]
    if cut is not None:
        runs.append(("graphed cut", None, *cut))
    runs.append(("eager", False, *(cut or (frames, iters_first))))
    for tag, capture, n, first_iters in runs:
        run_cfg = dataclasses.replace(
            cfg, mapping=dataclasses.replace(cfg.mapping, iters_first=first_iters))
        reader = SyntheticBoxReader(run_cfg, n_frames=36)
        slam = NiceSLAM(run_cfg, reader=reader, seed=0, device="cuda:0", capture=capture)
        slam.n_imgs = n
        rt.attach(slam)
        torch.cuda.reset_peak_memory_stats()
        set_launches({})
        _, pre_ms, _, pre_calls = _timed(slam.precompile)
        dts, ars = [], []
        for k in range(n):
            _, ms, ar_ms, _ = _timed(lambda: slam.step(reader[k]))
            dts.append(ms / 1e3)
            ars.append(ar_ms / 1e3)
        res = slam.result()
        poses = np.stack(res["est_c2w"])
        kinds = sorted({cp.signature.split()[0] for cp in slam._programs.captures})
        out[tag] = dict(dts=dts, all_reduce_s=ars, precompile_s=pre_ms / 1e3,
                        precompile_all_reduces=pre_calls, captures=len(slam._programs.captures),
                        kinds=kinds, digest=digest(poses, slam.state.grids),
                        ate_cm=100.0 * res["ate_rmse"], launches=all_launches(),
                        finite=bool(np.isfinite(poses).all()),
                        pool_mib=programs.pool_bytes() / 2**20,
                        peak_mib=torch.cuda.max_memory_allocated() / 2**20)
        del slam
        gc.collect()
    return out


RANK_JOBS = {"halo": _halo_job, "mapping": _mapping_job, "system": _system_job}


def mapping_pass_payload(cfg, run: dict, path: str, iters, routes=("fused",)):
    """Full-width (``mapping.pixels``) mapping passes of frame 0's map
    (``run``'s grids after frame 0, padded for map = 2, its decoders): a
    window of frames 0 and 1 at their true poses, BA on frame 1, the
    system's own pass configuration (the shipped decoders stay frozen),
    the staged plan of each of ``iters`` iterations on draws made here.
    Runs them unsharded on the card under each of ``routes`` (passes in
    that order, each route's in the order of ``iters``) and saves them,
    their losses and final states to ``path``; returns the last one's
    seconds."""
    from niceslam_tpu_torch.core.pose import tensor_from_camera
    from niceslam_tpu_torch.ops.trilinear import sampler_route
    from niceslam_tpu_torch.parallel.sharded_mapper import pad_grid_for_sharding
    from niceslam_tpu_torch.slam import mapper

    slam, reader = new_slam(cfg, 2, 0)
    bounds, grids = {}, {}
    for lvl, g in run["kept0"].items():
        grids[lvl], bounds[lvl] = pad_grid_for_sharding(g.cuda(), slam.bounds[lvl], 2)
    f0, f1 = reader[0], reader[1]
    colors = torch.stack([torch.as_tensor(f.color) for f in (f0, f1, f0)]).cuda()
    depths = torch.stack([torch.as_tensor(f.depth) for f in (f0, f1, f0)]).cuda()
    cams = tensor_from_camera(torch.as_tensor(np.stack([f0.gt_c2w, f1.gt_c2w, f0.gt_c2w]),
                                              dtype=torch.float32).cuda())
    valid, fixed = np.array([True, True, False]), np.array([True, False, True])
    m = cfg.mapping
    mcfg = slam._make_mcfg(True, False, m.lr_factor)  # as the system's pass, with BA
    pcfg = slam._make_pcfg(mcfg)
    scheds = [mapper.schedule_arrays(mapper.build_stage_plan(
        n, m.middle_iter_ratio, m.fine_iter_ratio, m.stage_lr), mcfg) for n in iters]
    gen = torch.Generator(device="cuda").manual_seed(7)
    vidx = torch.tensor([0, 1], device="cuda")
    pixels = {it: mapper.draw_mapping_pixels(gen, vidx, m.pixels, slam.intr, "cuda")
              for it in range(max(iters))}
    masks = {lvl: torch.ones(g.shape[:3] + (1,), device="cuda") for lvl, g in grids.items()}
    a = dict(grids=grids, masks=masks, decoders=slam.state.decoders, cams=cams, bounds=bounds,
             scene_bound=slam.scene_bound, intr=slam.intr, colors=colors, depths=depths,
             valid=valid, fixed=fixed, pcfg=pcfg, rcfg=slam.rcfg, pixels=pixels)
    a["passes"] = []
    for route, sched in ((r, s) for r in routes for s in scheds):
        pp = mapper.make_pass_params(grids, slam.state.decoders, cams, pcfg)
        opt = mapper.init_opt_state(pp)
        with first_grads() as kept, sampler_route(route):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = mapper.run_schedule(pp, opt, sched, masks, bounds, slam.scene_bound,
                                         slam.intr, colors, depths, valid, fixed, pcfg,
                                         slam.rcfg, pixels=pixels)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        a["passes"].append((sched, dict(pass_state(pp), losses=losses, grads=kept[0])))
        log(f"multi: the unsharded pass [{route}] ({len(sched)} iterations x {m.pixels} px, "
            f"Z {[g.shape[0] for g in grids.values()]}): {dt:.3f} s, losses "
            f"{losses[0].item():.6f} -> {losses[-1].item():.6f}")
    torch.save(a, path)
    return dt


SYSTEM_RUNS = ("graphed", "graphed cut", "eager")
# The graphed runtime-attached systems' digests at the smoke's own 8 frames
# and mapping.iters_first 1500, each equal to the eager run's of the same
# frames when the smoke still ran those eagerly; their eager runs are now
# the cut (CUT) only, so the 8-frame graphed runs are held to these.
GRAPHED_SYSTEM_DIGESTS = {
    "1x2": "0d53a360d19cd76a3b6c6c24a75843bb238f5450",
    "2x1": "c3b496e537a9a4b50ad3ac7fa2a98e24cc37650d",
}
GRAPHED_SYSTEM_AT = (8, 1500)


def log_system_job(rank: int, r: dict):
    """One rank's runtime-attached system, graphed and eager."""
    for tag in (t for t in SYSTEM_RUNS if t in r):
        x = r[tag]
        log(f"multi system {r['mesh']} rank {rank} [{tag}]: precompile {x['precompile_s']:.3f} s "
            f"({x['captures']} graphs: {x['kinds']}, {x['precompile_all_reduces']} "
            f"all_reduces), per-frame seconds {[round(d, 4) for d in x['dts']]}, after "
            f"frame 0 {sum(x['dts'][1:]):.3f} s, all_reduce per frame "
            f"{[round(d, 4) for d in x['all_reduce_s']]}, ATE {x['ate_cm']:.4f} cm, sha1 "
            f"{x['digest']}, launches {x['launches']}, graph pool {x['pool_mib']:.1f} MiB, "
            f"peak {x['peak_mib']:.1f} MiB")


def check_system_job(rows, at):
    """Every rank's graphed run of the eager run's frames (the ``graphed
    cut`` where there is one) gives the eager run's digest, every run's
    ranks agree, the graphed run beside a cut gives its recorded digest
    (``GRAPHED_SYSTEM_DIGESTS``) where it ran at ``GRAPHED_SYSTEM_AT``
    (``at``: its frames and mapping.iters_first), no track is lost, the
    graphed run replayed the solve, keyframe and mapping graphs, and
    ``precompile`` issued no collective."""
    tags = [t for t in SYSTEM_RUNS if t in rows[0]]
    ref = "graphed cut" if "graphed cut" in tags else "graphed"
    digests = {t: {r[t]["digest"] for r in rows} for t in tags}
    g = rows[0]["graphed"]
    mesh = rows[0]["mesh"]
    problems = []
    if any(len(d) != 1 for d in digests.values()) or digests[ref] != digests["eager"]:
        problems.append(f"digests {digests}")
    if (ref != "graphed" and tuple(at) == GRAPHED_SYSTEM_AT
            and digests["graphed"] != {GRAPHED_SYSTEM_DIGESTS[mesh]}):
        problems.append(f"the graphed {at[0]}-frame digests {digests['graphed']}, recorded "
                        f"{GRAPHED_SYSTEM_DIGESTS[mesh]}")
    if any(r[t]["precompile_all_reduces"] for r in rows for t in tags):
        problems.append("precompile issued a collective")
    if not {"map", "track", *KEYFRAME_PROGRAMS} <= set(g["kinds"]):
        problems.append(f"graphs captured: {g['kinds']}")
    if not all(r[t]["finite"] and r[t]["ate_cm"] < ATE_LOST_CM for r in rows for t in tags):
        problems.append(f"lost track: {[r[t]['ate_cm'] for r in rows for t in tags]}")
    if problems:
        raise AssertionError(f"multi system {mesh}: {problems}")
    e = rows[0]["eager"]
    held = " (the recorded digest)" if tuple(at) == GRAPHED_SYSTEM_AT else ""
    cut = (f"graphed {len(g['dts'])} frames sha1 {digests['graphed'].pop()} on every "
           f"rank{held}; "
           f"the cut ({len(e['dts'])} frames) " if ref != "graphed" else "")
    log(f"multi system {mesh}: {cut}graphed and eager equal on every rank (sha1 "
        f"{digests['eager'].pop()}); frame 0 graphed {rows[0][ref]['dts'][0]:.3f} s, eager "
        f"{e['dts'][0]:.3f} s; after frame 0 graphed {sum(rows[0][ref]['dts'][1:]):.3f} s, eager "
        f"{sum(e['dts'][1:]):.3f} s; ATE {g['ate_cm']:.4f} cm (rank 0)")


def phase_multi(cfg, run: dict, want_digest: str, iters=(4, 12), cli_frames: int = 5):
    """Phase 11: the multi-rank runtime on the one card (see the module
    docstring). Each mapping pass (``iters``: every stage once with middle
    twice, and 12) is held in its losses and its first row's summed
    gradients, and with one kf rank in its final parameters too. With kf
    slices the float sum of two exact K2 sums loses the low bits of a
    gradient that nearly cancels, and Adam's per-element normalisation
    turns that into a step of up to the learning rate, so those parameters
    are printed, not held (``PERF.md``, section 6)."""
    shapes = main_path_grid_shapes(cfg)
    # (a) the halo sampler, then one mapping pass sharded three ways.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pass.pt")
        dt_plain = mapping_pass_payload(cfg, run, path, iters)
        # The longer pass again with the importance pass, on the map meshes.
        imp_path = os.path.join(tmp, "pass_importance.pt")
        mapping_pass_payload(with_importance(cfg), run, imp_path, iters[-1:],
                             routes=tuple(ROUTE_KERNELS))
        for world, meshes in ((2, [(2, 1), (1, 2)]), (4, [(2, 2)])):
            jobs = [("halo", dict(shape=list(shapes[lvl]), route=route, n_map=world))
                    for lvl in ("fine", "middle") for route in ROUTE_KERNELS]
            jobs += [("mapping", dict(path=path, n_map=m, n_kf=k, which=w))
                     for m, k in meshes for w in range(len(iters))]
            jobs += [("mapping", dict(path=imp_path, n_map=m, n_kf=k, which=w, route=route))
                     for m, k in meshes if m > 1 for w, route in enumerate(ROUTE_KERNELS)]
            if world == 2:
                # Eager systems at 8 frames took ~200 s of the smoke: the
                # graphed-against-eager check runs on the cut.
                jobs += [("system", dict(frames=run["n_frames"], n_map=m, n_kf=k,
                                         iters_first=cfg.mapping.iters_first, cut=list(CUT)))
                         for m, k in ((1, 2), (2, 1))]
                frames, iters_first = CUT
                jobs.append(("system", dict(frames=frames, n_map=2, n_kf=1, importance=True,
                                            iters_first=iters_first)))
            t0 = time.perf_counter()
            res = run_rank_jobs(world, jobs, deadline_s=900.0 if world == 2 else 300.0)
            log(f"multi: {world} ranks on cuda:0 over gloo, {time.perf_counter() - t0:.1f} s "
                f"(processes included)")
            for rank, rows in enumerate(res):
                for r in rows:
                    if r["job"] == "system":
                        log_system_job(rank, r)
                        continue
                    what = (f"halo {r['route']} {r['shape']} map={r['n_map']} zb={r['zb']}"
                            if r["job"] == "halo" else
                            f"mapping {r['n_map']}x{r['n_kf']} [{r['route']}]"
                            + (f" imp{r['importance']}" if r["importance"] else ""))
                    extra = (f"{r['ms']:.2f} ms (unsharded {r['ms_unsharded']:.2f}), err grid "
                             f"{r['err_grid']:.3e} pts {r['err_pts']:.3e}"
                             if r["job"] == "halo" else
                             f"loss err/tol {r['loss_err']:.3f} (first row "
                             f"{r['loss_first_err']:.3f}), first loss bit-equal "
                             f"{r['loss_first_equal']}, {r['iters']} iterations, first-row "
                             f"gradients max rel err {r['grad_err']}, parameters max diffs "
                             f"{r['diffs']}{'' if r['held'] else ' (printed)'}, all_reduce "
                             f"{1e3 * r['all_reduce_s'] / r['iters']:.2f} ms per iteration")
                    log(f"multi rank {rank}/{world}: {what}: {r['seconds']:.3f} s, peak "
                        f"{r['peak_mib']:.1f} MiB, all_reduce {r['all_reduce_s'] * 1e3:.1f} ms "
                        f"in {r['all_reduce_calls']} calls; launches {r['launches']}; {extra}")
                    if "graphed_ms" in r:
                        n = r["iters"]
                        kind, ref = (("kf program", "the eager pass") if r["n_map"] == 1 else
                                     ("map program", "its bodies with capture=False"))
                        log(f"multi rank {rank}/{world}: {what} as the system's {kind}, "
                            f"graphed: {r['graphed_ms'] / n:.3f} ms per iteration (all_reduce "
                            f"{r['graphed_all_reduce_ms'] / n:.3f} ms in "
                            f"{r['graphed_all_reduce_calls'] / n:g} calls), reference "
                            f"{r['reference_ms'] / n:.3f} (all_reduce "
                            f"{r['reference_all_reduce_ms'] / n:.3f}), the eager pass "
                            f"{r['ms'] / n:.3f} (all_reduce {r['all_reduce_ms'] / n:.3f}), "
                            f"first graphed run with its captures {r['graphed_first_ms']:.1f} "
                            f"ms; bit-equal to {ref}, launches included; graph pool "
                            f"{r['pool_mib']:.1f} MiB, peak {r['peak_mib']:.1f} MiB; "
                            f"{len(r['captures'])} captures {r['captures']}")
                    if "program_diffs" in r:
                        log(f"multi rank {rank}/{world}: {what} map program against the "
                            f"unsharded pass: loss err/tol {r['program_loss_err']:.3f} "
                            f"(first row {r['program_loss_first_err']:.3f}), "
                            f"parameters max diffs {r['program_diffs']}"
                            f"{'' if r['held'] else ' (printed)'}")
                    if r["job"] == "mapping":
                        bad = {k: v for k, v in r["diffs"].items()
                               if r["held"] and not v <= 2e-5}
                        bad.update({f"program {k}": v
                                    for k, v in r.get("program_diffs", {}).items()
                                    if r["held"] and not v <= 2e-5})
                        # With the importance pass the first row only (the
                        # job's docstring).
                        rows = "first_" if r["importance"] else ""
                        if r.get(f"program_loss_{rows}err", 0.0) > 1.0:
                            bad["program losses"] = r[f"program_loss_{rows}err"]
                        bad.update({f"gradient {k}": v for k, v in r["grad_err"].items()
                                    if not v <= 2e-5})
                        if r[f"loss_{rows}err"] > 1.0 or bad:
                            raise AssertionError(f"multi: {what} differs from the unsharded "
                                                 f"pass: losses {r[f'loss_{rows}err']:.3f} of "
                                                 f"the tolerance, {bad}")
            for rows in zip(*res):  # every rank of a job holds the same map
                if rows[0]["job"] == "mapping" and len({r["digest"] for r in rows}) != 1:
                    raise AssertionError(f"multi: the ranks' maps differ: {rows}")
                if rows[0]["job"] == "system":
                    check_system_job(rows, (run["n_frames"], cfg.mapping.iters_first))
            for r in res[0]:
                if r["job"] == "mapping" and r["iters"] == max(iters) and not r["importance"]:
                    log(f"multi: mapping {r['n_map']}x{r['n_kf']}: {r['seconds']:.3f} s against "
                        f"the unsharded pass's {dt_plain:.3f} s on the card alone")

    # (b) the roles on the card named twice: the same bits as phase 4.
    from niceslam_tpu_torch.config.schema import ParallelConfig
    from niceslam_tpu_torch.io.datasets.synthetic import SyntheticBoxReader
    from niceslam_tpu_torch.slam.system import NiceSLAM

    rcfg = dataclasses.replace(cfg, parallel=ParallelConfig(track_role=True, stage_ep=True))
    reader = SyntheticBoxReader(rcfg, n_frames=36)
    slam = NiceSLAM(rcfg, reader=reader, seed=0, devices=["cuda:0", "cuda:0"])
    slam.n_imgs = run["n_frames"]
    start_peak("multi roles")
    clear_tallies()
    dts = []
    for k in range(run["n_frames"]):
        t0 = time.perf_counter()
        slam.step(reader[k])
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    launches = all_launches()
    check_route_launches("multi roles", "fused", launches)
    res = slam.result()
    got = digest(np.stack(res["est_c2w"]), slam.state.grids)
    log(f"multi roles: track_role + stage_ep on [cuda:0, cuda:0]: per-frame seconds "
        f"{[round(d, 4) for d in dts]}, peak {torch.cuda.max_memory_allocated() / 2**20:.1f} "
        f"MiB, launches {launches}, sha1 {got} (phase 4: {want_digest})")
    if got != want_digest:
        raise AssertionError("multi roles: the run differs from the plain main path")
    del slam

    # (c) the command line on 4 ranks, map = 2 x kf = 2, with a resume; then
    # on 2 ranks on the shipped mesh (map 1, every rank on kf).
    with tempfile.TemporaryDirectory() as tmp:
        def cli_ranks(config, overrides, world, extra, tag, segments, frames=cli_frames):
            from niceslam_tpu_torch.parallel.runtime import free_port

            port = free_port()
            argv = [os.path.join(ROOT, "configs", config), "--frames", str(frames),
                    "--ckpt-dir", os.path.join(tmp, "ck"),
                    "--log", os.path.join(tmp, f"{tag}.jsonl"),
                    "--trajectory", os.path.join(tmp, f"{tag}.npy"), *extra,
                    "--set", f"parallel.coordinator=localhost:{port}",
                    "--set", f"parallel.n_processes={world}"]
            for o in overrides:
                argv += ["--set", o]
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, "-c", CLI_WATCHED, *argv, "--process-id", str(r)],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for r in range(world)]
            outs = []
            try:
                for p in procs:
                    outs.append(p.communicate(timeout=300))
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            dt = time.perf_counter() - t0
            for r, (p, (so, se)) in enumerate(zip(procs, outs)):
                if p.returncode != 0:
                    raise AssertionError(f"multi cli [{tag}] rank {r}: rc {p.returncode}\n"
                                         f"{so[-2000:]}\n{se[-4000:]}")
                info = [line for line in se.splitlines()
                        if line.startswith(("launches ", "peak ", "pool "))]
                log(f"multi cli [{tag}] rank {r}: {' '.join(info)}")
                check_route_launches(f"multi cli [{tag}] rank {r}", "fused",
                                     json.loads(info[0][len("launches "):]))
            last = json.loads(outs[0][0].strip().splitlines()[-1])
            traj = np.load(os.path.join(tmp, f"{tag}.npy"))
            log(f"multi cli [{tag}]: {world} ranks in {dt:.1f} s (processes included); "
                f"fps_avg {last['fps_avg']}; rank 0's last line {last}")
            if not (last["frames"] == frames and traj.shape == (frames, 4, 4)
                    and np.isfinite(traj).all()):
                raise AssertionError(f"multi cli [{tag}]: {last}, trajectory {traj.shape}")
            if not last["ate_rmse_cm"] < ATE_LOST_CM:
                raise AssertionError(f"multi cli [{tag}]: the track is lost: {last}")
            with open(os.path.join(tmp, f"{tag}.jsonl")) as f:
                recs = [json.loads(line) for line in f.read().strip().splitlines()]
            progs = recs[-1]
            log(f"multi cli [{tag}]: rank 0's frames (s: dt, dt_track, dt_map) "
                f"{[(e['dt'], e['dt_track'], e['dt_map']) for e in recs if e['event'] == 'frame']}; "
                f"its programs {progs}")
            if not (progs["event"] == "programs" and progs["graphed"]
                    and progs["graphs"].get("map", 0) > 0 and progs["map_segments"] == segments):
                raise AssertionError(f"multi cli [{tag}]: the passes did not run as the graphs "
                                     f"of {segments}: {progs}")
            return traj

        overrides = ["dataset=synthetic", "sync_method=async", "tracking.method=adam",
                     "mapping.iters_first=100", "mapping.color_refine=false",
                     "mapping.ckpt_freq=2", "parallel.map=2", "parallel.kf=2"]
        map_segments = ["gather", "grads", "halo", "sample", "step"]
        traj = cli_ranks("cofusion.yaml", overrides, 4, [], "run", map_segments)
        ck = os.path.join(tmp, "ck", "frame_000002")
        traj2 = cli_ranks("cofusion.yaml", overrides, 4, ["--resume", ck], "resume",
                          map_segments)
        if not np.array_equal(traj2[:3], traj[:3]):
            raise AssertionError("multi cli: the resumed trajectory does not start with the "
                                 "saved one")
        # The shipped multi-rank mesh: its mapping passes replay graphs.
        cli_ranks("apartment_multihost.yaml",
                  ["dataset=synthetic", "parallel.map=1", "parallel.kf=0",
                   "mapping.pixels=4096", f"mapping.iters_first={KF_CLI_ITERS_FIRST}"],
                  2, [], "kf-only", ["grads", "step"])
        # Two ranks on map with the importance pass: one more segment.
        cli_ranks("cofusion.yaml",
                  ["dataset=synthetic", "sync_method=async", "tracking.method=adam",
                   "mapping.iters_first=100", "mapping.color_refine=false", "parallel.map=2",
                   "parallel.kf=1", f"rendering.N_importance={N_IMPORTANCE}"],
                  2, [], "importance", ["gather", "grads", "halo", "importance", "sample",
                                        "step"], frames=3)


# ---------------------------------------------------------------- phase 12
PRETRAIN_SCENES, PRETRAIN_STEPS, PRETRAIN_BATCH = 3, 50, 4096


def pretrain_counts(batch: int) -> dict:
    """The point counts of one pretraining step at ``batch``: occupancy,
    color, coarse and calibration points."""
    from niceslam_tpu_torch import pretrain_decoders as pd

    n_occ = batch + batch // 2 + pd.N_OBS * max(batch // (2 * pd.N_OBS), 1)
    return {"occ": n_occ, "col": n_occ - batch, "coarse": batch,
            "cal": len(range(0, n_occ, max(n_occ // 1024, 1)))}


def pretrain_step_calls(batch: int):
    """The step's ``nice_forward`` calls as ``(points, stage, live grids)``:
    the middle, fine, coarse and color stages on the live grids, then the
    calibration's middle, fine and coarse stages on zero grids."""
    n = pretrain_counts(batch)
    return ([(n["occ"], "middle", True), (n["occ"], "fine", True),
             (n["coarse"], "coarse", True), (n["col"], "color", True)]
            + [(n["cal"], s, False) for s in ("middle", "fine", "coarse")])


def pretrain_expected_launches(batch: int, steps: int):
    """K1's launches by ``(variant, deriv, N)`` and K2's by ``(dgrid, dv)``
    over ``steps`` steps: one K1 per level that a call samples (every one
    at C = 32, vector), one K2 (grid gradient only) per live-grid sample."""
    from collections import Counter

    from niceslam_tpu_torch.utils.roofline import STAGE_LEVELS

    k1, k2 = Counter(), Counter()
    for n, stage, live in pretrain_step_calls(batch):
        k1["vector", False, n] += steps * len(STAGE_LEVELS[stage])
        if live:
            k2[True, False] += steps * len(STAGE_LEVELS[stage])
    return k1, k2


def pretrain_step_bound_ms(batch: int, grid_shapes: dict) -> float:
    """A bound on one pretraining step from ``utils/roofline.py``: per call,
    per level sampled, ``trilinear_cost`` (with its backward on the live
    grids) and ``mlp_cost`` with its backward (the decoders always train),
    plus the Adam step over the grids (read parameter, gradient and two
    moments, write parameter and moments), over this card's peaks."""
    from niceslam_tpu_torch.utils.roofline import (
        STAGE_LEVELS, device_peaks, mlp_cost, sol_ms, trilinear_cost)

    c_dim = grid_shapes["fine"][-1]
    grid_bytes = {lvl: 4 * int(np.prod(s)) for lvl, s in grid_shapes.items()}
    flops = nbytes = 0.0
    for n, stage, live in pretrain_step_calls(batch):
        for lvl in STAGE_LEVELS[stage]:
            t = trilinear_cost(n, c_dim, grid_bytes[lvl], backward=live)
            m = mlp_cost(n, c_in=2 * c_dim if lvl == "fine" else c_dim,
                         color=lvl == "color", backward=True)
            flops += t["flops"] + m["flops"]
            nbytes += t["bytes"] + m["bytes"]
    nbytes += 7 * sum(grid_bytes.values())
    return sol_ms(flops, nbytes, device_peaks(torch.cuda.get_device_name()))


def pretrain_step_parity():
    """One pretraining step at the bench envelope, card against CPU on the
    same injected batch and parameters (loss 1e-5 relative, every gradient
    2e-5 of its leaf's largest entry), then the packed route against the
    fused one on the card at the same tolerance, each route launching its
    own kernels only."""
    from niceslam_tpu_torch import pretrain_decoders as pd
    from niceslam_tpu_torch.grid.hierarchy import GridConfig, init_grids
    from niceslam_tpu_torch.models.decoders import init_decoders, tree_map
    from niceslam_tpu_torch.ops.trilinear import sampler_route

    grids, bounds, adj = init_grids(np.asarray(pd.BOUND_SET[1], np.float32), GridConfig(),
                                    gen=torch.Generator().manual_seed(101), device="cpu")
    dec = init_decoders(gen=torch.Generator().manual_seed(1), device="cpu")
    geom = pd.scene_geometry(np.random.default_rng(0), adj)
    cfg = pd.PretrainConfig()
    on = lambda tree, dev: tree_map(lambda t: t.to(dev), tree)  # noqa: E731
    batch = on(pd.draw_batch(torch.Generator(device="cuda").manual_seed(3),
                             {k: torch.from_numpy(v).cuda() for k, v in geom.items()},
                             on(bounds, "cuda"), PRETRAIN_BATCH), "cpu")

    def step(dev):
        total, aux, grads = pd.loss_and_grads(
            pd.trainable(on(dec, dev)), pd.trainable(on(grids, dev)), on(batch, dev),
            {k: torch.from_numpy(v).to(dev) for k, v in geom.items()}, on(bounds, dev), cfg)
        return (float(total.detach()), {k: float(v.detach()) for k, v in aux.items()},
                [None if g is None else g.cpu() for g in grads])

    def compare(what, got, want):
        (loss, aux, grads), (wloss, waux, wgrads) = got, want
        rel = abs(loss - wloss) / abs(wloss)
        worst = 0.0
        for g, w in zip(grads, wgrads):
            if (g is None) != (w is None):
                raise AssertionError(f"pretrain {what}: a gradient is missing on one side")
            if w is not None:
                worst = max(worst, max_err(g, w) / max(float(w.abs().max()), 1e-30))
        log(f"pretrain {what}: loss {loss:.7f} against {wloss:.7f} (rel err {rel:.3e}), "
            f"aux {({k: round(v, 6) for k, v in aux.items()})}, worst gradient err "
            f"{worst:.3e} of its leaf's largest, over {sum(w is not None for w in wgrads)} "
            f"leaves")
        if not (rel <= 1e-5 and worst <= 2e-5):
            raise AssertionError(f"pretrain {what}: loss rel err {rel:.3e} (1e-5) or a "
                                 f"gradient err {worst:.3e} (2e-5)")

    results = {}
    for route in ROUTE_KERNELS:
        with sampler_route(route):
            clear_tallies()
            results[route] = step("cuda")
            torch.cuda.synchronize()
            launches = all_launches()
        check_route_launches(f"pretrain step [{route}]", route, launches)
        log(f"pretrain step [{route}] launches: {launches}"
            + (f"; K2 by gradients {k2_tally()}" if route == "fused" else ""))
    compare("card vs CPU [fused]", results["fused"], step("cpu"))
    compare("packed vs fused on the card", results["packed"], results["fused"])


def pretrain_graphed_vs_eager():
    """The cut recipe (``PRETRAIN_SCENES`` x ``PRETRAIN_STEPS`` at batch
    ``PRETRAIN_BATCH``) through ``pretrain`` graphed, then eagerly
    (``capture=False``), in this call: the same decoders and every scene's
    losses and terms bit for bit, K1 and K2 per step both ways, seconds per
    step both ways, each envelope's capture seconds and node count and the
    pool's MiB."""
    import contextlib
    import io
    from collections import Counter

    from niceslam_tpu_torch import pretrain_decoders as pd
    from niceslam_tpu_torch.models.decoders import tree_leaves
    from niceslam_tpu_torch.ops.trilerp_kernels import BWD_TALLY, FWD_TALLY

    pcfg = pd.PretrainConfig(scenes=PRETRAIN_SCENES, steps=PRETRAIN_STEPS, batch=PRETRAIN_BATCH)
    steps = PRETRAIN_SCENES * PRETRAIN_STEPS
    want = pretrain_expected_launches(PRETRAIN_BATCH, steps)
    runs = {}
    for way, capture in (("graphed", None), ("eager", False)):
        err = io.StringIO()
        torch.cuda.synchronize()
        clear_tallies()
        with contextlib.redirect_stderr(err):
            dec, recs = pd.pretrain(pcfg, "cuda", capture=capture)
        torch.cuda.synchronize()
        k1, k2 = Counter(FWD_TALLY), Counter(BWD_TALLY)
        if (k1, k2) != want:
            raise AssertionError(f"pretrain {way}: launches K1 {dict(k1)}, K2 {dict(k2)} (want "
                                 f"{dict(want[0])}, {dict(want[1])})")
        graphs = [line for line in err.getvalue().splitlines() if line.startswith("graph ")]
        runs[way] = (dec, recs)
        log(f"pretrain {way}: K1 {sum(k1.values()) / steps:g} and K2 {sum(k2.values()) / steps:g} "
            f"a step (as predicted); ms per step by scene "
            f"{[round(1e3 * r['s_per_step'], 3) for r in recs]}; peak MiB by scene "
            f"{[round(r['peak_mib'], 1) for r in recs]}"
            + (f"; pool MiB by scene {[round(r['pool_mib'], 1) for r in recs]}"
               if capture is None else ""))
        for line in graphs:
            log(f"pretrain {way}: {line}")
        if (capture is None) != (len(graphs) == len(pd.BOUND_SET)):
            raise AssertionError(f"pretrain {way}: {len(graphs)} graphs captured")
    (gd, grecs), (ed, erecs) = runs["graphed"], runs["eager"]
    same_dec = all(torch.equal(a, b) for a, b in zip(tree_leaves(gd), tree_leaves(ed)))
    same_loss = all(np.array_equal(g["losses"], e["losses"]) and g["aux"] == e["aux"]
                    for g, e in zip(grecs, erecs))
    log(f"pretrain: graphed against eager: decoders equal {same_dec}, every step's loss and "
        f"the last terms equal {same_loss}; ms per step graphed "
        f"{1e3 * np.mean([r['s_per_step'] for r in grecs]):.3f}, eager "
        f"{1e3 * np.mean([r['s_per_step'] for r in erecs]):.3f}")
    if not (same_dec and same_loss):
        raise AssertionError("pretrain: the graphed recipe differs from the eager one")


def pretrain_sync_recorder(sites, in_scene):
    """A ``warnings.showwarning`` that counts the calls which waited for the
    stream by call site, and apart those made inside ``train_scene``."""
    import traceback

    def record(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            site = sync_site(filename, lineno)
            sites[site] += 1
            if any(fr.name == "train_scene" for fr in traceback.extract_stack()):
                in_scene[site] += 1
    return record


def phase_pretrain():
    """Phase 12: decoder pretraining on the card (see the module docstring)."""
    import contextlib
    import io
    import warnings
    from collections import Counter

    from niceslam_tpu_torch import pretrain_decoders as pd
    from niceslam_tpu_torch.grid.hierarchy import GridConfig, adjust_bound, grid_shape
    from niceslam_tpu_torch.models.decoders import init_decoders, nice_forward
    from niceslam_tpu_torch.models.pretrained import load_decoders_npz
    from niceslam_tpu_torch.ops.trilerp_kernels import BWD_TALLY, FWD_TALLY

    pretrain_step_parity()
    pretrain_graphed_vs_eager()
    d = pd.PretrainConfig()
    log(f"cut: pretraining scenes {d.scenes} -> {PRETRAIN_SCENES} (one per envelope), steps "
        f"{d.steps} -> {PRETRAIN_STEPS}; batch {PRETRAIN_BATCH}, GridConfig() and "
        f"DecoderConfig() defaults")
    gcfg = GridConfig()
    shapes = []
    for b in pd.BOUND_SET:
        adj = adjust_bound(np.asarray(b, np.float32), gcfg.bound_divisable)
        shapes.append({lvl: grid_shape(adj, gcfg.level_len(lvl),
                                       gcfg.coarse_bound_enlarge if lvl == "coarse" else 1.0)
                       + (gcfg.c_dim,) for lvl in ("coarse", "middle", "fine", "color")})
    sites, in_scene = Counter(), Counter()
    out, err = io.StringIO(), io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pretrained.npz")
        argv = ["--scenes", str(PRETRAIN_SCENES), "--steps", str(PRETRAIN_STEPS),
                "--batch", str(PRETRAIN_BATCH), "--out", path]
        torch.cuda.synchronize()
        start_peak("pretrain")  # main reads the peak of each scene
        clear_tallies()
        showwarning = warnings.showwarning
        t0 = time.perf_counter()
        try:
            with (warnings.catch_warnings(), contextlib.redirect_stdout(out),
                  contextlib.redirect_stderr(err)):
                warnings.simplefilter("always")
                warnings.showwarning = pretrain_sync_recorder(sites, in_scene)
                torch.cuda.set_sync_debug_mode("warn")
                rc = pd.main(argv)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = showwarning
        wall = time.perf_counter() - t0
        launches, k1, k2 = all_launches(), Counter(FWD_TALLY), Counter(BWD_TALLY)
        for line in err.getvalue().splitlines():
            log(f"pretrain stderr: {line}")
        last = json.loads(out.getvalue().strip().splitlines()[-1])
        log(f"pretrain: main({' '.join(argv[:-2])}) rc {rc} in {wall:.2f} s; last line {last}")
        dec = load_decoders_npz(path, init_decoders(device="cuda"))
    recs = [json.loads(line.split(") ", 1)[1]) for line in err.getvalue().splitlines()
            if line.startswith("scene ")]
    steps = PRETRAIN_SCENES * PRETRAIN_STEPS
    want_k1, want_k2 = pretrain_expected_launches(PRETRAIN_BATCH, steps)
    log(f"pretrain: launches {launches}; K1 per step by (variant, deriv, N) "
        f"{ {k: c / steps for k, c in sorted(k1.items())} }; K2 per step by (dgrid, dv) "
        f"{ {k: c / steps for k, c in sorted(k2.items())} }")
    log(f"pretrain: calls that waited for the stream: {sum(sites.values())} "
        f"{dict(sites.most_common())}; inside train_scene: {dict(in_scene)}")
    for r, sh in zip(recs, shapes):
        bms = pretrain_step_bound_ms(PRETRAIN_BATCH, sh)
        log(f"pretrain scene {r['scene']} (envelope {r['bound']}, fine {sh['fine']}): loss "
            f"{r['first']:.5f} -> {r['last']:.5f}, aux {({k: round(v, 5) for k, v in r['aux'].items()})}, "
            f"{1e3 * r['s_per_step']:.3f} ms per step (synchronised at the scene's end) "
            f"against a roofline bound of {bms:.4f} ms, peak {r['peak_mib']:.1f} MiB")
    check_route_launches("pretrain", "fused", launches)
    if rc != 0 or len(recs) != PRETRAIN_SCENES or set(last) != {
            "scenes", "steps_per_scene", "final_losses", "wall_s", "out"}:
        raise AssertionError(f"pretrain: rc {rc}, {len(recs)} scene lines, last line {last}")
    if k1 != want_k1 or k2 != want_k2:
        raise AssertionError(f"pretrain: launches K1 {dict(k1)} (want {dict(want_k1)}), K2 "
                             f"{dict(k2)} (want {dict(want_k2)})")
    if in_scene:
        raise AssertionError(f"pretrain: calls inside a scene waited for the stream: "
                             f"{dict(in_scene)}")
    if not all(np.isfinite([r["first"], r["last"], *r["aux"].values()]).all() for r in recs):
        raise AssertionError(f"pretrain: a non-finite loss: {recs}")
    if not all(r["last"] < r["first"] for r in recs):
        raise AssertionError(f"pretrain: a scene's loss did not fall: {recs}")
    grids, bounds, geom = pretrain_scene_on_card(1)
    pts = pd.occupancy_points(pd.draw_batch(torch.Generator(device="cuda").manual_seed(9),
                                            geom, bounds, 1024))
    raw = nice_forward(dec, grids, pts, bounds, "color")
    if not (raw.shape == (pts.shape[0], 4) and bool(torch.isfinite(raw).all())):
        raise AssertionError("pretrain: the written decoders give a non-finite field")
    log(f"pretrain: the written .npz loads into init_decoders; nice_forward(color) on "
        f"{pts.shape[0]} points finite, occupancy in [{float(raw[:, 3].min()):.3f}, "
        f"{float(raw[:, 3].max()):.3f}]")


# ---------------------------------------------------------------- phase 15
# The importance samples a ray of phase 15 and phase 11's importance runs
# (rendering.N_importance; no shipped config sets one).
N_IMPORTANCE = 16


def with_importance(cfg):
    """``cfg`` at ``rendering.N_importance = N_IMPORTANCE``."""
    return dataclasses.replace(cfg, rendering=dataclasses.replace(
        cfg.rendering, N_importance=N_IMPORTANCE))


@contextlib.contextmanager
def syncs_in_programs(sites):
    """Counts into ``sites``, by call site, every call that waits for the
    stream while a pose solve's or a mapping pass's program runs (its
    replays and the eager work between them: ``set_sync_debug_mode``), but
    in a capture, which waits for the card by design."""
    import warnings

    from niceslam_tpu_torch.slam import programs as progs

    def watched(fn, mode):
        def call(*a, **kw):
            before = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(mode)
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(before)
        return call

    def record(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            sites[sync_site(filename, lineno)] += 1

    saved = (progs.TrackProgram.run, progs.MappingProgram.run, progs.Programs.capture_graph)
    progs.TrackProgram.run = watched(saved[0], "warn")
    progs.MappingProgram.run = watched(saved[1], "warn")
    progs.Programs.capture_graph = watched(saved[2], 0)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            yield sites
    finally:
        progs.TrackProgram.run, progs.MappingProgram.run, progs.Programs.capture_graph = saved
        torch.cuda.set_sync_debug_mode(0)


def phase_importance(cfg, base: dict):
    """Phase 15: the main path at ``rendering.N_importance = N_IMPORTANCE``
    on the card (the module docstring). ``base`` is phase 4's fused run of
    the same frames without the importance pass."""
    from collections import Counter

    from niceslam_tpu_torch.slam.programs import pool_bytes

    icfg = with_importance(cfg)
    n = base["n_frames"]
    sites = Counter()
    run = phase_main_path(icfg, n, label=f" imp{N_IMPORTANCE}", watch=syncs_in_programs(sites))
    launches, want = run["launches"], base["launches"]
    log(f"importance: seconds per frame {frame_seconds(run['dts'])} (without the pass, "
        f"phase 4: {frame_seconds(base['dts'])}); graph pool {pool_bytes() / 2**20:.1f} MiB; "
        f"peak {run['peak_bytes'] / 2**20:.1f} MiB (phase 4 "
        f"{base['peak_bytes'] / 2**20:.1f}); ATE {run['ate_cm']:.4f} cm; launches "
        f"{launches} (phase 4 {want})")
    log(f"importance: calls that waited for the stream inside a solve's or a pass's "
        f"program: {sum(sites.values())} {dict(sites.most_common())}")
    if sites:
        raise AssertionError(f"importance: calls inside the programs waited for the stream: "
                             f"{dict(sites)}")
    # Each render evaluates two point sets and differentiates the second.
    if (launches["trilerp_fwd"] != 2 * want["trilerp_fwd"]
            or launches["trilerp_bwd"] != want["trilerp_bwd"]):
        raise AssertionError(f"importance: K1 {launches['trilerp_fwd']} (want twice "
                             f"{want['trilerp_fwd']}), K2 {launches['trilerp_bwd']} (want "
                             f"{want['trilerp_bwd']})")
    phase_panel(run["slam"], run["reader"])
    del run["slam"]
    frames, iters_first = CUT
    ccfg = with_importance(cut_config(cfg, iters_first))
    cut = {way: phase_main_path(ccfg, frames, capture=capture, label=f" imp{N_IMPORTANCE} cut")
           for way, capture in (("graphed", None), ("eager", False))}
    got = {way: digest(r["poses"], r["grids"]) for way, r in cut.items()}
    log(f"importance cut ({frames} frames, iters_first {iters_first}): sha1 {got}; seconds "
        f"per frame graphed {frame_seconds(cut['graphed']['dts'])}, eager "
        f"{frame_seconds(cut['eager']['dts'])}")
    if len(set(got.values())) != 1 or cut["graphed"]["launches"] != cut["eager"]["launches"]:
        raise AssertionError(f"importance cut: graphed and eager differ: {got}, launches "
                             f"{cut['graphed']['launches']} against {cut['eager']['launches']}")


# ---------------------------------------------------------------- phase 14
# The keys of the JAX bench's line (bench.py), the sweep's record with
# depth_psnr (scripts/accuracy_sweep.py) and a kernel-bench record
# (scripts/kernel_bench.py, report).
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "ate_rmse_cm", "ate_seed0_cm",
              "ate_seeds_cm", "hbm_util", "mfu", "sol_fps", "chip"]
SWEEP_KEYS = ["name", "seed", "frames", "wall_s", "fps", "ate_rmse_cm", "t_err_cm",
              "curve_cm", "variant", "depth_l1_cm", "color_psnr_db", "total_s"]
OP_KEYS = ["op", "n", "mean_ms", "p50_ms", "gflops", "mbytes", "sol_ms", "frac_sol"]
# The bench's operating point in the sweep's keys (the sweep's defaults are
# an older one), 8 frames, with the render check.
SWEEP_VARIANT = ("bench:frames=8:pixels=400:iters=20:doff=0.05:bootstrap=5:fs=3:retrack=1:"
                 "depth_psnr=1")
# The kernel bench's ops: 14 in the main section, 14 in the Pallas section.
N_OPS = 14 + 14


def run_entry_point(main_fn, argv, env=None):
    """``main_fn(argv)`` of an entry point as a user calls it, with ``env``
    the only ``BENCH_*`` variables set (the caller's are put aside, so that
    the shell does not change what runs): what it wrote to standard output
    and standard error, both printed here too. A non-zero exit fails."""
    out, err = io.StringIO(), io.StringIO()
    keys = {k for k in os.environ if k.startswith("BENCH_")} | set(env or {})
    saved = {k: os.environ.pop(k, None) for k in keys}
    os.environ.update(env or {})
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main_fn(argv)
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        for line in err.getvalue().splitlines() + out.getvalue().splitlines():
            log(f"  | {line}")
    if rc != 0:
        raise AssertionError(f"{main_fn.__module__}.main({argv}) exited {rc}")
    return out.getvalue(), err.getvalue()


def check_bench_line(out: str, err: str, seeds: int):
    """The bench's one line on standard output: the JAX bench's keys, a
    finite positive rate and speed of light, roofline shares in (0, 1.05],
    each seed's logged ATE equal to its entry and under ``ATE_LOST_CM``, and
    the memory allocated at a seed's start, the graph pool and its peak not
    growing seed by seed: from seed 1 on, every seed starts from the same
    allocation, within 4 MiB."""
    lines = out.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench: {len(lines)} lines on standard output")
    line = json.loads(lines[0])
    if list(line) != BENCH_KEYS:
        raise AssertionError(f"bench: keys {list(line)}, not {BENCH_KEYS}")
    for key in ("value", "sol_fps"):
        if not (np.isfinite(line[key]) and line[key] > 0):
            raise AssertionError(f"bench: {key} {line[key]}")
    for key in ("hbm_util", "mfu"):
        if not 0 < line[key] <= 1.05:
            raise AssertionError(f"bench: {key} {line[key]} outside (0, 1.05]")
    seed_lines = re.findall(r"^seed (\d+): ATE RMSE = (\S+)(?: cm)?; .*allocated at start "
                            r"([0-9.]+) MiB; graph pool ([0-9.]+) MiB; peak ([0-9.]+) MiB$",
                            err, re.M)
    if [int(s[0]) for s in seed_lines] != list(range(seeds)):
        raise AssertionError(f"bench: seed lines {seed_lines}")
    logged = [float(s[1]) for s in seed_lines if s[1] != "n/a"]
    if len(logged) != seeds or logged != line["ate_seeds_cm"]:
        raise AssertionError(f"bench: logged ATEs {logged}, line {line['ate_seeds_cm']}")
    if not all(a < ATE_LOST_CM for a in logged):
        raise AssertionError(f"bench: a lost track: ATEs {logged} cm")
    starts, pools, peaks = ([float(s[k]) for s in seed_lines] for k in (2, 3, 4))
    # Seed 0 starts before any system of the bench; the first one leaves
    # buffers that the process keeps (96 MiB on an H100, not yet identified:
    # PERF.md section 7), so seed 1 may start up to 128 MiB above seed 0 and
    # every later seed where seed 1 did. A system left alive would hold its
    # keyframe store (315 MiB at the bench) and its graphs. The pool is the
    # process's, which earlier phases have grown: it shows only that no seed
    # reserved more. A seed's peak moves with how far async dispatch runs
    # ahead of the host.
    if (any(a > starts[0] + 128 for a in starts[1:2])
            or any(abs(a - starts[1]) > 4 for a in starts[1:])
            or any(p > pools[0] for p in pools) or any(p > 1.05 * peaks[0] for p in peaks)):
        raise AssertionError(f"bench: memory grows seed by seed: allocated at start "
                             f"{starts}, pool {pools}, peak {peaks} MiB")
    log(f"bench: {line['value']} frames/s, ATE {logged} cm, allocated at start {starts} "
        f"MiB, pool {pools} MiB, peak {peaks} MiB per seed")


def phase_entry_points():
    """Phase 14: the port's measurement entry points through their ``main``,
    cut: the bench at 12 frames x 2 seeds, async; the sweep with one
    variant at 8 frames and its render check; the kernel bench with both
    sections at 2 replays an op."""
    out, err = run_entry_point(bench.main, [], {
        "BENCH_FRAMES": "12", "BENCH_SEEDS": "2", "BENCH_SYNC": "async"})
    check_bench_line(out, err, 2)

    out, _ = run_entry_point(accuracy_sweep.main, [SWEEP_VARIANT])
    rec = json.loads(out.strip().splitlines()[-1])
    if list(rec) != SWEEP_KEYS:
        raise AssertionError(f"sweep: keys {list(rec)}, not {SWEEP_KEYS}")
    if not (rec["ate_rmse_cm"] < ATE_LOST_CM and rec["t_err_cm"]["max"] < RAW_LOST_CM
            and np.isfinite(rec["depth_l1_cm"]) and np.isfinite(rec["color_psnr_db"])):
        raise AssertionError(f"sweep: the track is lost or a render is not finite: {rec}")

    out, _ = run_entry_point(kernel_bench.main, ["--pallas", "--iters", "2"])
    recs = [json.loads(line) for line in out.strip().splitlines()]
    if len({r["op"] for r in recs}) != N_OPS or len(recs) != N_OPS:
        raise AssertionError(f"kernel bench: {len(recs)} records, ops {[r['op'] for r in recs]}")
    for r in recs:
        if list(r)[:len(OP_KEYS)] != OP_KEYS or not all(
                np.isfinite(r[k]) and r[k] > 0 for k in ("mean_ms", "p50_ms", "sol_ms")):
            raise AssertionError(f"kernel bench: record {r}")


# ---------------------------------------------------------------- phase 16
# The reference envelope: LONGRUN_r05.json's run of the JAX package, the
# command line on configs/cofusion_synth849.yaml with these overrides, on the
# Co-Fusion layout of 849 frames along two orbits (make_fixture_dataset
# --frames 849 --arc 2.0), then a resume from its frame-500 checkpoint to
# frame 530. ``--reference-run`` runs it; phase 16 runs each mechanism of
# it once on a cut (ENVELOPE_SETS on top, ENVELOPE_FRAMES frames at the
# long run's motion per frame).
LONGRUN_SETS = (
    "sync_method=async", "mapping.max_keyframes=16", "mapping.ckpt_freq=500",
    "mapping.bootstrap_frames=5", "mapping.fs_weight=3.0", "mapping.retrack=true",
    "mapping.lock_after=8", "tracking.iters=20", "tracking.pixels=400",
    "tracking.gn_depth_offset_sigma=0.05", "verbose=false",
)
LONGRUN_FRAMES, LONGRUN_ARC, LONGRUN_RESUME = 849, 2.0, (500, 530)
# The cut: a ring of 4 slots admitting every other mapped frame (the 5
# bootstrap frames fill it and the fifth reuses a slot), voxels locked after
# 2 events, a checkpoint at frame 6 and a resume from it, the colour refine.
ENVELOPE_SETS = ("mapping.iters_first=100", "mapping.keyframe_every=2",
                 "mapping.max_keyframes=4", "mapping.lock_after=2", "mapping.ckpt_freq=6",
                 "mapping.color_refine=true")
ENVELOPE_FRAMES = 12
# Frames whose graph pool and peak device memory the watched command line
# records (and its last frame).
MEMORY_MARKS = (100, 400, 800)


def envelope_cli(argv) -> int:
    """The command line's ``main(argv)`` with its system watched; prints on
    standard error the kernels' launches, the peak memory and the graph pool,
    then ``envelope {...}``: the frame at which
    the keyframe ring first reused a slot, the ring's frames and count at the
    end, the graph pool and peak device memory (MiB) at ``MEMORY_MARKS`` and
    the last frame, and the voxels locked per level at the end. With
    ``--check-locks`` first, every mapping event also holds the grid values
    of the voxels locked when it starts: the event must leave them equal bit
    for bit (``lock_checks`` counts the events that held some), but the
    last frame's colour refine, whose levels that moved a locked voxel are
    recorded (``refine_moved_locked``)."""
    from niceslam_tpu_torch import __main__ as cli
    from niceslam_tpu_torch.slam.programs import pool_bytes
    from niceslam_tpu_torch.slam.system import NiceSLAM

    check = argv[:1] == ["--check-locks"]
    argv = argv[1:] if check else argv
    rec = {"first_reuse": None, "memory": {}, "locked": None, "lock_checks": 0}
    step, map_frame = NiceSLAM.step, NiceSLAM.map_frame

    def watched_map_frame(self, frame, first=False):
        idx, count = len(self.est_c2w) - 1, self._kf_count
        held = {}
        if check and self._obs_counts is not None:
            self._verify_pending()  # map_frame's first act: settle the last event
            lock = self.cfg.mapping.lock_after
            for lvl, c in self._obs_counts.items():
                locked = c[..., 0] >= lock
                if bool(locked.any()):
                    held[lvl] = (locked, self.state.grids[lvl][locked].clone())
        map_frame(self, frame, first=first)
        moved = [lvl for lvl, (locked, vals) in held.items()
                 if not torch.equal(self.state.grids[lvl][locked], vals)]
        if check and idx == self.n_imgs - 1 and self.cfg.mapping.color_refine and not first:
            # The refine passes run without frustum selection, and a pass
            # without it applies no update mask, the locks included, in both
            # packages (ROADMAP queue 3 item 7): recorded, not raised.
            rec["refine_moved_locked"] = moved
        elif moved:
            raise AssertionError(f"frame {idx}: a locked voxel of {moved} changed")
        else:
            rec["lock_checks"] += bool(held)
        if rec["first_reuse"] is None and count >= self.state.keyframes.capacity \
                and self._kf_count > count:
            rec["first_reuse"] = idx

    def watched_step(self, frame):
        step(self, frame)
        idx = len(self.est_c2w) - 1
        if idx in MEMORY_MARKS or idx == self.n_imgs - 1:
            rec["memory"][idx] = {"pool_mib": round(pool_bytes() / 2**20, 1),
                                  "peak_mib": round(torch.cuda.max_memory_allocated() / 2**20, 1)}
        if idx == self.n_imgs - 1:
            rec["kf_count"] = self._kf_count
            rec["kf_frames"] = sorted(int(f) for f in self._kf_slot_frame)
            if self._obs_counts is not None:
                lock = self.cfg.mapping.lock_after
                rec["locked"] = {lvl: int((c >= lock).sum())
                                 for lvl, c in self._obs_counts.items()}
                rec["voxels"] = {lvl: int(c.numel()) for lvl, c in self._obs_counts.items()}

    NiceSLAM.step, NiceSLAM.map_frame = watched_step, watched_map_frame
    try:
        rc = cli.main(argv)
    finally:
        NiceSLAM.step, NiceSLAM.map_frame = step, map_frame
    print("launches " + json.dumps(all_launches()), file=sys.stderr)
    print(f"peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", file=sys.stderr)
    print(f"pool {pool_bytes() / 2**20:.1f} MiB", file=sys.stderr)
    print("envelope " + json.dumps(rec), file=sys.stderr)
    return rc


def watched_run(argv, tag: str, timeout: int, check_locks=False):
    """:func:`envelope_cli` in a subprocess on the card (``run_cli``);
    returns the last line of standard output, the watch record, the mapping
    events and rollbacks of its log (``--log`` in ``argv``) and the wall
    seconds."""
    lines, _, dt, err = run_cli(["--check-locks", *argv] if check_locks else argv, tag,
                                timeout)
    rec = json.loads(next(line for line in err.splitlines()[::-1]
                          if line.startswith("envelope "))[len("envelope "):])
    events = rec_events(argv[argv.index("--log") + 1])
    rec["map_events"] = len({e["frame"] for e in events if e["event"] == "map"})
    rec["map_passes"] = sum(e["event"] == "map" for e in events)
    rec["rollbacks"] = sum(e["event"] == "map_rejected" for e in events)
    return json.loads(lines[-1]), rec, dt


def track_errors(tag: str, traj_path: str, poses, frames: int) -> dict:
    """The trajectory against the poses written: raises unless every pose
    is finite; returns the ATE (cm) and each frame's raw position error
    (cm) over the first ``frames`` frames, and why the track counts as lost
    there (``lost_track``, ``""`` if it does not)."""
    from niceslam_tpu_torch.eval.ate import ate_rmse

    traj = np.load(traj_path)
    if not (traj.shape == (len(poses), 4, 4) and np.isfinite(traj).all()):
        raise AssertionError(f"{tag}: trajectory {traj.shape}, finite {np.isfinite(traj).all()}")
    gt = np.stack(poses)
    err_cm = 100.0 * np.linalg.norm(traj[:, :3, 3] - gt[:, :3, 3], axis=1)
    ate_cm = 100.0 * ate_rmse(list(traj[:frames]), list(gt[:frames]))
    return {"traj": traj, "gt": gt, "err_cm": err_cm, "ate_cm": ate_cm,
            "lost": lost_track(ate_cm, err_cm[:frames])}


def check_envelope_run(tag: str, traj_path: str, poses, frames: int) -> dict:
    """:func:`track_errors`, failing on a lost track in the first ``frames``
    frames."""
    acc = track_errors(tag, traj_path, poses, frames)
    if acc["lost"]:
        raise AssertionError(f"{tag}: the track is lost in frames 0-{frames - 1}: "
                             f"{acc['lost']}")
    return acc


def error_curve(acc: dict, every: int = 50) -> str:
    """The raw position error every ``every`` frames, the aligned ATE of
    the frames up to each, and the first frames past the lost-track bounds."""
    from niceslam_tpu_torch.eval.ate import ate_rmse

    traj, gt, err = acc["traj"], acc["gt"], acc["err_cm"]
    marks = list(range(every, len(err), every)) + [len(err) - 1]
    raw = {k: round(float(err[k]), 2) for k in marks}
    ate = {k: round(100.0 * ate_rmse(list(traj[:k + 1]), list(gt[:k + 1])), 2) for k in marks}
    first_raw = next((k for k, e in enumerate(err) if e >= RAW_LOST_CM), None)
    first_ate = next((k for k in range(2, len(err))
                      if 100.0 * ate_rmse(list(traj[:k + 1]), list(gt[:k + 1])) >= ATE_LOST_CM),
                     None)
    return (f"raw position error (cm) by frame {json.dumps(raw)}; ATE (cm) of frames 0-k "
            f"{json.dumps(ate)}; raw error first >= {RAW_LOST_CM} cm at frame {first_raw}, "
            f"ATE of frames 0-k first >= {ATE_LOST_CM} cm at k = {first_ate}")


def envelope_argv(config: str, data: str, tmp: str, tag: str, sets, extra=()):
    argv = [config, "--set", f"data.input_folder={data}", "--log",
            os.path.join(tmp, f"{tag}.jsonl"), "--ckpt-dir", os.path.join(tmp, "ck"),
            "--trajectory", os.path.join(tmp, f"{tag}.npy"), *extra]
    for o in sets:
        argv += ["--set", o]
    return argv


def phase_envelope():
    """Each mechanism of the reference run once, through the command line on
    the Co-Fusion layout at 640x480 (``make_fixture_dataset``) with the long
    run's overrides cut by ``ENVELOPE_SETS``: the ring reuses a slot, voxels
    lock and no event changes a locked voxel's grid values, a checkpoint at
    frame 6 resumes to the end with the same first 7 poses, the colour
    refine runs on the last frame, and the track is not lost."""
    from niceslam_tpu_torch import make_fixture_dataset as fixture

    config = os.path.join(ROOT, "configs", "cofusion.yaml")
    sets = LONGRUN_SETS + ENVELOPE_SETS
    frames, ck = ENVELOPE_FRAMES, 6
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "room")
        t0 = time.perf_counter()
        poses = fixture.write_layout("cofusion", data, frames,
                                     arc=LONGRUN_ARC * frames / LONGRUN_FRAMES)
        log(f"envelope: wrote {frames} frames of the Co-Fusion layout in "
            f"{time.perf_counter() - t0:.2f} s")
        last, rec, dt = watched_run(envelope_argv(config, data, tmp, "run", sets,
                                                  ["--frames", str(frames)]),
                                    "envelope", timeout=300, check_locks=True)
        acc = check_envelope_run("envelope", os.path.join(tmp, "run.npy"), poses, frames)
        log(f"envelope: rc 0 in {dt:.1f} s, fps_avg {last['fps_avg']}, ATE {acc['ate_cm']:.3f} "
            f"cm, worst raw error {acc['err_cm'].max():.2f} cm at frame "
            f"{int(np.argmax(acc['err_cm']))}; "
            f"{rec['map_events']} mapping events ({rec['map_passes']} passes), "
            f"{rec['rollbacks']} rollbacks; ring of 4 first reused a slot at frame "
            f"{rec['first_reuse']}, holds frames {rec['kf_frames']} of {rec['kf_count']} "
            f"admitted; locked voxels {rec['locked']} of {rec['voxels']}, "
            f"{rec['lock_checks']} events held them unchanged; memory {rec['memory']}")
        if rec["first_reuse"] is None or rec["kf_count"] <= 4:
            raise AssertionError(f"envelope: the ring never reused a slot: {rec}")
        if not (rec["locked"] and sum(rec["locked"].values()) > 0 and rec["lock_checks"] > 0):
            raise AssertionError(f"envelope: no voxel was locked: {rec}")
        refine = [p for p in rec_events(os.path.join(tmp, "run.jsonl"))
                  if p["event"] == "map" and p["frame"] == frames - 1 and not p["coarse"]]
        if len(refine) != 5:
            raise AssertionError(f"envelope: the last frame's passes {refine}, not the 5 "
                                 "colour refine passes")
        log(f"envelope: the colour refine ran 5 passes on frame {frames - 1} (stages "
            f"{refine[0]['stages']}); they moved locked voxels of {rec['refine_moved_locked']}: "
            f"a pass without frustum selection applies no update mask, the locks included, "
            f"in both packages (ROADMAP queue 3 item 7)")
        ckpt = os.path.join(tmp, "ck", f"frame_{ck:06d}")
        last2, rec2, dt2 = watched_run(envelope_argv(
            config, data, tmp, "resume", sets,
            ["--frames", str(frames), "--resume", ckpt, "--no-precompile"]),
            "envelope resume", timeout=300, check_locks=True)
        traj, traj2 = (np.load(os.path.join(tmp, f"{t}.npy")) for t in ("run", "resume"))
        check_envelope_run("envelope resume", os.path.join(tmp, "resume.npy"), poses, frames)
        if not np.array_equal(traj2[:ck + 1], traj[:ck + 1]):
            raise AssertionError("envelope resume: the resumed trajectory does not start with "
                                 "the saved one")
        log(f"envelope resume: rc 0 in {dt2:.1f} s from {os.path.basename(ckpt)}, its first "
            f"{ck + 1} poses equal the run's bit for bit, ATE {last2['ate_rmse_cm']} cm; "
            f"locked voxels at the end {rec2['locked']} (the counts restart at 0 on a resume: "
            f"ROADMAP queue 3 item 2)")


def rec_events(path: str):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def phase_reference_run() -> dict:
    """The reference-scale run (``--reference-run``): the 849-frame fixture
    written, ``configs/cofusion_synth849.yaml`` with ``LONGRUN_SETS``
    through the watched command line,
    then the resume leg. Fails on a non-zero exit, a non-finite pose or a
    lost track on the first orbit, after printing every figure; the ATE
    over the whole run is recorded (no loop closure: the JAX run drifted by
    design)."""
    from niceslam_tpu_torch import make_fixture_dataset as fixture

    config = os.path.join(ROOT, "configs", "cofusion_synth849.yaml")
    frames, (ck, end) = LONGRUN_FRAMES, LONGRUN_RESUME
    sets = LONGRUN_SETS
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "cofusion_synth849")
        t0 = time.perf_counter()
        poses = fixture.write_layout("cofusion", data, frames, arc=LONGRUN_ARC)
        write_s = time.perf_counter() - t0
        log(f"reference run: wrote {frames} frames (Co-Fusion layout, 640x480, arc "
            f"{LONGRUN_ARC}) in {write_s:.2f} s with {fixture.default_workers(frames)} "
            f"processes")
        last, rec, dt = watched_run(envelope_argv(config, data, tmp, "run", sets),
                                    "reference run", timeout=3000)
        orbit = frames // 2
        acc = track_errors("reference run", os.path.join(tmp, "run.npy"), poses, orbit)
        log(f"reference run: rc 0, {frames} frames in {dt:.1f} s wall (process included), "
            f"fps_avg {last['fps_avg']}, ATE {last['ate_rmse_cm']} cm over the run, "
            f"{acc['ate_cm']:.3f} cm over the first orbit (frames 0-{orbit - 1})")
        log(f"reference run: {error_curve(acc)}")
        log(f"reference run: {rec['map_events']} mapping events ({rec['map_passes']} passes), "
            f"{rec['rollbacks']} rollbacks")
        log(f"reference run: the keyframe ring ({rec['kf_count']} admitted) first reused a "
            f"slot at frame {rec['first_reuse']}; at the end it holds frames "
            f"{rec['kf_frames']}")
        log(f"reference run: locked voxels per level at the end {rec['locked']} of "
            f"{rec['voxels']}")
        log(f"reference run: graph pool and peak device memory (MiB) by frame "
            f"{json.dumps(rec['memory'])}")
        ckpt = os.path.join(tmp, "ck", f"frame_{ck:06d}")
        last2, rec2, dt2 = watched_run(envelope_argv(
            config, data, tmp, "resume", sets,
            ["--resume", ckpt, "--frames", str(end)]), "reference resume", timeout=900)
        acc2 = track_errors("reference resume", os.path.join(tmp, "resume.npy"), poses[:end],
                            orbit)
        same = np.array_equal(acc2["traj"][:ck + 1], acc["traj"][:ck + 1])
        log(f"reference resume: rc 0 from {os.path.basename(ckpt)} to frame {end} in "
            f"{dt2:.1f} s, the first {ck + 1} poses equal the run's: {same}, ATE "
            f"{last2['ate_rmse_cm']} cm, raw error at frame {end - 1} "
            f"{acc2['err_cm'][-1]:.2f} cm (the run's {acc['err_cm'][end - 1]:.2f}), locked "
            f"voxels at its end {rec2['locked']} (the counts restart at 0 on a resume: "
            f"ROADMAP queue 3 item 2)")
        if not same:
            raise AssertionError("reference resume: the resumed trajectory does not start "
                                 "with the saved one")
        if acc["lost"]:
            raise AssertionError(f"reference run: the track is lost on the first orbit "
                                 f"(frames 0-{orbit - 1}): {acc['lost']}")
    return {"frames": frames, "write_s": write_s, "wall_s": dt, "fps_avg": last["fps_avg"],
            "ate_cm": last["ate_rmse_cm"], "ate_cm_first_orbit": acc["ate_cm"],
            "map_events": rec["map_events"], "rollbacks": rec["rollbacks"],
            "first_reuse": rec["first_reuse"], "locked": rec["locked"],
            "memory": rec["memory"], "resume": {"rc": 0, "ate_cm": last2["ate_rmse_cm"],
                                                "wall_s": dt2}}


def phase_pretrain_recipe(cfg, n_frames: int) -> dict:
    """The full pretraining recipe on the card, then the fused main path with
    the decoders it wrote and with the shipped ones."""
    from niceslam_tpu_torch import pretrain_decoders as pd

    pcfg, _ = pd.parse_args([])
    t0 = time.perf_counter()
    if pd.main([]) != 0:
        raise AssertionError("pretraining failed")
    wall = time.perf_counter() - t0
    steps = pcfg.scenes * pcfg.steps
    out = {"pretrain_wall_s": wall, "steps": steps, "steps_per_s": steps / wall,
           "batch": pcfg.batch, "frames": n_frames}
    for name, path in (("trained", pcfg.out), ("shipped", cfg.pretrained_middle_fine)):
        run_cfg = dataclasses.replace(cfg, pretrained_middle_fine=os.path.abspath(path))
        try:
            out[f"ate_cm_{name}"] = phase_main_path(run_cfg, n_frames)["ate_cm"]
        except AssertionError as e:  # a lost track: the finding, not a failure here
            out[f"ate_cm_{name}"] = None
            out[f"lost_{name}"] = str(e)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--iters-first", type=int, default=1500)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--multi-only", action="store_true",
                    help="phases 1, 4 (fused) and 11 only")
    ap.add_argument("--pretrain-recipe", action="store_true",
                    help="phase 1, the full pretraining recipe, phase 4 with its decoders")
    ap.add_argument("--reference-run", action="store_true",
                    help="phase 1, then the 849-frame reference run and its resume leg")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    cfg = bench_config(sync="strict")
    if args.iters_first != cfg.mapping.iters_first:
        log(f"cut: mapping.iters_first {cfg.mapping.iters_first} -> {args.iters_first}")
        cfg = dataclasses.replace(
            cfg, mapping=dataclasses.replace(cfg.mapping, iters_first=args.iters_first))
    if args.frames != 8:
        log(f"cut: frames 8 -> {args.frames}")

    t_all = time.perf_counter()
    phase_card()
    if args.pretrain_recipe:
        print(json.dumps(phase_pretrain_recipe(cfg, args.frames)), flush=True)
        return 0
    if args.reference_run:
        log(f"reference run: {json.dumps(phase_reference_run())}")
        log(f"total seconds: {time.perf_counter() - t_all:.1f}")
        print(nvidia_smi_line(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.multi_only:
        run = phase_main_path(cfg, args.frames, keep=1)
        t0 = time.perf_counter()
        phase_multi(cfg, run, digest(run["poses"], run["grids"]))
        log(f"multi phase: {time.perf_counter() - t0:.1f} s; total seconds: "
            f"{time.perf_counter() - t_all:.1f}")
        return 0
    rows = kernel_rows(cfg)
    for route in ROUTE_KERNELS:
        phase_card_vs_cpu(route)
    repeat = min(2, args.frames)
    runs = {"fused": phase_main_path(cfg, args.frames, keep=repeat)}
    log_pool("the fused main path (phase 4)")
    fused_digest = digest(runs["fused"]["poses"], runs["fused"]["grids"])
    phase_repeat(cfg, runs["fused"], repeat)
    rows += phase_adam(runs["fused"], cfg)
    if args.profile:
        phase_profile(runs["fused"]["slam"], runs["fused"]["reader"], cfg.mapping.every_frame)
    graphed_busy = trace_busy(runs["fused"]["slam"], runs["fused"]["reader"], "graphs [fused]")
    t0 = time.perf_counter()
    phase_mesher(runs["fused"]["slam"], cfg)
    log_pool("the meshes (phase 5)")
    phase_panel(runs["fused"]["slam"], runs["fused"]["reader"])
    log(f"mesher phase: {time.perf_counter() - t0:.1f} s")
    log_pool("a panel (phase 5)")
    del runs["fused"]["slam"]  # the later runs' peak memory is their own
    phase_async(cfg, runs["fused"])
    log_pool("the async main path (phase 7)")
    runs["packed"] = phase_main_path(cfg, args.frames, route="packed")
    log_pool("the packed main path (phase 4)")
    for route, run in runs.items():
        log(f"routes: [{route}] frame seconds {[round(d, 4) for d in run['dts']]}, "
            f"after frame 0 {sum(run['dts'][1:]):.3f} s, peak device memory "
            f"{run['peak_bytes'] / 2**20:.1f} MiB, ATE {run['ate_cm']:.4f} cm")
    del runs["packed"]["slam"]
    t0 = time.perf_counter()
    phase_async_fault(cfg, args.frames, min(args.iters_first, 100))
    log(f"async fault phase: {time.perf_counter() - t0:.1f} s")
    log_pool("the async fault run (phase 8)")
    t0 = time.perf_counter()
    phase_cli()
    log(f"cli phase: {time.perf_counter() - t0:.1f} s")
    log_pool("the command line (phase 9)")
    t0 = time.perf_counter()
    phase_real_data()
    log(f"real data phase: {time.perf_counter() - t0:.1f} s")
    log_pool("the panel (phase 10)")
    t0 = time.perf_counter()
    phase_multi(cfg, runs["fused"], fused_digest)
    log(f"multi phase: {time.perf_counter() - t0:.1f} s")
    log_pool("the roles (phase 11)")
    t0 = time.perf_counter()
    phase_pretrain()
    log(f"pretrain phase: {time.perf_counter() - t0:.1f} s")
    log_pool("pretraining (phase 12)")
    t0 = time.perf_counter()
    phase_graphs(cfg, graphed_busy)
    log(f"graphs phase: {time.perf_counter() - t0:.1f} s")
    log_pool("the eager runs (phase 13)")
    t0 = time.perf_counter()
    phase_entry_points()
    log(f"entry points phase: {time.perf_counter() - t0:.1f} s")
    log_pool("the measurement entry points (phase 14)")
    t0 = time.perf_counter()
    phase_importance(cfg, runs["fused"])
    log(f"importance phase: {time.perf_counter() - t0:.1f} s")
    log_pool("the importance pass (phase 15)")
    t0 = time.perf_counter()
    phase_envelope()
    log(f"envelope phase: {time.perf_counter() - t0:.1f} s")
    log_pool("the cut envelope (phase 16)")
    log(f"graph pool of the process where each phase ended (MiB): {json.dumps(POOL_READINGS)}")
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
