"""Captured programs: the port's counterpart of the JAX package's compiled
programs and of its ``precompile``.

The JAX package runs its hot functions as compiled XLA programs, one per
signature. Here a call is Python over many small kernels, and on a card the
host's cost per kernel sets the pace (PERF.md §5). So a :class:`Programs`
keeps, per signature and device, the static device buffers of one call and
a CUDA graph of it. A call copies its inputs into the buffers, replays the
graph, and copies its results out as new tensors: nothing a caller keeps
shares storage with the buffers. With ``capture`` off (the CPU) the same
buffers run the same Python body eagerly. The programs, each with the JAX
site it replaces:

- the pose solve (``slam/tracker.py:339``): :class:`TrackProgram`, one
  graph of :func:`~.tracker.track_iteration`, replayed once per iteration;
- a mapping pass (``slam/mapper.py:610``): :class:`MappingProgram`, one
  graph of :func:`~.mapper.mapping_iteration` per stage and set of zero
  learning rates (the stages differentiate different leaves), replayed
  once per row of the schedule; the device step counter picks each
  iteration's row of the tables;
- a mapping pass on a ``('map', 'kf')`` mesh
  (``parallel/sharded_mapper.py:327``): the same :class:`MappingProgram`
  with the rank's :class:`~.mapper.KfSlice`, per stage and set of zero
  learning rates a few graphs replayed around eager collectives: with one
  map block one graph of each half of the iteration
  (:func:`~.mapper.mapping_grads`, :func:`~.mapper.mapping_step`) around
  the all_reduce of the flat gradient buffer, with more than one the
  segments of ``parallel/sharded_mapper.MapSegments`` (halo rows, local
  samples, loss and gradients, returned gradients, step) around 3
  all_reduces (4 with more than one kf rank);
- keyframe selection (``slam/keyframes.py:42``) and the frustum masks
  (``slam/keyframes.py:87``, one program per window size and map):
  :meth:`Programs.overlap_percentages`, :meth:`Programs.frustum_masks`;
- ``render_image`` (``render/renderer.py:123``): one graph of a row
  chunk's ``render_rays``, replayed over the chunks;
- the mesher's ``eval_chunk`` and ``color_chunk`` (``eval/mesher.py:68``,
  ``:185``): one graph of a chunk's ``nice_forward`` per stage and output;
- the pretraining step (``scripts/pretrain_decoders.py:213``, one program
  per bound envelope): ``pretrain_decoders.PretrainProgram``, the loss, its
  gradients and the Adam step of every leaf, replayed once per step.

Keyframe selection, the frustum masks, ``render_image`` and the mesher's
chunks are :class:`StaticProgram` s, functions without state of their own.
No graph holds a collective: gloo cannot be captured, and NCCL refuses two
ranks on one card. So under a multi-rank runtime every collective of a
pass runs eagerly between two replays, and the solves, the keyframe
programs and every pass replay graphs. A capture runs no collective, so
ranks capture in any order; they replay in the same order.

Who owns them: a ``NiceSLAM`` owns its programs (solves, passes, keyframe
programs), ``pretrain_decoders.pretrain`` owns the recipe's, released with
it. ``render_image`` and the mesher keep no state between calls, so their
graphs live in the process-wide programs of :func:`shared_programs`, one per
capture mode, keyed on the device like every program.

- A graph is captured at its first use, or ahead of it (``warm``, from
  ``NiceSLAM.precompile`` and ``pretrain``): one warm-up call on the card's
  capture stream, whose effects on the buffers are undone, then the
  capture, in ``thread_local`` mode so that the frame prefetcher's thread
  may pin host memory meanwhile. A capture waits for the device.
- Every graph of a card, whichever ``Programs`` holds it, captures on one
  stream into one memory pool (:func:`card_graphs`), so a capture reuses
  the free blocks that earlier captures left instead of reserving a pool
  of its own. That is safe because the graphs of a card never run at the
  same time (one thread replays them, on one stream) and because **no
  graph's output lies in the pool**: every tensor a call writes (its
  ``buffers()``) exists before the capture, made at the program's
  construction or by the warm-up call, outside the pool. A capture that
  would make one raises. The pool lives while any of its graphs does;
  :func:`pool_bytes` reads it. A capture reuses a free block only where
  one is at least as large as its request (the allocator never joins two
  segments), so graphs with small buffers captured before one with large
  ones still add to it.
- A replay runs no Python, so the kernels' launch counters
  (``ops/trilerp_kernels.COUNTERS``, ``ops/packed_kernels.COUNTERS``) get
  each graph's launches, as its capture counted them, once per replay; the
  warm-up's launches are taken out again.
- Capture or replay that fails raises: nothing falls back to eager.
"""
from __future__ import annotations

import contextlib
import ctypes
import time
import weakref
from collections import Counter
from functools import partial
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.transfer import to_device
from ..models.decoders import tree_leaves, tree_map
from ..ops import packed_kernels, trilerp_kernels
from ..ops.trilinear import get_sampler_route
from . import keyframes as kf_mod
from .mapper import (
    STAGE_ORDER,
    KfSlice,
    PassInputs,
    ProgConfig,
    Schedule,
    Segment,
    flat_views,
    init_opt_state,
    lr_zero,
    make_pass_params,
    mapping_grads,
    mapping_iteration,
    mapping_step,
    new_flat,
    new_pass_tables,
    schedule_lrs,
    start_pass,
)
from .tracker import TrackConfig, new_solve_state, solve_result, start_solve, track_iteration

_COUNTERS = (trilerp_kernels.COUNTERS, packed_kernels.COUNTERS)
_LIBCUDA = None
_SHARED: Dict[bool, "Programs"] = {}
_CARDS: Dict[torch.device, "CardGraphs"] = {}


class Capture(NamedTuple):
    """One captured graph: what it runs, the seconds its warm-up and capture
    took, its node count and the kernel launches of one replay."""

    signature: str
    seconds: float
    nodes: int
    launches: Dict[str, int]


def launch_counts():
    """A reading of every kernel's launch counters (one per module)."""
    return [trilerp_kernels.read_counts(c) for c in _COUNTERS]


def restore_counts(reading) -> None:
    """Set the launch counters to a :func:`launch_counts` reading."""
    for counters, counts in zip(_COUNTERS, reading):
        for table in counters.values():
            if isinstance(table, Counter):
                table.clear()
            else:
                table.update(dict.fromkeys(table, 0))
        trilerp_kernels.add_counts(counters, counts)


def launch_delta(after, before):
    """What was launched between two :func:`launch_counts` readings."""
    return [{name: a[name] - b[name] for name in a} for a, b in zip(after, before)]


def add_replays(delta, times: int) -> None:
    """Count ``times`` replays of a graph whose capture launched ``delta``
    (per module of ``_COUNTERS``, a difference of two readings)."""
    for counters, d in zip(_COUNTERS, delta):
        trilerp_kernels.add_counts(counters, d, times)


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a graph captured with ``keep_graph=True``
    (``cuGraphGetNodes`` of ``libcuda``)."""
    global _LIBCUDA
    if _LIBCUDA is None:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuGraphGetNodes.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
        lib.cuGraphGetNodes.restype = ctypes.c_int
        _LIBCUDA = lib
    n = ctypes.c_size_t(0)
    rc = _LIBCUDA.cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    return n.value


def _copy_tree_(dst, src) -> None:
    dst, src = tree_leaves(dst), tree_leaves(src)
    if len(dst) != len(src):
        raise ValueError(f"{len(src)} tensors for {len(dst)} buffers")
    torch._foreach_copy_(dst, src)


def clone_tree(tree):
    """Detached copies of a tree's tensors, in the same structure."""
    return tree_map(lambda t: t.detach().clone(), tree)


def indexed_device(device) -> torch.device:
    """``device`` with its index (a graph, its pool and stream are per card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _shapes(tree) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tree_leaves(tree))


def resolve_capture(capture: Optional[bool], devices) -> bool:
    """Whether programs on ``devices`` run as CUDA graphs: ``None`` on CUDA
    devices and not on the CPU; ``False`` runs them eagerly (on a card, only
    to compare the two); ``True`` with a device that is not CUDA raises."""
    devices = [torch.device(d) for d in devices]
    on_cards = all(d.type == "cuda" for d in devices)
    if capture is None:
        return on_cards
    if capture and not on_cards:
        raise ValueError(
            f"capture=True needs CUDA devices, got {[str(d) for d in devices]}: "
            "CUDA graphs run on a card, the CPU runs the programs eagerly"
        )
    return bool(capture)


class CardGraphs:
    """What the graphs of one card share in this process: the stream they
    are captured on (the allocator keeps free blocks per stream, so one
    pool needs one stream to reuse them) and the memory pool of the live
    graphs (``graphs``). When none is left, the allocator frees the pool,
    and the next capture opens a new one."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.pool: Optional[tuple] = None
        self.pools: List[tuple] = []
        self.graphs: "weakref.WeakSet[torch.cuda.CUDAGraph]" = weakref.WeakSet()

    def capture_pool(self) -> tuple:
        """The pool for the next capture."""
        if not self.graphs:
            self.pool = tuple(torch.cuda.graph_pool_handle())
            self.pools.append(self.pool)
        return self.pool


def card_graphs(device: torch.device) -> CardGraphs:
    """The capture stream and graph pool of ``device`` (a card, with its
    index) for the whole process, made on first use."""
    if device not in _CARDS:
        with torch.cuda.device(device):
            _CARDS[device] = CardGraphs(device)
    return _CARDS[device]


def pool_bytes(devices=None) -> int:
    """Device memory that the graph pools of ``devices`` (by default every
    card) hold: the allocator's segments of each pool this process opened
    there, for measurement."""
    cards = [c for d, c in _CARDS.items() if devices is None or d in devices]
    pools = {p for c in cards for p in c.pools}
    if not pools:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in pools)


def shared_programs(device, capture: Optional[bool] = None) -> "Programs":
    """The process-wide programs of ``capture`` (:func:`resolve_capture` on
    ``device``), where ``render_image`` and the mesher keep their graphs."""
    capture = resolve_capture(capture, [device])
    if capture not in _SHARED:
        _SHARED[capture] = Programs(capture)
    return _SHARED[capture]


class Programs:
    """A set of programs: mapping programs keyed on (device, sampler route,
    ``ProgConfig``, window size, grid shapes), tracking programs on (device,
    route, ``TrackConfig``, grid shapes), static programs on (name, device,
    route, what their function reads besides its arguments, the arguments'
    shapes), and the pretraining programs that ``pretrain_decoders`` keys;
    with ``capture`` each holds CUDA graphs. ``captures`` records every
    graph captured."""

    def __init__(self, capture: bool):
        self.capture = capture
        self.captures: List[Capture] = []
        self.mapping: Dict[tuple, MappingProgram] = {}
        self.tracking: Dict[tuple, TrackProgram] = {}
        self.static: Dict[tuple, StaticProgram] = {}
        self.pretraining: Dict[tuple, object] = {}

    def static_program(self, name: str, key: tuple, device, fn: Callable, fixed=(),
                       args=()) -> "StaticProgram":
        """The :class:`StaticProgram` of ``fn`` on ``device`` for these
        arguments' shapes, made on first use. ``name`` and ``key`` hold
        every value that ``fn`` reads besides its arguments; ``name`` (its
        first word says what it runs) names it in the capture records."""
        device = indexed_device(device)
        full = (name, device, get_sampler_route(), key, _shapes((fixed, args)))
        prog = self.static.get(full)
        if prog is None:
            prog = self.static[full] = StaticProgram(
                self, device, f"{name} route={get_sampler_route()} {device}", fn, fixed, args)
        return prog

    def _overlap(self, intr, c2w, depth, color, kf_c2w, i, j) -> "StaticProgram":
        return self.static_program(
            f"keyframe_overlap K={kf_c2w.shape[0]}", (intr,), c2w.device,
            lambda *a: kf_mod.keyframe_overlap_percentages(intr, *a),
            args=(c2w, depth, color, kf_c2w, i, j))

    def overlap_percentages(self, intr, c2w, depth, color, kf_c2w, i, j) -> torch.Tensor:
        """:func:`~.keyframes.keyframe_overlap_percentages` as a program of
        this system, a new tensor ``[K]``."""
        prog = self._overlap(intr, c2w, depth, color, kf_c2w, i, j)
        return prog.run(c2w, depth, color, kf_c2w, i, j).clone()

    def _frustum(self, poses, pose_valid, depths, intr, bounds, grids) -> "StaticProgram":
        # The bounds are constants of the program (host numbers, as
        # frustum_voxel_mask reads them); the grids lend their shapes.
        bkey = tuple((lvl, tuple(float(x) for x in np.asarray(b).ravel()))
                     for lvl, b in bounds.items())
        meta = {lvl: torch.empty(g.shape, dtype=g.dtype, device="meta")
                for lvl, g in grids.items()}
        return self.static_program(
            f"frustum_masks F={poses.shape[0]}", (intr, bkey, _shapes(meta)), poses.device,
            lambda *a: kf_mod.frustum_masks_for_levels(*a, intr, bounds, meta),
            args=(poses, pose_valid, depths))

    def frustum_masks(self, poses, pose_valid, depths, intr, bounds,
                      grids) -> Dict[str, torch.Tensor]:
        """:func:`~.keyframes.frustum_masks_for_levels` as a program of this
        system (one per window size, bounds and grid shapes), new tensors."""
        prog = self._frustum(poses, pose_valid, depths, intr, bounds, grids)
        return clone_tree(prog.run(poses, pose_valid, depths))

    def warm_keyframe_programs(self, intr, bounds, grids, kf_c2w, windows,
                               overlap: bool) -> None:
        """Make the keyframe programs a run meets, and with ``capture`` capture
        them, on dummy inputs: the overlap of ``kf_c2w``'s keyframes (with
        ``overlap``) and the frustum masks of each window size in
        ``windows``. Draws nothing."""
        dev = kf_c2w.device
        eye = torch.eye(4, device=dev)
        if overlap:
            ij = torch.zeros((kf_mod.OVERLAP_PIXELS,), dtype=torch.long, device=dev)
            self._overlap(intr, eye, torch.ones((intr.H, intr.W), device=dev),
                          torch.ones((intr.H, intr.W, 3), device=dev), kf_c2w, ij, ij).warm()
        for F in windows:
            valid = torch.ones((F,), dtype=torch.bool, device=dev)
            self._frustum(eye.expand(F, 4, 4), valid, torch.ones((F, intr.H, intr.W), device=dev),
                          intr, bounds, grids).warm()

    def map_program(self, signature, device, pcfg: ProgConfig, intr, rcfg, grids,
                    decoders, cams, rows: int, kf: Optional[KfSlice] = None
                    ) -> "MappingProgram":
        """The program of this pass's signature (``signature`` names it in
        the capture records), made on first use from these parameters'
        shapes with room for ``rows`` rows; ``kf`` is the rank's slice of a
        pass on a mesh with one map block."""
        key = (indexed_device(device), get_sampler_route(), pcfg, cams.shape[0],
               tuple(tuple(g.shape) for g in grids.values()), kf and kf.key)
        prog = self.mapping.get(key)
        if prog is None:
            prog = self.mapping[key] = MappingProgram(
                self, key[0], signature, pcfg, intr, rcfg, grids, decoders, cams, rows, kf)
        return prog

    def track_program(self, device, cfg: TrackConfig, intr, rcfg, params,
                      grids) -> "TrackProgram":
        """The pose solve's program on ``device``, made on first use."""
        key = (indexed_device(device), get_sampler_route(), cfg,
               tuple(tuple(g.shape) for g in grids.values()))
        prog = self.tracking.get(key)
        if prog is None:
            prog = self.tracking[key] = TrackProgram(
                self, key[0], cfg, intr, rcfg, params, grids)
        return prog

    def _device_context(self, device: torch.device):
        return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()

    def capture_graph(self, device: torch.device, signature: str, body: Callable[[], None],
                      buffers: Callable[[], List[torch.Tensor]]):
        """A graph of one call of ``body``, which writes only ``buffers()``,
        captured into the card's pool; returns ``(graph, launches of one
        replay)``. The warm-up call's effects on the buffers that existed
        before it, and on the launch counters, are undone. Raises if the
        capture made a buffer: it would lie in the shared pool."""
        t0 = time.perf_counter()
        card = card_graphs(device)
        stream = card.stream
        before = launch_counts()
        mutable = buffers()
        saved = [t.detach().clone() for t in mutable]
        with torch.cuda.device(device):
            current = torch.cuda.current_stream(device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                body()
            current.wait_stream(stream)
            warm = launch_counts()
            made = [t.data_ptr() for t in buffers()]
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph, pool=card.capture_pool(), stream=stream,
                                  capture_error_mode="thread_local"):
                body()
            graph.instantiate()
            card.graphs.add(graph)
            if [t.data_ptr() for t in buffers()] != made:
                raise RuntimeError(f"capture of {signature}: a buffer was made in the "
                                   "capture, in the card's shared graph pool")
            delta = launch_delta(launch_counts(), warm)
            restore_counts(before)
            with torch.no_grad():
                for t, s in zip(mutable, saved):
                    t.copy_(s)
            torch.cuda.synchronize(device)
        launches = {k: n for d in delta for k, n in d.get("LAUNCHES", {}).items()}
        self.captures.append(Capture(signature, time.perf_counter() - t0,
                                     graph_nodes(graph), launches))
        return graph, delta


class MappingProgram:
    """One mapping signature on one device: the pass's parameters, Adam
    moments, inputs and tables as static buffers (``pp``, ``opt``, ``inp``,
    ``tab``), and per (stage, zero learning rates) the graphs of the
    segments of an iteration (:class:`~.mapper.Segment`), replayed in order
    with the eager collective that precedes each one:

    - one segment, :func:`~.mapper.mapping_iteration`, without a mesh;
    - with a :class:`~.mapper.KfSlice` of one map block that sums over
      other ranks, two: the first half into a static ``flat`` buffer of the
      loss and gradients (:func:`~.mapper.mapping_grads`), then the kf
      all_reduce of ``flat``, then the second half on it
      (:func:`~.mapper.mapping_step`);
    - with more than one map block, the segments of the slice's
      ``segments(program)`` (``parallel/sharded_mapper.MapSegments``): 4
      or 5 graphs around 3 or 4 collectives.

    Which gradients a stage has (the flat layout) is known from the first
    call of the segment that computes them. ``capture`` off runs the same
    segment bodies eagerly."""

    def __init__(self, programs: Programs, device: torch.device, signature, pcfg: ProgConfig,
                 intr, rcfg, grids, decoders, cams, rows: int, kf: Optional[KfSlice] = None):
        self.programs, self.device, self.signature = programs, device, signature
        self.pcfg, self.intr, self.rcfg, self.kf = pcfg, intr, rcfg, kf
        self.pp = make_pass_params(grids, decoders, cams, pcfg)
        self.opt = init_opt_state(self.pp)
        F = cams.shape[0]
        z = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
        self.bounds: Dict[str, torch.Tensor] = {}
        self.scene_bound = z(3, 2)
        self.inp = PassInputs(
            bounds=self.bounds, scene_bound=self.scene_bound,
            colors=z(F, intr.H, intr.W, 3), depths=z(F, intr.H, intr.W),
            frame_valid=z(F, dtype=torch.bool), cam_fixed=z(F, dtype=torch.bool),
            masks=({lvl: z(*g.shape[:3], 1) for lvl, g in grids.items()}
                   if pcfg.frustum else None),
        )
        self.tab = new_pass_tables(rows, pcfg.n_pixels, device)
        self.flat = (new_flat(self.pp.leaves)
                     if kf is not None and (kf.reduce is not None or kf.segments is not None)
                     else None)
        self.layouts: Dict[tuple, Tuple[bool, ...]] = {}
        self.graphs: Dict[tuple, tuple] = {}
        self.segments = kf.segments(self) if kf is not None and kf.segments is not None else None

    @property
    def split(self) -> bool:
        """Whether an iteration is more than one segment (on a mesh)."""
        return self.flat is not None

    def _load(self, grids, decoders, cams, masks, bounds, scene_bound, colors, depths,
              frame_valid: np.ndarray, cam_fixed: np.ndarray, lrs: np.ndarray,
              pixels: torch.Tensor) -> None:
        """Copy a pass's inputs into the buffers, zero the moments."""
        n = lrs.shape[0]
        if n > self.tab.lrs.shape[0]:
            # The graphs read the old tables: capture them again.
            self.tab = new_pass_tables(n, self.pcfg.n_pixels, self.device)
            self.graphs.clear()
        with torch.no_grad():
            _copy_tree_(self.pp.params, {"grids": grids, "decoders": decoders, "cams": cams})
            torch._foreach_zero_(self.opt.mu + self.opt.nu)
            if not self.bounds:
                self.bounds.update({k: torch.empty_like(v, device=self.device)
                                    for k, v in bounds.items()})
            _copy_tree_(self.bounds, bounds)
            self.scene_bound.copy_(scene_bound)
            self.inp.colors.copy_(colors)
            self.inp.depths.copy_(depths)
            self.inp.frame_valid.copy_(to_device(frame_valid, self.device))
            self.inp.cam_fixed.copy_(to_device(cam_fixed, self.device))
            if self.inp.masks is not None:
                _copy_tree_(self.inp.masks, masks)
        start_pass(self.tab, lrs, pixels)
        self.opt.count = 0

    def plan(self, stage: str, zero: Tuple[bool, ...]) -> List[Segment]:
        """The segments of an iteration of (``stage``, ``zero``)."""
        if self.segments is not None:
            return self.segments.plan(stage, zero)
        if self.flat is None:
            return [Segment("", partial(self._iterate, stage, zero))]
        kf = ",".join(str(k) for k in self.kf.key)
        return [
            Segment(f" kf={kf} grads", partial(self._grads, stage, zero)),
            Segment(f" kf={kf} step", partial(self._step, stage, zero),
                    before=partial(self._reduce, stage, zero)),
        ]

    def _graphs(self, stage: str, zero: Tuple[bool, ...]):
        """The graphs of the segments of (``stage``, ``zero``), captured at
        first use, in order."""
        key = (stage, zero)
        if key not in self.graphs:
            F, refine, ba = self.signature
            self.graphs[key] = tuple(
                self.programs.capture_graph(
                    self.device,
                    f"map F={F} refine={int(refine)} ba={int(ba)} stage={stage}{seg.name} "
                    f"route={get_sampler_route()} {self.device}",
                    seg.body, self.buffers)
                for seg in self.plan(stage, zero))
        return self.graphs[key]

    def buffers(self) -> List[torch.Tensor]:
        """What an iteration writes: the parameters, the moments, the
        losses, the step counter, the flat buffer on a mesh and the
        segments' buffers with more than one map block."""
        return [*self.pp.leaves, *self.opt.mu, *self.opt.nu, self.tab.losses, self.tab.step,
                *([self.flat] if self.flat is not None else []),
                *(self.segments.buffers() if self.segments is not None else [])]

    def _iterate(self, stage: str, zero: Tuple[bool, ...]) -> None:
        mapping_iteration(self.pp, self.opt, self.tab, self.inp, self.intr, self.pcfg,
                          self.rcfg, stage, zero, kf=self.kf)

    def _grads(self, stage: str, zero: Tuple[bool, ...]) -> None:
        """The first half into ``flat``; records the stage's layout."""
        _, grads, _ = mapping_grads(self.pp, self.tab, self.inp, self.intr, self.pcfg,
                                    self.rcfg, stage, self.kf, self.flat)
        self.layouts[stage, zero] = tuple(g is not None for g in grads)

    def _reduce(self, stage: str, zero: Tuple[bool, ...]) -> None:
        """The kf all_reduce of the part of ``flat`` that the stage uses."""
        _, _, used = flat_views(self.flat, self.pp.leaves, self.layouts[stage, zero])
        self.kf.reduce(self.flat[:used])

    def _step(self, stage: str, zero: Tuple[bool, ...]) -> None:
        """The second half on ``flat``, summed over the kf group."""
        loss, grads, _ = flat_views(self.flat, self.pp.leaves, self.layouts[stage, zero])
        mapping_step(self.pp, self.opt, self.tab, self.inp, loss, grads, zero)

    @staticmethod
    def _runs(sched: Schedule, lrs: np.ndarray):
        """The pass's rows as runs of one (stage, zero learning rates)."""
        runs: List[list] = []
        for r in range(len(sched)):
            key = (STAGE_ORDER[int(sched.stage_ids[r])], lr_zero(lrs[r]))
            if runs and runs[-1][0] == key:
                runs[-1][1] += 1
            else:
                runs.append([key, 1])
        return runs

    def run(self, grids, decoders, cams, masks, bounds, scene_bound, colors, depths,
            frame_valid: np.ndarray, cam_fixed: np.ndarray, sched: Schedule,
            pixels: torch.Tensor):
        """One pass over every row of ``sched`` (all active) on the draws
        ``pixels [rows, 3, n_pixels]``; returns new ``(grids, decoders, cams,
        losses)``. The arguments are not modified."""
        lrs = schedule_lrs(sched)
        self._load(grids, decoders, cams, masks, bounds, scene_bound, colors, depths,
                   frame_valid, cam_fixed, lrs, pixels)
        with self.programs._device_context(self.device):
            for (stage, zero), count in self._runs(sched, lrs):
                plan = self.plan(stage, zero)
                graphs = self._graphs(stage, zero) if self.programs.capture else None
                for _ in range(count):
                    for k, seg in enumerate(plan):
                        if seg.before is not None:
                            seg.before()
                        if graphs is None:
                            seg.body()
                        else:
                            graphs[k][0].replay()
                for _, delta in graphs or ():
                    add_replays(delta, count)
        self.opt.count = len(sched)
        out = clone_tree(self.pp.params)
        return out["grids"], out["decoders"], out["cams"], self.tab.losses[:len(sched)].clone()

    def warm(self, grids, decoders, cams, masks, bounds, scene_bound, colors, depths,
             frame_valid: np.ndarray, cam_fixed: np.ndarray, sched: Schedule,
             pixels: torch.Tensor) -> None:
        """Capture the graphs of every run of ``sched`` (with capture on) on
        these inputs, without running the pass; no collective runs."""
        lrs = schedule_lrs(sched)
        self._load(grids, decoders, cams, masks, bounds, scene_bound, colors, depths,
                   frame_valid, cam_fixed, lrs, pixels)
        if self.programs.capture:
            for (stage, zero), _ in self._runs(sched, lrs):
                self._graphs(stage, zero)


class TrackProgram:
    """The pose solve on one device: a copy of the map, the frame and the
    :class:`~.tracker.SolveState` as static buffers, and one graph of
    :func:`~.tracker.track_iteration`."""

    def __init__(self, programs: Programs, device: torch.device, cfg: TrackConfig, intr,
                 rcfg, params, grids):
        self.programs, self.device, self.cfg, self.intr, self.rcfg = (
            programs, device, cfg, intr, rcfg)
        self.params, self.grids = clone_tree(params), clone_tree(grids)
        self.bounds: Dict[str, torch.Tensor] = {}
        self.scene_bound = torch.zeros((3, 2), device=device)
        self.color = torch.zeros((intr.H, intr.W, 3), device=device)
        self.depth = torch.zeros((intr.H, intr.W), device=device)
        self.st = new_solve_state(cfg, cfg.iters, device)
        self.graph: Optional[tuple] = None

    def _load(self, params, grids, bounds, scene_bound, color, depth, init, pixels) -> None:
        with torch.no_grad():
            _copy_tree_((self.params, self.grids), (params, grids))
            if not self.bounds:
                self.bounds.update({k: torch.empty_like(v, device=self.device)
                                    for k, v in bounds.items()})
            _copy_tree_(self.bounds, bounds)
            self.scene_bound.copy_(scene_bound)
            self.color.copy_(color)
            self.depth.copy_(depth)
        start_solve(self.st, init, pixels)

    def _iterate(self) -> None:
        track_iteration(self.params, self.grids, self.bounds, self.scene_bound, self.intr,
                        self.color, self.depth, self.st, self.cfg, self.rcfg)

    def buffers(self) -> List[torch.Tensor]:
        """What an iteration writes: the solve's state."""
        st = self.st
        return [st.x, st.losses, st.step] + (
            [] if st.mu is None else [st.mu, st.nu, st.best, st.best_loss])

    def _graph(self):
        if self.graph is None:
            self.graph = self.programs.capture_graph(
                self.device,
                f"track {self.cfg.method} iters={self.cfg.iters} "
                f"route={get_sampler_route()} {self.device}",
                self._iterate, self.buffers,
            )
        return self.graph

    def run(self, params, grids, bounds, scene_bound, color, depth, init,
            pixels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Solve the pose from ``init [4, 4]`` on the draws ``pixels [iters,
        2, P]``; returns new ``(c2w [4, 4], losses [iters])``."""
        self._load(params, grids, bounds, scene_bound, color, depth, init, pixels)
        with self.programs._device_context(self.device):
            if self.programs.capture:
                graph, delta = self._graph()
                for _ in range(self.cfg.iters):
                    graph.replay()
                add_replays(delta, self.cfg.iters)
            else:
                for _ in range(self.cfg.iters):
                    self._iterate()
            return solve_result(self.st)

    def warm(self, params, grids, bounds, scene_bound, color, depth, init,
             pixels: torch.Tensor) -> None:
        """Capture the graph (with capture on) on these inputs, without
        solving."""
        self._load(params, grids, bounds, scene_bound, color, depth, init, pixels)
        if self.programs.capture:
            self._graph()


class StaticProgram:
    """A function without state of its own, ``fn(*fixed, *args)`` under
    ``torch.no_grad``, over static copies of its arguments: :meth:`load`
    copies in ``fixed``, the arguments of many calls (a map), :meth:`run`
    the ``args`` of one call (a chunk of rays or points). Its outputs (a
    tensor, or a dict, list or tuple of them) land in static outputs, which
    :meth:`run` returns and the next call overwrites. With ``capture``, one
    graph of a call."""

    def __init__(self, programs: Programs, device: torch.device, signature: str,
                 fn: Callable, fixed, args):
        self.programs, self.device, self.signature, self.fn = programs, device, signature, fn
        self.fixed, self.args = clone_tree(fixed), clone_tree(args)
        self.out = None
        self.graph: Optional[tuple] = None

    def _body(self) -> None:
        with torch.no_grad():
            out = self.fn(*self.fixed, *self.args)
            if self.out is None:  # the first call: eager, or a capture's warm-up
                self.out = clone_tree(out)
            else:
                _copy_tree_(self.out, out)

    def buffers(self) -> List[torch.Tensor]:
        """What a call writes: the static outputs (none before the first
        call, which makes them)."""
        return tree_leaves(self.out) if self.out is not None else []

    def _graph(self):
        if self.graph is None:
            self.graph = self.programs.capture_graph(self.device, self.signature,
                                                     self._body, self.buffers)
        return self.graph

    def load(self, *fixed) -> None:
        """Copy in the arguments that stay for the next calls."""
        with torch.no_grad():
            _copy_tree_(self.fixed, fixed)

    def run(self, *args):
        """One call on ``args``: the static outputs."""
        with torch.no_grad():
            _copy_tree_(self.args, args)
        with self.programs._device_context(self.device):
            if self.programs.capture:
                graph, delta = self._graph()
                graph.replay()
                add_replays(delta, 1)
            else:
                self._body()
        return self.out

    def warm(self) -> None:
        """Capture the graph (with capture on) on the buffers as they are."""
        if self.programs.capture:
            self._graph()
