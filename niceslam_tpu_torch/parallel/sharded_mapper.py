"""The Z-sharded mapping program: map-volume x ray-batch parallelism.

The counterpart of ``niceslam_tpu/parallel/sharded_mapper.py``. It runs the
port's :func:`~..slam.mapper.run_schedule` row by row, on every rank of a
``('map', 'kf')`` mesh (``parallel/mesh.py``), with three changes:

- the halo sampler (``grid/shard.py``) takes the place of ``sample_grid``
  while the grids are this rank's Z blocks (with ``n_map = 1`` the block
  is the grid and ``sample_grid`` stays);
- each rank draws the whole ``n_pixels`` ray set from the same generator
  state and evaluates its ``kf`` slice (``mapping_loss``'s ``ray_shard``),
  so the slices over ``kf`` are the unsharded ray set;
- after ``autograd.grad``, the loss and the grid-block, decoder and camera
  gradients are written into one flat buffer and summed in place over the
  kf group by one ``all_reduce`` (:func:`reduce_over_kf_`). Grid blocks
  need nothing over ``map``: each rank owns its block, and the halo rows'
  gradients went home inside the sampler's backward.
  Decoder and camera gradients are already the same over ``map``, because
  the features were summed there before the decoders saw them.

Adam then steps the local grid blocks and the replicated decoders and
cameras, with the masks and per-group learning rates of ``adam_update``.
Every rank of a kf group gets the same summed gradient, so the replicas stay
equal bit for bit.

A rank's changes to an iteration are its :func:`kf_slice`. The system runs
every pass as a program (``slam/programs.py``), on a card as CUDA graphs
replayed around eager collectives (gloo cannot be captured, and no graph
holds a collective):

- with ``n_map = 1`` (the shipped mesh, ``configs/apartment_multihost.yaml``)
  the iteration splits at its one all_reduce into two halves
  (``slam/mapper.py``: ``mapping_grads``, ``mapping_step``);
- with ``n_map > 1`` the halo sampler's collectives are hoisted out of it
  to a fixed set of points in the iteration, 3 all_reduces (4 with
  ``n_kf > 1``, one more with ``rendering.N_importance > 0``) whatever the
  number of levels, with a graph between each two (:class:`MapSegments`).

:func:`make_sharded_run_schedule` runs the pass eagerly with the
collectives inside the sampler's forward and backward: the reference that
the program is held to. With ``N_importance > 0`` its first point set's
collectives run forward only: the loss sees that set through its detached
weights, so nothing differentiates it.

Grids must be Z-padded so that each level divides ``n_map``:
:func:`pad_grid_for_sharding` replicates the last row and extends the z
bound by the same number of voxels, which keeps every consumer's
world-to-voxel map of the real rows (tracker, renderer, mesher).
"""
from __future__ import annotations

import contextlib
from functools import partial
from typing import Dict, List, Optional, Tuple

import torch

from ..core.sampling import points_along_rays
from ..grid.shard import NextFirstRow, SlotRows, SplitSample, sample_grid_sharded
from ..models.decoders import STAGE_LEVELS
from ..ops.trilinear import get_sampler_route, override_sampler, voxel_coords
from ..render.renderer import evaluate_z_vals, importance_z_vals, ray_samples
from ..slam.mapper import (
    STAGE_ORDER,
    KfSlice,
    Segment,
    flat_views,
    mapping_loss,
    mapping_rays,
    mapping_step,
    pack_grads_,
    run_schedule,
)
from .mesh import MapKfMesh, all_reduce_


def pad_grid_for_sharding(
    grid: torch.Tensor, bound: torch.Tensor, n_map: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge-replicate Z up to a multiple of ``n_map`` and raise the z bound
    by ``p`` voxels, ``(hi - lo) / (Z - 1)`` each (align_corners): the
    world-to-voxel map of the real rows stays as it was, and samples past
    the old border read replica rows, the border clamp's values. A grid
    whose Z divides ``n_map`` comes back as it is."""
    z = grid.shape[0]
    p = -(-z // n_map) * n_map - z
    if p == 0:
        return grid, bound
    grid = torch.cat([grid, grid[-1:].expand((p,) + tuple(grid.shape[1:]))])
    voxel = (bound[2, 1] - bound[2, 0]) / (z - 1)
    bound = bound.clone()
    bound[2, 1] = bound[2, 1] + p * voxel
    return grid, bound


# The levels of mapping_loss's TV term.
TV_LEVELS = ("middle", "fine")


def tv_level(g: torch.Tensor, nxt: Optional[torch.Tensor], mesh: MapKfMesh) -> torch.Tensor:
    """This rank's share of one level's TV sum (``mapping_loss``'s three
    means on the whole grid) from its block ``g``: the local y/x/z squared
    differences, and with ``nxt`` (the next block's first row, ``[1, Y, X,
    C]``) the one z difference across the border, which the last block
    does not have."""
    zb, Y, X, C = g.shape
    Z = zb * mesh.n_map
    sy = torch.sum(torch.square(g[:, 1:] - g[:, :-1]))
    sx = torch.sum(torch.square(g[:, :, 1:] - g[:, :, :-1]))
    sz = torch.sum(torch.square(g[1:] - g[:-1]))
    if nxt is not None:
        inner = 0.0 if mesh.map_i == mesh.n_map - 1 else 1.0
        sz = sz + inner * torch.sum(torch.square(nxt - g[-1:]))
    return (
        sy / (Z * (Y - 1) * X * C)
        + sx / (Z * Y * (X - 1) * C)
        + sz / ((Z - 1) * Y * X * C)
    )


def tv_term(grids_blk: Dict[str, torch.Tensor], mesh: MapKfMesh) -> torch.Tensor:
    """The TV sum of ``mapping_loss`` on the whole middle and fine grids,
    computed from this rank's blocks, divided by ``n_kf``.

    The gradient is exact: the local terms of :func:`tv_level`, whose
    border difference reads the next block's first row through
    :class:`~..grid.shard.NextFirstRow` (its backward sends that row's
    gradient home). The value is the whole grid's, summed over the map
    group without a gradient. Every rank of a kf group adds the same term,
    and the kf all_reduce of the gradients sums ``n_kf`` copies, hence the
    division.
    """
    tv = 0.0
    for lvl in TV_LEVELS:
        g = grids_blk[lvl]
        nxt = NextFirstRow.apply(g, mesh) if mesh.n_map > 1 else None
        local = tv_level(g, nxt, mesh)
        full = all_reduce_(local.detach().clone(), mesh.map_group, mesh.n_map)
        tv = tv + local + (full - local.detach())
    return tv / mesh.n_kf


def reduce_over_kf_(flat: torch.Tensor, mesh: MapKfMesh) -> None:
    """Sum ``flat`` (the loss and the gradients that are not ``None``, laid
    out by ``slam/mapper.pack_grads_``) in place over the kf group: one
    all_reduce. The current stream is ordered after the sum when this
    returns, over gloo and NCCL alike (``dist.all_reduce`` waits on its
    work), so a graph replayed next reads the sum."""
    all_reduce_(flat, mesh.kf_group, mesh.n_kf)


def kf_slice(mesh: MapKfMesh, n_pixels: int) -> KfSlice:
    """This rank's :class:`~..slam.mapper.KfSlice` of a pass of
    ``n_pixels`` rays: rays ``[kf_i * n, (kf_i + 1) * n)`` of each draw,
    ``n = n_pixels / n_kf``, the TV term of :func:`tv_term`,
    :func:`reduce_over_kf_` (none with one kf rank) and, with more than one
    map block, the program's iteration as :class:`MapSegments`."""
    if n_pixels % mesh.n_kf:
        raise ValueError(f"mapping.pixels={n_pixels} must divide the kf axis ({mesh.n_kf})")
    n_local = n_pixels // mesh.n_kf
    return KfSlice(
        ray_shard=(mesh.kf_i * n_local, n_local), tv_term=partial(tv_term, mesh=mesh),
        reduce=partial(reduce_over_kf_, mesh=mesh) if mesh.n_kf > 1 else None,
        key=(mesh.n_map, mesh.n_kf, mesh.map_i, mesh.kf_i),
        segments=partial(MapSegments, mesh) if mesh.n_map > 1 else None,
    )


def map_sharded_slice(mesh: MapKfMesh, n_pixels: int) -> KfSlice:
    """A rank's slice of the map-sharded program (``MapSegments``) on any
    mesh, one map block included: ``kf_slice`` gives it only to more than
    one map block."""
    return kf_slice(mesh, n_pixels)._replace(segments=partial(MapSegments, mesh))


def make_sharded_run_schedule(mesh: MapKfMesh):
    """A drop-in ``run_schedule`` (same arguments) for passes whose
    ``pp`` grids and ``grid_masks`` are this rank's Z blocks of grids padded
    with :func:`pad_grid_for_sharding`; ``bounds`` are the padded grids'.
    It runs eagerly, with the halo sampler's collectives inside its
    forward and backward: the reference that the system's mapping program
    (:class:`MapSegments`, ``slam/programs.py``) is held to."""

    def sharded_run_schedule(pp, opt_state, sched, grid_masks, bounds, scene_bound,
                             intr, colors, depths, frame_valid, cam_fixed, pcfg,
                             rcfg, gen=None, pixels=None):
        kf = kf_slice(mesh, pcfg.n_pixels)
        # One map block is the whole grid: the plain sampler is the halo
        # sampler without its collectives.
        sampler = (
            override_sampler(partial(sample_grid_sharded, mesh=mesh))
            if mesh.n_map > 1 else contextlib.nullcontext()
        )
        with sampler:
            return run_schedule(
                pp, opt_state, sched, grid_masks, bounds, scene_bound, intr, colors,
                depths, frame_valid, cam_fixed, pcfg, rcfg, gen=gen, pixels=pixels, kf=kf,
            )

    return sharded_run_schedule


class MapSegments:
    """The iteration of a ``slam.programs.MappingProgram`` on a mesh with
    more than one map block, as segments around a fixed set of
    collectives, so that each segment can be one CUDA graph. The halo
    sampler's collectives (``grid/shard.py``) are hoisted out of it: the
    halo rows depend only on the grid at the start of the iteration, the
    features only on the points, which come from the draw and the cameras
    (with ``rendering.N_importance > 0`` the second point set also from the
    first one's summed features), and the returning gradients only on the
    local backward. Each segment reads its inputs from static buffers, so
    one graph of it serves every row of its stage.
    For stage ``s`` (sampled levels ``STAGE_LEVELS[s]``, halo levels those
    and the TV levels):

    - **G0** (``halo``): every halo level's block row 0 into its own slot
      of one slotted buffer (:class:`~..grid.shard.SlotRows`);
    - **C0**: one all_reduce of it over the map group: the halo rows;
    - **G1** (``sample``): the row's draw, rays, sample depths (kept in
      ``z``), points and voxel coordinates; each sampled level's
      owner-masked local sample (:meth:`~..grid.shard.SplitSample.forward_`,
      K1 or K3 + K4) into one flat feature buffer, and each TV level's
      local sum with its border term (:func:`tv_level`) after them;
    - **C1**: one all_reduce of that buffer over the map group.

    With ``rendering.N_importance > 0``, G1 writes the first point set's
    depths (``z_first``) and its samples into a region of their own, C1
    sums that region, and one segment and one collective follow:

    - **G1b** (``importance``): the first point set decoded from its summed
      features (``nice_forward`` of the stage) and composited, then
      ``render_rays``' importance samples of its detached weights
      (deterministic, as ``mapping_loss`` draws them) merged into ``z``,
      the static buffer that G2 and G3 read; then the local samples of the
      merged point set and the TV sums, into the regions that G1 fills
      without the pass;
    - **C1b**: one all_reduce of those regions.

    Every rank of a map group computes ``z`` from the same summed features
    by the same ops, so the ranks place the samples alike, bit for bit.
    Then, with the pass or without:

    - **G2** (``grads``): ``mapping_loss`` at the depths in ``z`` on the
      summed features (:meth:`~..grid.shard.SplitSample.summed`; one point
      set: ``render_rays`` takes ``z`` as its last evaluation's depths and
      evaluates nothing else), the TV term from the summed values,
      ``autograd.grad`` of the loss for the pass's leaves, the halo rows
      and the points; the leaves' gradients into the program's
      flat buffer (``slam/mapper.pack_grads_``), the halo rows' gradients
      into the slot of their owner in one backward buffer (zeros from the
      last block, whose wrap-around halo is read by nobody), and under BA
      the points' sampler gradient ``d_v`` (this block's share) after them;
    - **C2**: one all_reduce of the backward buffer over the map group;
    - **G3** (``gather``): each halo level's returned gradient onto its
      block's row 0; under BA the summed point gradient through the points
      (the kept sample depths on the rays of the cameras) into the cameras'
      gradient;
    - **C3**: ``reduce_over_kf_`` of the flat buffer, with ``n_kf > 1``;
    - **G4** (``step``): ``mapping_step`` on the flat buffer's views.

    G3 and G4 are one segment when ``n_kf = 1``. So an iteration makes 3
    collectives (4 with ``n_kf > 1``, one more with the importance pass),
    whatever the number of levels: the eager pass
    (:func:`make_sharded_run_schedule`) makes up to four per sampled level
    (halo rows and features forward, point gradients and halo gradient
    back), two more per level for the importance pass's first point set,
    and three per TV level. No tape crosses a segment: G2 evaluates the
    cheap parts of the forward again (rays, points, voxel coordinates) from
    the same buffers, bit for bit the values G1 or G1b used, and G3 the
    rays and points for the cameras' gradient.

    The result equals the eager pass up to the order of float sums: the
    cameras' gradient adds the decoders' direct term and the samplers'
    term after each went through the rays, where autograd adds them at
    the points, and the halo row's gradient lands on row 0 after the
    block's own. ``capture=False`` and the CPU run the same bodies, so a
    graphed pass equals them bit for bit."""

    def __init__(self, mesh: MapKfMesh, prog):
        self.mesh, self.prog = mesh, prog
        rcfg, pcfg = prog.rcfg, prog.pcfg
        blocks = prog.pp.params["grids"]
        dev = prog.flat.device
        n_rays = prog.kf.ray_shard[1]
        n_first = rcfg.n_samples + rcfg.n_surface
        self.importance = rcfg.n_importance > 0
        # The loss's point set: the first one, or the merged one after the
        # importance pass.
        n_pts = n_rays * (n_first + rcfg.n_importance)
        self.level_of = {id(b): lvl for lvl, b in blocks.items()}
        self.tv = tuple(lvl for lvl in TV_LEVELS if lvl in blocks) if pcfg.tv_weight > 0 else ()
        self.need_pts = pcfg.ba
        groups = prog.pp.groups
        self.cam = next((k for k, (kind, _) in enumerate(groups) if kind == "cams"), None)
        self.grid_leaf = {lvl: k for k, (kind, lvl) in enumerate(groups) if kind == "grids"}
        route = get_sampler_route()
        self.samplers = {lvl: SplitSample(b.shape, mesh, n_pts, route, dev)
                         for lvl, b in blocks.items()}
        row_shapes = {lvl: tuple(b.shape[1:]) for lvl, b in blocks.items()}
        self.sampled = {st: tuple(lvl for lvl in STAGE_LEVELS[st] if lvl in blocks)
                        for st in STAGE_ORDER}
        self.halo_levels = {st: tuple(lvl for lvl in blocks
                                      if lvl in self.sampled[st] or lvl in self.tv)
                            for st in STAGE_ORDER}
        width = {st: sum(blocks[lvl][0].numel() for lvl in self.halo_levels[st])
                 for st in STAGE_ORDER}
        n_fwd = {st: sum(n_pts * blocks[lvl].shape[-1] for lvl in self.sampled[st])
                 for st in STAGE_ORDER}
        n_one = {st: sum(n_rays * n_first * blocks[lvl].shape[-1] for lvl in self.sampled[st])
                 if self.importance else 0 for st in STAGE_ORDER}
        n_d = 3 * n_pts if self.need_pts else 0
        zeros = lambda n: torch.zeros((n,), device=dev)  # noqa: E731
        self.halo_buf = zeros(mesh.n_map * max(width.values()))
        self.fwd_buf = zeros(max(n_fwd[st] + n_one[st] for st in STAGE_ORDER) + len(self.tv))
        self.bwd_buf = zeros(mesh.n_map * max(width.values()) + n_d)
        self.z = torch.zeros((n_rays, n_first + rcfg.n_importance), device=dev)
        self.z_first = torch.zeros((n_rays, n_first), device=dev) if self.importance else None
        self.halo, self.grad_rows, self.feats, self.tv_vals, self.d_pts = {}, {}, {}, {}, {}
        self.first, self.fwd_used, self.first_used, self.bwd_used = {}, {}, {}, {}
        for st in STAGE_ORDER:
            self.halo[st] = SlotRows(self.halo_buf, row_shapes, self.halo_levels[st], mesh.n_map)
            self.grad_rows[st] = SlotRows(self.bwd_buf, row_shapes, self.halo_levels[st],
                                          mesh.n_map)
            off, self.feats[st] = 0, {}
            for lvl in self.sampled[st]:
                C = blocks[lvl].shape[-1]
                self.feats[st][lvl] = self.fwd_buf[off:off + n_pts * C].view(n_pts, C)
                off += n_pts * C
            self.tv_vals[st] = self.fwd_buf[off:off + len(self.tv)]
            off = self.fwd_used[st] = off + len(self.tv)
            self.first[st] = {}
            for lvl in self.sampled[st] if self.importance else ():
                C = blocks[lvl].shape[-1]
                self.first[st][lvl] = self.fwd_buf[off:off + n_rays * n_first * C].view(-1, C)
                off += n_rays * n_first * C
            self.first_used[st] = off
            k = mesh.n_map * width[st]
            self.d_pts[st] = self.bwd_buf[k:k + n_d].view(-1, 3)
            self.bwd_used[st] = k + n_d
        self.layouts: Dict[tuple, Tuple[bool, ...]] = {}
        self._live = None  # G2's halo leaves, points and stage, while it runs

    def buffers(self) -> List[torch.Tensor]:
        """The static buffers that the segments write."""
        return [self.halo_buf, self.fwd_buf, self.bwd_buf, self.z,
                *([self.z_first] if self.importance else []),
                *(t for s in self.samplers.values() for t in s.buffers())]

    @property
    def _next(self) -> int:
        return (self.mesh.map_i + 1) % self.mesh.n_map

    def plan(self, stage: str, zero: Tuple[bool, ...]) -> List[Segment]:
        """The segments of an iteration of (``stage``, ``zero``), each with
        the collective before it."""
        m, prog = self.mesh, self.prog
        over_map = lambda t: lambda: all_reduce_(t, m.map_group, m.n_map)  # noqa: E731
        name = f" map={m.n_map}x{m.n_kf} rank={m.map_i},{m.kf_i}"
        segs = [
            Segment(f"{name} halo", partial(self.pack_halo, stage)),
            Segment(f"{name} sample", partial(self.sample, stage),
                    before=over_map(self.halo[stage].buf)),
        ]
        if self.importance:
            used = self.fwd_used[stage]
            segs.append(Segment(f"{name} importance", partial(self.resample, stage),
                                before=over_map(self.fwd_buf[used:self.first_used[stage]])))
        segs.append(Segment(f"{name} grads", partial(self.grads, stage, zero),
                            before=over_map(self.fwd_buf[:self.fwd_used[stage]])))
        after_c2 = over_map(self.bwd_buf[:self.bwd_used[stage]])
        if prog.kf.reduce is None:
            return segs + [Segment(f"{name} gather+step", partial(self.gather_step, stage, zero),
                                   before=after_c2)]
        reduce = lambda: prog.kf.reduce(prog.flat[:self._flat_views(stage, zero)[2]])  # noqa: E731
        return segs + [
            Segment(f"{name} gather", partial(self.gather, stage, zero), before=after_c2),
            Segment(f"{name} step", partial(self.step, stage, zero), before=reduce),
        ]

    def _flat_views(self, stage, zero):
        return flat_views(self.prog.flat, self.prog.pp.leaves, self.layouts[stage, zero])

    def _rays(self):
        """The row's rays (:func:`~..slam.mapper.mapping_rays` of this
        rank's slice), differentiable in the cameras under grad mode."""
        prog = self.prog
        inp = prog.inp
        fidx, i, j = prog.tab.pixels.index_select(0, prog.tab.step)[0]
        return mapping_rays(prog.pp.params["cams"], prog.intr, inp.colors, inp.depths,
                            inp.frame_valid, inp.cam_fixed, fidx, i, j, prog.kf.ray_shard)

    def pack_halo(self, stage: str) -> None:
        """G0."""
        blocks = self.prog.pp.params["grids"]
        self.halo[stage].pack_({lvl: blocks[lvl][:1] for lvl in self.halo_levels[stage]},
                               self.mesh.map_i)

    def _sample_local(self, stage: str, rays_o, rays_d, z, feats) -> None:
        """Each sampled level's owner-masked local sample of the points at
        depths ``z`` into ``feats``."""
        blocks, bounds = self.prog.pp.params["grids"], self.prog.inp.bounds
        pts = points_along_rays(rays_o, rays_d, z).reshape(-1, 3)
        halo = self.halo[stage]
        for lvl, feat in feats.items():
            s, b = self.samplers[lvl], blocks[lvl]
            v = voxel_coords(pts, bounds[lvl], (s.nz,) + tuple(b.shape[1:3]))
            s.forward_(b, halo.row(lvl, self._next), v, feat)

    def _tv_local(self, stage: str) -> None:
        """Each TV level's local sum with its border term."""
        blocks, halo = self.prog.pp.params["grids"], self.halo[stage]
        for k, lvl in enumerate(self.tv):
            self.tv_vals[stage][k].copy_(tv_level(blocks[lvl], halo.row(lvl, self._next),
                                                  self.mesh))

    @torch.no_grad()
    def sample(self, stage: str) -> None:
        """G1."""
        prog = self.prog
        rays_o, rays_d, gt_depth, _, _ = self._rays()
        z = ray_samples(rays_o, rays_d, prog.inp.scene_bound, gt_depth, prog.rcfg)
        if self.importance:
            self.z_first.copy_(z)
            self._sample_local(stage, rays_o, rays_d, z, self.first[stage])
            return
        self.z.copy_(z)
        self._sample_local(stage, rays_o, rays_d, z, self.feats[stage])
        self._tv_local(stage)

    def _sample_first(self, stage, grid, pts, bound):
        """The sampler of G1b's first evaluation (``override_sampler``): the
        summed features of the first point set."""
        return self.first[stage][self.level_of[id(grid)]]

    @torch.no_grad()
    def resample(self, stage: str) -> None:
        """G1b: the first point set decoded from its summed features and
        composited, the merged depths of the importance pass into ``z``
        (``render_rays``' ops, deterministic), then the local samples of the
        merged point set and the TV sums, as G1 writes them without the
        pass."""
        prog = self.prog
        rays_o, rays_d, _, _, _ = self._rays()
        with override_sampler(partial(self._sample_first, stage)):
            out = evaluate_z_vals(prog.pp.params["decoders"], prog.pp.params["grids"],
                                  prog.inp.bounds, prog.inp.scene_bound, rays_o, rays_d,
                                  self.z_first, stage, prog.rcfg)
        self.z.copy_(importance_z_vals(self.z_first, out.weights, prog.rcfg))
        self._sample_local(stage, rays_o, rays_d, self.z, self.feats[stage])
        self._tv_local(stage)

    def _sample_summed(self, grid, pts, bound):
        """The sampler of G2's ``mapping_loss`` (``override_sampler``)."""
        halos, first, stage = self._live
        lvl = self.level_of.get(id(grid))
        if lvl not in self.feats[stage]:
            raise RuntimeError(f"stage {stage} samples {self.sampled[stage]}, not this grid")
        if not first:
            first.extend([pts, pts.detach().requires_grad_(self.need_pts)])
        elif pts is not first[0]:
            raise RuntimeError("G2 evaluates one point set, at the depths in the z buffer")
        s = self.samplers[lvl]
        v = voxel_coords(first[1], bound, (s.nz,) + tuple(grid.shape[1:3]))
        return s.summed(grid, halos[lvl], v, self.feats[stage][lvl])

    def grads(self, stage: str, zero: Tuple[bool, ...]) -> None:
        """G2."""
        prog, m = self.prog, self.mesh
        pp, inp, pcfg = prog.pp, prog.inp, prog.pcfg
        halos = {lvl: self.halo[stage].row(lvl, self._next).detach().requires_grad_()
                 for lvl in self.halo_levels[stage]}
        first: list = []
        self._live = (halos, first, stage)
        try:
            fidx, i, j = prog.tab.pixels.index_select(0, prog.tab.step)[0]
            with override_sampler(self._sample_summed):
                loss = mapping_loss(
                    pp.params, inp.bounds, inp.scene_bound, prog.intr, inp.colors, inp.depths,
                    inp.frame_valid, inp.cam_fixed, fidx, i, j, stage, pcfg.w_color_loss,
                    prog.rcfg, tv_weight=0.0, fs_weight=pcfg.fs_weight, fs_band=pcfg.fs_band,
                    ray_shard=prog.kf.ray_shard, z_vals=self.z)
        finally:
            self._live = None
        if self.tv:
            tv = 0.0
            for k, lvl in enumerate(self.tv):
                local = tv_level(pp.params["grids"][lvl], halos[lvl], m)
                tv = tv + local + (self.tv_vals[stage][k] - local.detach())
            loss = loss + pcfg.tv_weight * (tv / m.n_kf)
        pts = first[1:] if self.need_pts else []
        n, nh = len(pp.leaves), len(halos)
        grads = list(torch.autograd.grad(loss, [*pp.leaves, *halos.values(), *pts],
                                         allow_unused=True))
        leaf_grads = grads[:n]
        if self.cam is not None and leaf_grads[self.cam] is None:
            leaf_grads[self.cam] = torch.zeros_like(pp.leaves[self.cam])
        pack_grads_(prog.flat, loss.detach(), leaf_grads)
        self.layouts[stage, zero] = tuple(g is not None for g in leaf_grads)
        last = m.map_i == m.n_map - 1
        self.grad_rows[stage].pack_(
            {lvl: None if last else g for lvl, g in zip(halos, grads[n:n + nh])}, self._next)
        if self.need_pts:
            with torch.no_grad():
                d = grads[n + nh] if pts else None
                if d is None:
                    self.d_pts[stage].zero_()
                else:
                    self.d_pts[stage].copy_(d)

    def gather(self, stage: str, zero: Tuple[bool, ...]) -> None:
        """G3."""
        _, grads, _ = self._flat_views(stage, zero)
        rows = self.grad_rows[stage]
        with torch.no_grad():
            for lvl in self.halo_levels[stage]:
                grads[self.grid_leaf[lvl]][:1].add_(rows.row(lvl, self.mesh.map_i))
        if self.need_pts:
            cams = self.prog.pp.params["cams"]
            with torch.enable_grad():
                rays_o, rays_d, _, _, _ = self._rays()
                pts = points_along_rays(rays_o, rays_d, self.z).reshape(-1, 3)
                (d,) = torch.autograd.grad(pts, [cams], self.d_pts[stage])
            with torch.no_grad():
                grads[self.cam].add_(d)

    def step(self, stage: str, zero: Tuple[bool, ...]) -> None:
        """G4."""
        prog = self.prog
        loss, grads, _ = self._flat_views(stage, zero)
        mapping_step(prog.pp, prog.opt, prog.tab, prog.inp, loss, grads, zero)

    def gather_step(self, stage: str, zero: Tuple[bool, ...]) -> None:
        """G3 and G4 as one segment (``n_kf = 1``)."""
        self.gather(stage, zero)
        self.step(stage, zero)
