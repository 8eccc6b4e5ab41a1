"""Z-block feature-grid sharding with a one-row halo exchange.

The counterpart of ``niceslam_tpu/grid/shard.py``. Each ``[Z, Y, X, C]``
grid is cut into contiguous Z blocks of ``zb`` rows, one per rank of the
mesh's ``map`` axis (``parallel/mesh.py``); rank ``map_i`` holds rows
``[lo, lo + zb)`` with ``lo = map_i * zb``.

Trilinear interpolation reads rows ``z0`` and ``z0 + 1``, so a point whose
start row is a block's last row also needs the next block's first row: the
halo. :func:`sample_grid_sharded` samples a point set that every rank of a
map group holds in full:

1. the halo arrives by one slotted all_reduce (:class:`NextFirstRow`);
2. each rank samples ``cat(block, halo)`` (``zb + 1`` rows) at the local
   coordinate ``clip(vz - lo, 0, zb)`` with the port's own kernels, on the
   current ``sampler_route``, and keeps the points it owns,
   ``lo <= z0 < lo + zb`` with ``z0 = clip(floor(vz), 0, nz - 2)`` on the
   logical Z. The kernels clip the local start at the local table's own
   last row but one; no kernel takes a logical ``nz``;
3. an all_reduce over the map group sums the owners' values.

The backward is written by hand, since no collective is differentiated.
The incoming cotangent is the same on every rank of the map group (the
sampled features are replicated there). The local kernel backward (K2, or
K5 on the packed route) gives ``d_g`` for the ``zb + 1`` rows and ``d_v``:

- ``d_g[:zb]`` is the block's own gradient, to which
  :class:`NextFirstRow`'s backward adds the halo-row gradient that the
  *previous* rank computed, sent home by the same slotted all_reduce;
- ``d_v`` covers only this block's points, so it is summed over the map
  group: the points (and the poses behind them, under BA) are replicated.

The JAX package differentiates through ``psum``, whose transpose is
``psum``, and so divides every cotangent by ``n_map`` to undo the
replication (``niceslam_tpu/parallel/sharded_mapper.py:117-148``). Nothing
here differentiates a collective, so nothing is divided.

Edge cases (``niceslam_tpu/grid/shard.py:61-67``):

- the block that holds row ``nz - 2`` owns the points at
  ``vz == nz - 1``, whose global start clips to ``nz - 2`` (weight 1 on row
  ``nz - 1``). On the whole ``cat(block, halo)`` their local start would be
  one row later, with weight 0 on the row after ``nz - 1`` (the JAX
  package's design: the right value, but ``d_v`` from the wrong side). So
  every rank samples only the first ``min(zb + 1, nz - lo)`` rows of
  ``cat(block, halo)`` (at least two, as the kernels need; a block with
  fewer owns no point): the local clip is then the global one, and value
  and both gradients are the unsharded ones. With ``nz = zb * n_map`` that
  is ``cat(block, halo)`` everywhere but on the last block, which reads
  ``block`` alone.
- rank ``n - 1``'s halo is rank 0's first row (the slot wraps around); it
  is not read, gets a zero gradient, and that is never sent, so it adds
  nothing to rank 0.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.trilinear import trilerp_keep, trilerp_on_route, trilerp_vjp, voxel_coords
from ..parallel.mesh import MapKfMesh, all_reduce_, exchange_rows


def pad_z_to(grid: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Zero-pad Z so that it divides ``n_shards``. Padding is never
    sampled when the coordinates are taken on the unpadded Z (the
    ``nz_logical`` of :func:`sample_grid_sharded`)."""
    z = grid.shape[0]
    zp = -(-z // n_shards) * n_shards
    if zp == z:
        return grid
    return torch.cat([grid, grid.new_zeros((zp - z,) + tuple(grid.shape[1:]))])


def block_of(grid: torch.Tensor, mesh: MapKfMesh) -> torch.Tensor:
    """This rank's Z block of a grid whose Z divides ``n_map`` (a view)."""
    zb = grid.shape[0] // mesh.n_map
    return grid[mesh.map_i * zb:(mesh.map_i + 1) * zb]


def shard_hierarchy(
    grids: Dict[str, torch.Tensor], mesh: MapKfMesh
) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """Every level zero-padded and cut to this rank's block; returns
    ``(blocks, logical Zs)``."""
    nz = {lvl: int(g.shape[0]) for lvl, g in grids.items()}
    return {lvl: block_of(pad_z_to(g, mesh.n_map), mesh) for lvl, g in grids.items()}, nz


def local_rows(zb: int, nz: int, lo: int) -> int:
    """How many rows of ``cat(block, halo)`` the rank whose block starts at
    ``lo`` samples: ``min(zb + 1, nz - lo)``, at least 2 (the edge cases
    above)."""
    return max(min(zb + 1, nz - lo), 2)


def local_coords(v: torch.Tensor, lo: int, zb: int, nz: int):
    """``(v_loc, mine)`` of global voxel coords ``v [N, 3]`` on the block of
    ``zb`` rows at ``lo``: the local coords ``clip(vz - lo, 0, zb)`` and the
    float mask ``[N, 1]`` of the points it owns, ``lo <= z0 < lo + zb``
    with ``z0 = clip(floor(vz), 0, nz - 2)``."""
    z0 = torch.floor(v[:, 0]).long().clamp(0, nz - 2)
    mine = ((z0 >= lo) & (z0 < lo + zb)).to(v.dtype)[:, None]
    v_loc = torch.stack(
        [torch.clamp(v[:, 0] - lo, 0.0, float(zb)), v[:, 1], v[:, 2]], dim=-1
    )
    return v_loc, mine


class NextFirstRow(torch.autograd.Function):
    """``[1, Y, X, C]``: the first row of the next map rank's block (rank
    ``n - 1`` gets rank 0's). Backward: the row's gradient goes home to its
    owner, where it lands on the block's row 0; the wrap-around row of rank
    ``n - 1`` sends nothing."""

    @staticmethod
    def forward(ctx, block, mesh: MapKfMesh):
        ctx.mesh = mesh
        ctx.shape = block.shape
        rows = exchange_rows(block[:1], mesh.map_i, mesh)
        return rows[(mesh.map_i + 1) % mesh.n_map]

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        last = mesh.map_i == mesh.n_map - 1
        rows = exchange_rows(
            torch.zeros_like(g) if last else g, (mesh.map_i + 1) % mesh.n_map, mesh
        )
        d = g.new_zeros(ctx.shape)
        d[:1] = rows[mesh.map_i]
        return d, None


class _LocalSample(torch.autograd.Function):
    """Steps 2-3 of the module docstring: ``(block, halo, v) -> [N, C]``
    summed over the map group, with the hand-written backward."""

    @staticmethod
    def forward(ctx, block, halo, v, mesh: MapKfMesh, nz: int):
        zb = block.shape[0]
        lo = mesh.map_i * zb
        v_loc, mine = local_coords(v, lo, zb, nz)
        need_g = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        rows = local_rows(zb, nz, lo)
        parts = [block.detach()[:rows]] + ([halo.detach()] if rows > zb else [])
        with torch.enable_grad():
            g = torch.cat(parts).requires_grad_(need_g)
            vl = v_loc.requires_grad_(ctx.needs_input_grad[2])
            out = trilerp_on_route(g, vl)
        ctx.local = (out, g, vl)
        ctx.mine, ctx.mesh, ctx.zb = mine, mesh, zb
        return all_reduce_(out.detach() * mine, mesh.map_group, mesh.n_map)

    @staticmethod
    def backward(ctx, gout):
        out, g, vl = ctx.local
        ctx.local = None
        mesh, zb = ctx.mesh, ctx.zb
        wrt = [t for t in (g, vl) if t.requires_grad]
        if not wrt:
            return None, None, None, None, None
        grads = list(torch.autograd.grad(out, wrt, gout * ctx.mine))
        d_block = d_halo = d_v = None
        if g.requires_grad:
            # Rows not sampled get zeros; every rank's halo gets a gradient,
            # so that every rank runs NextFirstRow's backward exchange.
            d_g = grads.pop(0)
            d_full = d_g.new_zeros((zb + 1,) + tuple(d_g.shape[1:]))
            d_full[:d_g.shape[0]] = d_g
            d_block, d_halo = d_full[:zb], d_full[zb:]
        if vl.requires_grad:
            # d(v_loc)/d(v) is 1 on the owned points (their v_loc lies in
            # [0, zb], where the clip is the identity) and the others have
            # a zero cotangent.
            d_v = all_reduce_(grads.pop(0), mesh.map_group, mesh.n_map)
        return d_block, d_halo, d_v, None, None


def sample_grid_sharded(
    block: torch.Tensor,
    pts: torch.Tensor,
    bound: torch.Tensor,
    mesh: MapKfMesh,
    nz_logical: Optional[int] = None,
) -> torch.Tensor:
    """Sample the Z-sharded grid whose block ``[zb, Y, X, C]`` this rank
    holds at world points ``pts [N, 3]`` (the same on every rank of the map
    group) -> ``[N, C]`` on every rank. ``nz_logical`` is the grid's
    unpadded Z (default ``zb * n_map``). Equal to ``ops.trilinear.
    sample_grid`` on the whole grid up to the order of float sums, and bit
    for bit in the forward."""
    zb, Y, X = block.shape[:3]
    nz = zb * mesh.n_map if nz_logical is None else nz_logical
    v = voxel_coords(pts, bound, (nz, Y, X))
    halo = NextFirstRow.apply(block, mesh)
    return _LocalSample.apply(block, halo, v, mesh, nz)


# ------------------------------------------------ the sampler in two phases
class SlotRows:
    """The first rows ``[Y, X, C]`` of several levels in one slotted buffer
    ``[n_map, sum of Y * X * C]`` (``buf``, a view of ``storage``), for one
    all_reduce over the map group in the manner of :func:`exchange_rows`:
    after it, slot ``s`` holds what the rank that wrote slot ``s`` put
    there, and zeros where nobody wrote."""

    def __init__(self, storage: torch.Tensor, row_shapes: Dict[str, tuple], levels,
                 n_map: int):
        self.shapes = {lvl: tuple(row_shapes[lvl]) for lvl in levels}
        self.offsets, width = {}, 0
        for lvl, shape in self.shapes.items():
            n = 1
            for d in shape:
                n *= d
            self.offsets[lvl] = (width, n)
            width += n
        self.buf = storage[:n_map * width].view(n_map, width)

    def row(self, lvl: str, slot: int) -> torch.Tensor:
        """Level ``lvl``'s row in ``slot``, a ``[1, Y, X, C]`` view."""
        off, n = self.offsets[lvl]
        return self.buf[slot, off:off + n].view((1,) + self.shapes[lvl])

    @torch.no_grad()
    def pack_(self, rows: Dict[str, torch.Tensor], slot: int) -> None:
        """Zero the buffer and write each level's ``rows[lvl]`` (``[1, Y, X,
        C]``, or None for zeros) into ``slot``."""
        self.buf.zero_()
        for lvl, r in rows.items():
            if r is not None:
                self.row(lvl, slot).copy_(r)


class SplitSample:
    """One level of :func:`sample_grid_sharded` with its collectives taken
    out, for a caller that runs them between two phases (the map-sharded
    mapping program, ``parallel/sharded_mapper.MapSegments``):

    - :meth:`forward_`: the owner-masked local sample of ``cat(block[:rows],
      halo)`` (the edge rule above) at the global voxel coords ``v``, on the
      current route through ``ops.trilinear.trilerp_keep`` (K1, or K3 + K4),
      written into a slice of the caller's feature buffer, which the caller
      then sums over the map group;
    - :meth:`summed`: the summed features as a differentiable op
      (:class:`SummedSample`) whose backward is the local one (K2, or K5 on
      ``d_feat * mine``): the block's and the halo row's gradients, and
      ``d_v`` for this block's points only, which the caller sums over the
      map group before it reaches the points.

    The static buffers (:meth:`buffers`): ``cat(block, halo)`` where this
    rank reads the halo, and on the packed route the ``[N, 8C]`` corner rows
    that the backward reads, so that the two phases may be separate CUDA
    graphs."""

    def __init__(self, block_shape, mesh: MapKfMesh, n_pts: int, route: str, device):
        zb, Y, X, C = block_shape
        self.zb, self.nz, self.lo = zb, zb * mesh.n_map, mesh.map_i * zb
        self.rows = local_rows(zb, self.nz, self.lo)
        self.local = (torch.zeros((zb + 1, Y, X, C), device=device)
                      if self.rows > zb else None)
        self.corner_rows = (torch.zeros((n_pts, 8 * C), device=device)
                            if route == "packed" else None)

    def buffers(self):
        return [t for t in (self.local, self.corner_rows) if t is not None]

    def grid(self, block: torch.Tensor) -> torch.Tensor:
        """The local grid of the last :meth:`forward_` on ``block``."""
        return self.local if self.local is not None else block.detach()[:self.rows]

    @torch.no_grad()
    def forward_(self, block: torch.Tensor, halo: torch.Tensor, v: torch.Tensor,
                 out: torch.Tensor) -> None:
        """``out [N, C]`` = this rank's share of the sample at ``v``: the
        local value on the points it owns, zeros elsewhere."""
        if self.local is not None:
            self.local[:self.zb].copy_(block)
            self.local[self.zb:].copy_(halo)
        v_loc, mine = local_coords(v, self.lo, self.zb, self.nz)
        torch.mul(trilerp_keep(self.grid(block), v_loc, self.corner_rows), mine, out=out)

    def summed(self, block: torch.Tensor, halo: torch.Tensor, v: torch.Tensor,
               feat: torch.Tensor) -> torch.Tensor:
        """``feat`` (the map group's sum of :meth:`forward_`) as a function
        of ``block``, ``halo`` and ``v`` (:class:`SummedSample`)."""
        return SummedSample.apply(block, halo, v, feat, self)


class SummedSample(torch.autograd.Function):
    """``(block, halo, v) -> feat``, the features that the map group summed
    after :meth:`SplitSample.forward_`; the backward is
    :class:`_LocalSample`'s without its all_reduce: ``d_v`` is this rank's
    share, for the caller to sum."""

    @staticmethod
    def forward(ctx, block, halo, v, feat, split: SplitSample):
        ctx.v_loc, ctx.mine = local_coords(v, split.lo, split.zb, split.nz)
        ctx.grid, ctx.split = split.grid(block), split
        return feat.clone()

    @staticmethod
    def backward(ctx, gout):
        s = ctx.split
        need_g = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        d_g, d_v = trilerp_vjp(ctx.grid, ctx.v_loc, s.corner_rows, gout * ctx.mine,
                               need_g, ctx.needs_input_grad[2])
        d_block = d_halo = None
        if need_g:
            d_full = d_g.new_zeros((s.zb + 1,) + tuple(d_g.shape[1:]))
            d_full[:d_g.shape[0]] = d_g
            d_block, d_halo = d_full[:s.zb], d_full[s.zb:]
        return d_block, d_halo, d_v, None, None
