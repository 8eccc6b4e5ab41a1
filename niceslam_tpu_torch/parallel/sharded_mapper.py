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
  gradients are summed over the kf group by one ``all_reduce`` of a flat
  buffer. Grid blocks need nothing over ``map``: each rank owns its block,
  and the halo rows' gradients went home inside the sampler's backward.
  Decoder and camera gradients are already the same over ``map``, because
  the features were summed there before the decoders saw them.

Adam then steps the local grid blocks and the replicated decoders and
cameras, with the masks and per-group learning rates of ``adam_update``.
Every rank of a kf group gets the same summed gradient, so the replicas stay
equal bit for bit.

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

from ..grid.shard import NextFirstRow, sample_grid_sharded
from ..ops.trilinear import override_sampler
from ..slam.mapper import run_schedule
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


def tv_term(grids_blk: Dict[str, torch.Tensor], mesh: MapKfMesh) -> torch.Tensor:
    """The TV sum of ``mapping_loss`` on the whole middle and fine grids,
    computed from this rank's blocks, divided by ``n_kf``.

    The gradient is exact: the local y/x/z squared differences of the block,
    plus the one z difference across the border with the next block, whose
    first row arrives by :class:`~..grid.shard.NextFirstRow` (its backward
    sends that row's gradient home; the last block has no such difference).
    The value is the whole grid's, summed over the map group without a
    gradient. Every rank of a kf group adds the same term, and the kf
    all_reduce of the gradients sums ``n_kf`` copies, hence the division.
    """
    tv = 0.0
    for lvl in ("middle", "fine"):
        g = grids_blk[lvl]
        zb, Y, X, C = g.shape
        Z = zb * mesh.n_map
        sy = torch.sum(torch.square(g[:, 1:] - g[:, :-1]))
        sx = torch.sum(torch.square(g[:, :, 1:] - g[:, :, :-1]))
        sz = torch.sum(torch.square(g[1:] - g[:-1]))
        if mesh.n_map > 1:
            nxt = NextFirstRow.apply(g, mesh)
            inner = 0.0 if mesh.map_i == mesh.n_map - 1 else 1.0
            sz = sz + inner * torch.sum(torch.square(nxt - g[-1:]))
        local = (
            sy / (Z * (Y - 1) * X * C)
            + sx / (Z * Y * (X - 1) * C)
            + sz / ((Z - 1) * Y * X * C)
        )
        full = all_reduce_(local.detach().clone(), mesh.map_group, mesh.n_map)
        tv = tv + local + (full - local.detach())
    return tv / mesh.n_kf


def reduce_over_kf(
    loss: torch.Tensor, grads: List[Optional[torch.Tensor]], mesh: MapKfMesh
):
    """``(loss, grads)`` summed over the kf group by one all_reduce of a
    flat buffer. ``None`` (a leaf the stage does not reach) is ``None`` on
    every rank and stays so."""
    if mesh.n_kf == 1:
        return loss, grads
    parts = [loss.reshape(1)] + [g.reshape(-1) for g in grads if g is not None]
    flat = all_reduce_(torch.cat(parts), mesh.kf_group, mesh.n_kf)
    out, k = [], 1
    for g in grads:
        if g is None:
            out.append(None)
            continue
        out.append(flat[k:k + g.numel()].view_as(g))
        k += g.numel()
    return flat[0], out


def make_sharded_run_schedule(mesh: MapKfMesh):
    """A drop-in ``run_schedule`` (same arguments) for passes whose
    ``pp`` grids and ``grid_masks`` are this rank's Z blocks of grids padded
    with :func:`pad_grid_for_sharding`; ``bounds`` are the padded grids'."""

    def sharded_run_schedule(pp, opt_state, sched, grid_masks, bounds, scene_bound,
                             intr, colors, depths, frame_valid, cam_fixed, pcfg,
                             rcfg, gen=None, pixels=None):
        if pcfg.n_pixels % mesh.n_kf:
            raise ValueError(
                f"mapping.pixels={pcfg.n_pixels} must divide the kf axis ({mesh.n_kf})"
            )
        n_local = pcfg.n_pixels // mesh.n_kf
        # One map block is the whole grid: the plain sampler is the halo
        # sampler without its collectives.
        sampler = (
            override_sampler(partial(sample_grid_sharded, mesh=mesh))
            if mesh.n_map > 1 else contextlib.nullcontext()
        )
        with sampler:
            return run_schedule(
                pp, opt_state, sched, grid_masks, bounds, scene_bound, intr, colors,
                depths, frame_valid, cam_fixed, pcfg, rcfg, gen=gen, pixels=pixels,
                ray_shard=(mesh.kf_i * n_local, n_local),
                tv_term=partial(tv_term, mesh=mesh),
                reduce=partial(reduce_over_kf, mesh=mesh),
            )

    return sharded_run_schedule
