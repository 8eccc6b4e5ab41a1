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

A rank's changes to an iteration are its :func:`kf_slice`. The iteration
splits at the all_reduce into two halves (``slam/mapper.py``:
``mapping_grads``, ``mapping_step``), so with ``n_map = 1`` (the shipped
mesh, ``configs/apartment_multihost.yaml``) the pass runs as a program of
the system (``slam/programs.py``), on a card as two CUDA graphs per stage
replayed around the eager all_reduce: the collective is the iteration's
only one, and gloo cannot be captured. With ``n_map > 1`` the collectives
sit inside the halo sampler's forward and backward and in the TV term, so
the pass runs eagerly through :func:`make_sharded_run_schedule`: no graph
holds them until NCCL runs on two or more cards.

Grids must be Z-padded so that each level divides ``n_map``:
:func:`pad_grid_for_sharding` replicates the last row and extends the z
bound by the same number of voxels, which keeps every consumer's
world-to-voxel map of the real rows (tracker, renderer, mesher).
"""
from __future__ import annotations

import contextlib
from functools import partial
from typing import Dict, Tuple

import torch

from ..grid.shard import NextFirstRow, sample_grid_sharded
from ..ops.trilinear import override_sampler
from ..slam.mapper import KfSlice, run_schedule
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
    ``n = n_pixels / n_kf``, the TV term of :func:`tv_term`, and
    :func:`reduce_over_kf_` (none with one kf rank)."""
    if n_pixels % mesh.n_kf:
        raise ValueError(f"mapping.pixels={n_pixels} must divide the kf axis ({mesh.n_kf})")
    n_local = n_pixels // mesh.n_kf
    return KfSlice(
        ray_shard=(mesh.kf_i * n_local, n_local), tv_term=partial(tv_term, mesh=mesh),
        reduce=partial(reduce_over_kf_, mesh=mesh) if mesh.n_kf > 1 else None,
        key=(mesh.n_map, mesh.n_kf, mesh.map_i, mesh.kf_i),
    )


def make_sharded_run_schedule(mesh: MapKfMesh):
    """A drop-in ``run_schedule`` (same arguments) for passes whose
    ``pp`` grids and ``grid_masks`` are this rank's Z blocks of grids padded
    with :func:`pad_grid_for_sharding`; ``bounds`` are the padded grids'.
    It runs eagerly: ``NiceSLAM`` runs it with ``map > 1``, whose
    collectives sit inside the sampler's forward and backward (with
    ``map = 1`` it runs the kf-sharded program of ``slam/programs.py``)."""

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
