"""The ('map', 'kf') mesh over ``torch.distributed`` ranks, and the two
collectives everything multi-device in this package is built from.

One process per rank. Rank ``r`` sits at ``(map_i, kf_i) = (r // n_kf,
r % n_kf)``, the order of the JAX package's ``reshape(n_map, n_kf)``
(``niceslam_tpu/parallel/sharded_mapper.py:58-69``):

- ``map`` is the grid-Z-block axis: each rank of a map group holds one
  contiguous Z block of every feature grid (``grid/shard.py``);
- ``kf`` is the ray-batch axis: each rank of a kf group evaluates one slice
  of the same ray draw, and their gradients are summed.

The map group of a rank holds the ranks with its ``kf_i``; its kf group
the ranks with its ``map_i``. Both are made with ``dist.new_group`` on the
default group's backend (gloo or NCCL, ``parallel/runtime.py``), so the
mesh works over an existing gloo group where ranks share one card.

Every collective is an ``all_reduce`` (sum): NCCL and gloo both support it
for CUDA tensors, which gloo does not reliably do for ``all_gather`` or
send/recv. A point-to-point move of rows is a *slotted* all_reduce
(:func:`exchange_rows`): each rank writes its rows into its own slot of a
zeroed buffer, and after the sum every rank reads any slot. Adding zeros
is exact, so the rows arrive bit for bit.

The JAX package's 1-D GSPMD ray sharding (``niceslam_tpu/parallel/mesh.py``
``activate``/``shard_rays``, live only inside ``activate(mesh)``) has no
separate counterpart here: it is the ``kf`` axis of this mesh with
``n_map = 1``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist


def mesh_shape(map_: int, kf: int, world: int) -> Tuple[int, int]:
    """``(n_map, n_kf)`` of a ``parallel`` block on ``world`` ranks: ``kf = 0``
    means ``world // map``; a product other than ``world`` raises."""
    n_map = max(int(map_), 1)
    n_kf = int(kf) if kf > 0 else world // n_map
    if n_kf < 1 or n_map * n_kf != world:
        raise ValueError(
            f"a ('map', 'kf') mesh of {n_map} x {kf if kf > 0 else 'world // map'} "
            f"does not fit {world} rank(s): map * kf must equal the number of "
            "ranks (parallel.n_processes)"
        )
    return n_map, n_kf


@dataclass(frozen=True)
class MapKfMesh:
    """This rank's place in an ``n_map x n_kf`` mesh and its two groups
    (``None`` for an axis of size 1, which needs no collective)."""

    n_map: int
    n_kf: int
    map_i: int
    kf_i: int
    map_group: Optional[Any] = None
    kf_group: Optional[Any] = None

    @property
    def trivial(self) -> bool:
        return self.n_map * self.n_kf == 1


def make_mesh(n_map: int, n_kf: int) -> MapKfMesh:
    """The mesh over the default process group (every rank must call this,
    in the same order: ``new_group`` is collective). One rank needs no
    process group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_map * n_kf != world:
        raise ValueError(f"mesh {n_map} x {n_kf} needs {n_map * n_kf} ranks, have {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    map_i, kf_i = divmod(rank, n_kf)
    map_group = kf_group = None
    if n_map > 1:
        for k in range(n_kf):
            g = dist.new_group([m * n_kf + k for m in range(n_map)])
            if k == kf_i:
                map_group = g
    if n_kf > 1:
        for m in range(n_map):
            g = dist.new_group([m * n_kf + k for k in range(n_kf)])
            if m == map_i:
                kf_group = g
    return MapKfMesh(n_map, n_kf, map_i, kf_i, map_group, kf_group)


# The collectives this process has issued: every all_reduce_ over more than
# one rank counts one.
CALLS = {"all_reduce": 0}


def all_reduce_(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (of ``size`` ranks); returns ``t``.
    Counts one in :data:`CALLS` when ``size > 1``."""
    if size > 1:
        dist.all_reduce(t, group=group)
        CALLS["all_reduce"] += 1
    return t


def exchange_rows(rows: torch.Tensor, slot: int, mesh: MapKfMesh) -> torch.Tensor:
    """The slotted all_reduce over the map group: ``[n_map, *rows.shape]``
    with this rank's ``rows`` in ``slot`` and every other rank's in the slot
    it chose (zeros where nobody wrote)."""
    buf = rows.new_zeros((mesh.n_map,) + tuple(rows.shape))
    buf[slot] = rows
    return all_reduce_(buf, mesh.map_group, mesh.n_map)
