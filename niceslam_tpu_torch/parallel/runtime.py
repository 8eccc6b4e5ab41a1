"""Multi-rank runtime: process bootstrap, the ('map', 'kf') mesh, and its
attachment to a ``NiceSLAM``.

The counterpart of ``niceslam_tpu/parallel/runtime.py``, in PyTorch's idiom:
one process per rank (the JAX package runs one controller per host), so
``parallel.n_processes`` counts ranks here and hosts there.

- **Bootstrap** (:func:`setup_runtime`): the rank id comes from
  ``--process-id`` or ``NICESLAM_PROCESS_ID``, as in the JAX package; a
  missing one raises. Ranks meet at ``tcp://{parallel.coordinator}``.
- **Mesh**: ``parallel.map x parallel.kf`` with ``kf: 0`` meaning
  ``world // map``; a mesh that does not fit the world raises, and so does
  a ``mapping.pixels`` that ``kf`` does not divide. Both are checked before
  any rendezvous.
- **Backend and place**: rank ``r`` runs on card ``r % cards``. NCCL when
  every rank has a card of its own (no more ranks than this host's cards),
  gloo when ranks share a card or run on the CPU (``cpu=True``). The
  choice is the first event the attached system logs.
- **Attachment** (:meth:`MapKfRuntime.attach`): every grid is padded to the
  map axis (``pad_grid_for_sharding``) and the system's mapping passes run
  sharded on this rank's Z blocks, as the system's mapping program (CUDA
  graphs on a card): with ``map = 1`` two graphs an iteration around the
  kf all_reduce, with ``map > 1`` the segments of
  ``sharded_mapper.MapSegments`` around 3 collectives (4 with ``kf > 1``),
  and one more with ``rendering.N_importance > 0``: the importance pass's
  first point set. The system keeps the whole padded grids as its
  published map: with ``map > 1`` the blocks are assembled on every rank
  after each pass by one slotted all_reduce per level, and the tracker,
  ``render_image``, the mesher and checkpoints read that copy. Every rank then solves the same pose from
  the same draws, through the system's programs.

Fault model: all or nothing, as in the JAX package. A rank that fails
leaves the others waiting in a collective until the process group's timeout
(:data:`TIMEOUT`), and then they raise too; recovery is a restart from the
last checkpoint (``--resume``).
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..config.schema import SLAMConfig
from ..grid.shard import block_of
from .mesh import MapKfMesh, all_reduce_, exchange_rows, make_mesh, mesh_shape
from .sharded_mapper import kf_slice, make_sharded_run_schedule, pad_grid_for_sharding

# How long a rank waits in a collective for the others. A rank writes
# meshes and checkpoints while the others wait at their next collective.
TIMEOUT = timedelta(minutes=30)


def place(rank: int, world: int, cpu: bool):
    """``(backend, device)`` of ``rank`` among ``world`` on this host."""
    if cpu:
        return "gloo", torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available; pass cpu=True (--cpu) to run the ranks on the CPU"
        )
    return ("nccl" if world <= n else "gloo"), torch.device("cuda", rank % n)


class MapKfRuntime:
    """This rank's mesh, device and backend, and what a ``NiceSLAM`` needs
    from them while attached."""

    def __init__(self, mesh: MapKfMesh, device, backend: Optional[str],
                 rank: int = 0, world: int = 1):
        self.mesh = mesh
        self.device = torch.device(device)
        self.backend = backend
        self.rank, self.world = rank, world
        # The eager sharded pass: the reference of the system's program.
        self.run_schedule = make_sharded_run_schedule(mesh)

    @property
    def trivial(self) -> bool:
        return self.mesh.trivial

    def kf_slice(self, n_pixels: int):
        """This rank's part of a pass of ``n_pixels`` rays
        (``sharded_mapper.kf_slice``)."""
        return kf_slice(self.mesh, n_pixels)

    def describe(self) -> dict:
        m = self.mesh
        return {
            "event": "runtime", "rank": self.rank, "world": self.world,
            "backend": self.backend, "device": str(self.device),
            "map": m.n_map, "kf": m.n_kf, "map_i": m.map_i, "kf_i": m.kf_i,
        }

    def attach(self, slam) -> None:
        """Pad the system's grids to the map axis and run its mapping passes
        sharded; logs :meth:`describe` first. A 1 x 1 mesh attaches
        nothing."""
        if self.trivial:
            return
        if slam.device != self.device:
            raise ValueError(f"the system runs on {slam.device}, this rank on {self.device}")
        if slam.cfg.mapping.pixels % self.mesh.n_kf:
            raise ValueError(
                f"mapping.pixels={slam.cfg.mapping.pixels} must divide the kf "
                f"mesh axis ({self.mesh.n_kf})"
            )
        slam.log.log(self.describe())
        slam._runtime = self
        self.reattach_grids(slam)

    def reattach_grids(self, slam) -> None:
        """(Re-)pad the system's grids and bounds to the map axis: at attach
        time and after a restore. A snapshot padded for this map extent (or
        one it divides) passes through unchanged. The observed-voxel counts
        are padded alike."""
        grids, bounds = {}, dict(slam.bounds)
        for lvl, g in slam.state.grids.items():
            grids[lvl], bounds[lvl] = pad_grid_for_sharding(g, bounds[lvl], self.mesh.n_map)
        slam.state.grids = grids
        slam._set_bounds(bounds, slam.scene_bound)
        slam._fit_obs_counts()
        slam._track_snap = None

    def split(self, grids: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's Z block of every level (views); every Z must divide
        the map axis (:func:`pad_grid_for_sharding`)."""
        for lvl, g in grids.items():
            if g.shape[0] % self.mesh.n_map:
                raise ValueError(
                    f"grid {lvl} Z={g.shape[0]} does not divide the map axis "
                    f"({self.mesh.n_map}); pad it with pad_grid_for_sharding"
                )
        return {lvl: block_of(g, self.mesh) for lvl, g in grids.items()}

    def assemble(self, blocks: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The whole padded grids from the map group's blocks, on every rank:
        one slotted all_reduce per level (exact: the other slots are zeros)."""
        out = {}
        for lvl, b in blocks.items():
            rows = exchange_rows(b.detach(), self.mesh.map_i, self.mesh)
            out[lvl] = rows.reshape((-1,) + tuple(b.shape[1:]))
        return out

    def ranks_agree(self, t: torch.Tensor) -> bool:
        """Whether ``t`` is the same bit for bit on every rank: rank 0's copy
        is broadcast and every rank's verdict summed."""
        if self.world == 1:
            return True
        t = t.to(self.device).contiguous()
        ref = t.clone()
        dist.broadcast(ref, src=0)
        bad = torch.tensor(
            [0.0 if torch.equal(ref, t) else 1.0], device=self.device
        )
        return float(all_reduce_(bad, None, self.world)) == 0.0


def setup_runtime(
    cfg: SLAMConfig, process_id: Optional[int] = None, cpu: bool = False
) -> MapKfRuntime:
    """Check the ``parallel`` block against the world, bootstrap the process
    group (more than one rank) and build the mesh, before any other use of
    the device."""
    p = cfg.parallel
    world = max(int(p.n_processes), 1)
    n_map, n_kf = mesh_shape(p.map, p.kf, world)
    if cfg.mapping.pixels % n_kf:
        raise ValueError(
            f"mapping.pixels={cfg.mapping.pixels} must divide the kf mesh axis ({n_kf})"
        )
    rank = 0
    if world > 1:
        if process_id is None:
            env = os.environ.get("NICESLAM_PROCESS_ID", "")
            process_id = int(env) if env else -1
        if process_id < 0:
            raise ValueError("a multi-rank run needs --process-id or NICESLAM_PROCESS_ID")
        if process_id >= world:
            raise ValueError(f"process id {process_id} is not below n_processes={world}")
        rank = process_id
    backend, device = place(rank, world, cpu)
    if world == 1:
        return MapKfRuntime(make_mesh(1, 1), device, None)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{p.coordinator}", world_size=world, rank=rank,
        timeout=TIMEOUT,
    )
    return MapKfRuntime(make_mesh(n_map, n_kf), device, backend, rank, world)
