"""SLAM state: the keyframe ring buffer and the published map.

The keyframe database is a fixed-capacity ring buffer of device tensors
(slot = count % capacity), written in place. ``MapState`` bundles the grids,
decoders and keyframes with a version that the driver bumps on every
mapping event. :func:`snapshot_keyframes` and :func:`restore_keyframes`
take one event's writes back (the async sync mode's rollback).
:func:`init_state` builds a fresh map.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..grid.hierarchy import GridConfig, init_grids
from ..models.decoders import DecoderConfig, init_decoders


@dataclass
class KeyframeDB:
    """Fixed-capacity keyframe ring buffer; every tensor leads with capacity."""

    colors: torch.Tensor  # [K, H, W, 3] float32
    depths: torch.Tensor  # [K, H, W] float32
    est_c2w: torch.Tensor  # [K, 4, 4]
    gt_c2w: torch.Tensor  # [K, 4, 4]
    frame_idx: torch.Tensor  # [K] int64, -1 = empty slot
    count: int = 0

    @property
    def capacity(self) -> int:
        return self.colors.shape[0]

    def valid_mask(self) -> torch.Tensor:
        return self.frame_idx >= 0


def init_keyframe_db(capacity: int, H: int, W: int, device="cuda") -> KeyframeDB:
    eye = torch.eye(4, device=device).expand(capacity, 4, 4).clone()
    return KeyframeDB(
        colors=torch.zeros((capacity, H, W, 3), device=device),
        depths=torch.zeros((capacity, H, W), device=device),
        est_c2w=eye,
        gt_c2w=eye.clone(),
        frame_idx=torch.full((capacity,), -1, dtype=torch.long, device=device),
        count=0,
    )


def add_keyframe(
    db: KeyframeDB,
    color: torch.Tensor,
    depth: torch.Tensor,
    est_c2w: torch.Tensor,
    gt_c2w: torch.Tensor,
    frame_idx: int,
) -> KeyframeDB:
    """Write the ring position ``count % capacity`` in place; returns ``db``."""
    slot = db.count % db.capacity
    db.colors[slot] = color
    db.depths[slot] = depth
    db.est_c2w[slot] = est_c2w
    db.gt_c2w[slot] = gt_c2w
    # fill_ passes the index as a kernel argument; assigning a Python int
    # would copy it from the host and wait for the stream.
    db.frame_idx[slot].fill_(int(frame_idx))
    db.count += 1
    return db


@dataclass
class KeyframeSnapshot:
    """What one mapping event can change in a :class:`KeyframeDB`: every
    pose (BA writes them back), the frame indices, the count, and the one
    slot that the event's keyframe admission would overwrite."""

    est_c2w: torch.Tensor
    frame_idx: torch.Tensor
    count: int
    slot: int
    color: torch.Tensor
    depth: torch.Tensor
    gt_c2w: torch.Tensor


def snapshot_keyframes(db: KeyframeDB) -> KeyframeSnapshot:
    """Copies of the parts of ``db`` an event can write: ``[K, 4, 4]`` poses,
    ``[K]`` indices and slot ``count % capacity`` (one RGB-D image), not the
    whole ring of images."""
    s = db.count % db.capacity
    return KeyframeSnapshot(
        est_c2w=db.est_c2w.clone(), frame_idx=db.frame_idx.clone(), count=db.count,
        slot=s, color=db.colors[s].clone(), depth=db.depths[s].clone(),
        gt_c2w=db.gt_c2w[s].clone(),
    )


def restore_keyframes(db: KeyframeDB, snap: KeyframeSnapshot) -> None:
    """Write ``snap`` back into ``db`` in place: the DB as it was when the
    snapshot was taken, provided at most one keyframe was admitted since."""
    s = snap.slot
    db.est_c2w.copy_(snap.est_c2w)
    db.frame_idx.copy_(snap.frame_idx)
    db.colors[s] = snap.color
    db.depths[s] = snap.depth
    db.gt_c2w[s] = snap.gt_c2w
    db.count = snap.count


@dataclass
class MapState:
    """The published map: grids + decoders + keyframes."""

    grids: Dict[str, torch.Tensor]
    decoders: Dict
    keyframes: KeyframeDB
    version: int = 0


def init_state(
    bound: np.ndarray,
    H: int,
    W: int,
    grid_cfg: GridConfig = GridConfig(),
    dec_cfg: DecoderConfig = DecoderConfig(),
    kf_capacity: int = 128,
    gen: Optional[torch.Generator] = None,
    device="cuda",
):
    """A fresh map: grids, then decoders, from ``gen``'s draws (a CPU
    generator), and an empty keyframe DB. Returns ``(MapState, bounds,
    adjusted_bound)``."""
    grids, bounds, bound_adj = init_grids(bound, grid_cfg, gen=gen, device=device)
    decoders = init_decoders(dec_cfg, gen=gen, device=device)
    state = MapState(grids, decoders, init_keyframe_db(kf_capacity, H, W, device))
    return state, bounds, bound_adj
