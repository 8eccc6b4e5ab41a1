"""SLAM state: the keyframe ring buffer and the published map.

The keyframe database is a fixed-capacity ring buffer of device tensors
(slot = count % capacity), written in place. ``MapState`` bundles the grids,
decoders and keyframes with a version that the driver bumps on every
mapping event.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch


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
    db.frame_idx[slot] = int(frame_idx)
    db.count += 1
    return db


@dataclass
class MapState:
    """The published map: grids + decoders + keyframes."""

    grids: Dict[str, torch.Tensor]
    decoders: Dict
    keyframes: KeyframeDB
    version: int = 0
