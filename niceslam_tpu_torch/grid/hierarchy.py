"""Hierarchical feature-grid store: coarse / middle / fine / color volumes.

Four dense voxel volumes, channel-last ``[Z, Y, X, C]``, sized from the scene
bound (snapped so its extent divides ``bound_divisable``) over per-level
voxel lengths; Gaussian init with std 0.01 (fine 1e-4). The coarse level
samples against an origin-scaled bound enlarged ``coarse_bound_enlarge``
times. Grids are a plain ``dict[str, Tensor]``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

LEVELS = ("coarse", "middle", "fine", "color")


class GridConfig(NamedTuple):
    coarse_len: float = 2.0
    middle_len: float = 0.32
    fine_len: float = 0.16
    color_len: float = 0.16
    bound_divisable: float = 0.32
    c_dim: int = 32
    coarse_bound_enlarge: float = 2.0

    def level_len(self, level: str) -> float:
        return {
            "coarse": self.coarse_len,
            "middle": self.middle_len,
            "fine": self.fine_len,
            "color": self.color_len,
        }[level]


def adjust_bound(bound: np.ndarray, divisable: float) -> np.ndarray:
    """Snap the upper bound so the extent is a multiple of ``divisable``."""
    bound = np.asarray(bound, np.float32).copy()
    extent = bound[:, 1] - bound[:, 0]
    bound[:, 1] = (
        np.floor(extent / divisable).astype(np.int64) + 1
    ) * divisable + bound[:, 0]
    return bound


def grid_shape(
    bound: np.ndarray, voxel_len: float, enlarge: float = 1.0
) -> Tuple[int, int, int]:
    """``(Z, Y, X)`` voxel counts for one level (truncating division)."""
    extent = (bound[:, 1] - bound[:, 0]) * enlarge
    nx, ny, nz = (
        int(extent[0] / voxel_len),
        int(extent[1] / voxel_len),
        int(extent[2] / voxel_len),
    )
    return (max(nz, 2), max(ny, 2), max(nx, 2))


def init_grids(
    bound: np.ndarray,
    cfg: GridConfig = GridConfig(),
    gen: Optional[torch.Generator] = None,
    device="cuda",
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], np.ndarray]:
    """Build the four feature grids from ``gen``'s normal draws.

    Returns ``(grids, bounds, bound)``: per-level volumes ``[Z, Y, X, C]``,
    per-level sampling bounds ``[3, 2]``, and the adjusted scene bound.
    """
    bound = adjust_bound(bound, cfg.bound_divisable)
    grids: Dict[str, torch.Tensor] = {}
    bounds: Dict[str, torch.Tensor] = {}
    for lvl in LEVELS:
        enlarge = cfg.coarse_bound_enlarge if lvl == "coarse" else 1.0
        shape = grid_shape(bound, cfg.level_len(lvl), enlarge)
        std = 1e-4 if lvl == "fine" else 0.01
        g = torch.randn((*shape, cfg.c_dim), generator=gen, dtype=torch.float32)
        grids[lvl] = (g * std).to(device)
        bounds[lvl] = torch.as_tensor(bound * enlarge, device=device)
    return grids, bounds, bound
