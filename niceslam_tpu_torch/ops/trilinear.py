"""Trilinear feature-grid interpolation: world points -> sampled features.

Semantics of ``F.grid_sample(mode='bilinear', padding_mode='border',
align_corners=True)`` on a channel-last ``[Z, Y, X, C]`` volume: a world
point maps to ``[-1, 1]^3`` through the level's bound, then to voxel
coordinates ``v = (n + 1) / 2 * (dim - 1)`` clamped to the border. The start
corner is ``clamp(floor(v), 0, dim-2)`` (the JAX reference's packed
convention), so a coordinate on the far border takes weight 1 on the last
voxel.

:func:`sample_grid` goes through :class:`~.trilerp_kernels.TrilerpFunction`
on every device: the CUDA kernels on a card, their plain versions on CPU.
"""
from __future__ import annotations

import torch

from .trilerp_kernels import trilerp


def normalize_coords(pts: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """World points ``[..., 3]`` -> normalized [-1, 1]^3 via ``bound [3, 2]``."""
    lo = bound[:, 0]
    hi = bound[:, 1]
    return (pts - lo) / (hi - lo) * 2.0 - 1.0


def voxel_coords(pts: torch.Tensor, bound: torch.Tensor, shape3) -> torch.Tensor:
    """World points ``[N, 3]`` -> clipped float voxel coordinates ``[N, 3]``
    in (z, y, x) order. The clip makes the gradient zero outside the bound."""
    nz, ny, nx = shape3
    n = normalize_coords(pts, bound)  # [N, 3] in [-1, 1], xyz order
    vx = torch.clamp((n[..., 0] + 1.0) * 0.5 * (nx - 1), 0.0, nx - 1)
    vy = torch.clamp((n[..., 1] + 1.0) * 0.5 * (ny - 1), 0.0, ny - 1)
    vz = torch.clamp((n[..., 2] + 1.0) * 0.5 * (nz - 1), 0.0, nz - 1)
    return torch.stack([vz, vy, vx], dim=-1)


def sample_grid(
    grid: torch.Tensor, pts: torch.Tensor, bound: torch.Tensor
) -> torch.Tensor:
    """Trilinearly sample ``grid [Z, Y, X, C]`` at world points ``pts [N, 3]``
    -> ``[N, C]``, differentiable in the grid and the points (reverse and
    forward mode)."""
    v = voxel_coords(pts, bound, grid.shape[:3])
    return trilerp(grid, v.contiguous())
