"""Trilinear feature-grid interpolation: world points -> sampled features.

Semantics of ``F.grid_sample(mode='bilinear', padding_mode='border',
align_corners=True)`` on a channel-last ``[Z, Y, X, C]`` volume: a world
point maps to ``[-1, 1]^3`` through the level's bound, then to voxel
coordinates ``v = (n + 1) / 2 * (dim - 1)`` clamped to the border. The start
corner is ``clamp(floor(v), 0, dim-2)`` (the JAX reference's packed
convention), so a coordinate on the far border takes weight 1 on the last
voxel.

:func:`sample_grid` takes one of two routes, which compute the same function
and differ only in how they move bytes:

- ``"fused"`` (this package's default): :class:`~.trilerp_kernels.TrilerpFunction`,
  the gather and the lerp in one kernel (K1), its backward in another (K2);
- ``"packed"``: the JAX package's default route (its ``sample_grid`` takes
  the fused Pallas sampler only under ``NICESLAM_PALLAS``): a packed corner
  table (K3), one ``8C``-wide row per point (K4) through
  :class:`~.packed_kernels.PackedRows`, whose backward scatters straight into
  the grid (K5), and the lerp in plain PyTorch on the gathered rows
  (:func:`trilerp_packed`).

:func:`sampler_route` switches the route for the code inside it. On CPU
tensors every kernel runs its plain PyTorch version.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from .packed_kernels import packed_rows
from .trilerp_kernels import trilerp

ROUTES = ("fused", "packed")
_ROUTE = "fused"


def get_sampler_route() -> str:
    """The route :func:`sample_grid` takes now: ``"fused"`` or ``"packed"``."""
    return _ROUTE


@contextmanager
def sampler_route(route: str):
    """Run the code inside on ``route`` (``"fused"`` or ``"packed"``); the
    previous route comes back on exit, also on an exception."""
    global _ROUTE
    if route not in ROUTES:
        raise ValueError(f"unknown sampler route {route!r}; expected one of {ROUTES}")
    prev = _ROUTE
    _ROUTE = route
    try:
        yield
    finally:
        _ROUTE = prev


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


def packed_starts(v: torch.Tensor, shape3):
    """Start rows ``[N]`` (int32, ``(z0*Y + y0)*X + x0``) and weights
    ``[N, 3]`` of voxel coords ``v [N, 3]`` on a ``shape3 = (Z, Y, X)``
    grid: ``start = clamp(floor(v), 0, dim - 2)``, ``w = v - start``.
    """
    nz, ny, nx = shape3
    # Per-axis clamps with Python bounds: no tensor of bounds is copied to
    # the card (such a copy waits for the stream).
    f = torch.floor(v).long()
    z0, y0, x0 = (f[:, a].clamp(0, d - 2) for a, d in enumerate((nz, ny, nx)))
    row = ((z0 * ny + y0) * nx + x0).to(torch.int32)
    return row, v - torch.stack([z0, y0, x0], dim=-1).to(v.dtype)


def trilerp_packed(grid: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Trilinear lerp of ``grid [Z, Y, X, C]`` at voxel coords ``v [N, 3]``
    through its corner table: ONE ``[N, 8C]`` row per point, then the nested
    lerp chain of the JAX package's ``trilerp_packed`` on the unpacked
    corners.
    """
    C = grid.shape[-1]
    row, w = packed_starts(v, grid.shape[:3])
    r = packed_rows(grid, row).reshape(-1, 2, 2, 2, C)  # [N, x, y, z, C]
    wz, wy, wx = w[:, 0:1], w[:, 1:2], w[:, 2:3]

    c000 = r[:, 0, 0, 0]
    c001 = r[:, 1, 0, 0]
    c010 = r[:, 0, 1, 0]
    c011 = r[:, 1, 1, 0]
    c100 = r[:, 0, 0, 1]
    c101 = r[:, 1, 0, 1]
    c110 = r[:, 0, 1, 1]
    c111 = r[:, 1, 1, 1]

    c00 = c000 * (1 - wx) + c001 * wx
    c01 = c010 * (1 - wx) + c011 * wx
    c10 = c100 * (1 - wx) + c101 * wx
    c11 = c110 * (1 - wx) + c111 * wx
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz


def sample_grid(
    grid: torch.Tensor, pts: torch.Tensor, bound: torch.Tensor
) -> torch.Tensor:
    """Trilinearly sample ``grid [Z, Y, X, C]`` at world points ``pts [N, 3]``
    -> ``[N, C]``, differentiable in the grid and the points (reverse and
    forward mode), on the route :func:`get_sampler_route` names."""
    v = voxel_coords(pts, bound, grid.shape[:3])
    if _ROUTE == "packed":
        return trilerp_packed(grid, v)
    return trilerp(grid, v.contiguous())
