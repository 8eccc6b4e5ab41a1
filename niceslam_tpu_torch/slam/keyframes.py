"""Keyframe selection (overlap) and frustum-based feature masking.

- :func:`keyframe_overlap_percentages`: project depth-spanned samples of the
  current frame into every keyframe; score by in-frustum fraction.
- :func:`frustum_voxel_mask`: per-level voxel mask of the centers that
  project inside some window frame's image, in front of it, within observed
  depth + 0.5 m. The mapper multiplies grid updates by it.

Camera convention: OpenGL (-z forward), so "in front" is z_cam < 0 and the
projection is (-x/z, y/z).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.pose import invert_pose
from ..core.rays import Intrinsics, sample_rays

# Pixels drawn per mapping event to score the keyframes' overlap.
OVERLAP_PIXELS = 100


def _project(w2c: torch.Tensor, intr: Intrinsics, pts: torch.Tensor):
    """World points [..., N, 3] -> (u, v, z_cam) under w2c [..., 4, 4]."""
    cam = pts @ w2c[..., :3, :3].transpose(-1, -2) + w2c[..., None, :3, 3]
    z = cam[..., 2]
    zs = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    u = -cam[..., 0] / zs * intr.fx + intr.cx
    v = cam[..., 1] / zs * intr.fy + intr.cy
    return u, v, z


def keyframe_overlap_percentages(
    intr: Intrinsics,
    c2w: torch.Tensor,
    depth: torch.Tensor,
    color: torch.Tensor,
    kf_c2w: torch.Tensor,  # [K, 4, 4]
    i: torch.Tensor,
    j: torch.Tensor,
    n_samples: int = 16,
    edge: int = 20,
) -> torch.Tensor:
    """Fraction of the current frame's surface volume (pixels ``i``, ``j``
    x ``n_samples`` depths in [0.8 d, d + 0.5]) visible in each keyframe
    -> ``[K]``."""
    batch = sample_rays(intr, c2w, depth, color, i, j)
    gt = batch.gt_depth.reshape(-1, 1)
    t = torch.linspace(0.0, 1.0, n_samples, device=gt.device)
    z_vals = gt * 0.8 * (1 - t) + (gt + 0.5) * t
    pts = (
        batch.rays_o[:, None, :] + batch.rays_d[:, None, :] * z_vals[..., None]
    ).reshape(-1, 3)
    pt_valid = (batch.gt_depth > 0)[:, None].expand(-1, n_samples).reshape(-1)
    u, v, z = _project(invert_pose(kf_c2w), intr, pts[None])  # [K, P]
    inside = (
        (u > edge) & (u < intr.W - edge) & (v > edge) & (v < intr.H - edge)
        & (z < 0) & pt_valid
    )
    denom = torch.clamp(pt_valid.sum(), min=1)
    return inside.sum(-1).to(torch.float32) / denom


def frustum_voxel_mask(
    poses: torch.Tensor,  # [F, 4, 4] window-frame c2w
    pose_valid: torch.Tensor,  # [F] bool
    depths: torch.Tensor,  # [F, H, W]
    intr: Intrinsics,
    level_bound,  # [3, 2] on the host: numpy or a CPU tensor
    grid_shape_zyx: Tuple[int, int, int],
) -> torch.Tensor:
    """[Z, Y, X] bool: voxels seen by at least one valid window frame.

    ``level_bound`` is read as host numbers: reading them from a card
    tensor would wait for the stream."""
    nz, ny, nx = grid_shape_zyx
    dev = poses.device
    (x0, x1), (y0, y1), (z0, z1) = (
        (float(level_bound[a][0]), float(level_bound[a][1])) for a in range(3)
    )
    xs = torch.linspace(x0, x1, nx, device=dev)
    ys = torch.linspace(y0, y1, ny, device=dev)
    zs = torch.linspace(z0, z1, nz, device=dev)
    Z, Y, X = torch.meshgrid(zs, ys, xs, indexing="ij")
    pts = torch.stack([X, Y, Z], dim=-1).reshape(-1, 3)

    seen = torch.zeros(pts.shape[0], dtype=torch.bool, device=dev)
    for f in range(poses.shape[0]):
        u, v, z = _project(invert_pose(poses[f]), intr, pts)
        iu = torch.clamp(torch.round(u).long(), 0, intr.W - 1)
        iv = torch.clamp(torch.round(v).long(), 0, intr.H - 1)
        obs = depths[f][iv, iu]
        in_img = (u >= 0) & (u < intr.W) & (v >= 0) & (v < intr.H)
        # Pixels with no depth reading keep the voxel (carve only where
        # observed).
        depth_ok = torch.where(obs > 0, -z <= obs + 0.5, torch.ones_like(in_img))
        seen |= in_img & (z < 0) & depth_ok & pose_valid[f]
    return seen.reshape(nz, ny, nx)


def frustum_masks_for_levels(
    poses, pose_valid, depths, intr, bounds, grids
) -> Dict[str, torch.Tensor]:
    """Per-level [Z, Y, X, 1] float masks for gradient gating; ``bounds``
    holds each level's ``[3, 2]`` bound on the host."""
    return {
        lvl: frustum_voxel_mask(
            poses, pose_valid, depths, intr, bounds[lvl], tuple(g.shape[:3])
        )[..., None].to(g.dtype)
        for lvl, g in grids.items()
    }
