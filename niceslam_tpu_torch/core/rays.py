"""Ray generation: pinhole back-projection and pixel sampling.

Camera convention: x right, y up, camera looks along **-z** (OpenGL).
Pixel draws are injectable: :func:`sample_rays` takes the pixel indices, and
:func:`draw_pixels` draws them from an explicit ``torch.Generator``, so a
test can hand both packages the same pixels.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import DEFAULT_DEVICE


class Intrinsics(NamedTuple):
    """Pinhole intrinsics (plain python numbers)."""

    H: int
    W: int
    fx: float
    fy: float
    cx: float
    cy: float


def pixel_dirs(intr: Intrinsics, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Camera-frame ray directions ``[(i-cx)/fx, -(j-cy)/fy, -1]`` for pixel
    columns ``i`` and rows ``j``."""
    return torch.stack(
        [(i - intr.cx) / intr.fx, -(j - intr.cy) / intr.fy, -torch.ones_like(i)],
        dim=-1,
    )


def rays_for_image(intr: Intrinsics, c2w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-frame rays ``(rays_o, rays_d)``, each ``[H, W, 3]``, for every
    pixel of the image, on ``c2w``'s device."""
    j, i = torch.meshgrid(
        torch.arange(intr.H, dtype=c2w.dtype, device=c2w.device),
        torch.arange(intr.W, dtype=c2w.dtype, device=c2w.device),
        indexing="ij",
    )
    rays_d = pixel_dirs(intr, i, j) @ c2w[:3, :3].T
    return c2w[:3, 3].expand(rays_d.shape), rays_d


class RayBatch(NamedTuple):
    """A sampled batch of rays with their supervision targets."""

    rays_o: torch.Tensor  # [N, 3]
    rays_d: torch.Tensor  # [N, 3]
    gt_depth: torch.Tensor  # [N]
    gt_color: torch.Tensor  # [N, 3]


def draw_pixels(
    gen: Optional[torch.Generator],
    intr: Intrinsics,
    n: int,
    edge_h: int = 0,
    edge_w: int = 0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform pixel columns ``i`` and rows ``j`` inside the edge crop, on
    ``device``: by default the generator's, or ``DEFAULT_DEVICE`` without one."""
    if device is None:
        device = gen.device if gen is not None else DEFAULT_DEVICE
    j = torch.randint(edge_h, intr.H - edge_h, (n,), generator=gen, device=device)
    i = torch.randint(edge_w, intr.W - edge_w, (n,), generator=gen, device=device)
    return i, j


def sample_rays(
    intr: Intrinsics,
    c2w: torch.Tensor,
    depth: torch.Tensor,
    color: torch.Tensor,
    i: torch.Tensor,
    j: torch.Tensor,
) -> RayBatch:
    """World-frame rays and ground truth at pixel columns ``i``, rows ``j``."""
    dirs = pixel_dirs(intr, i.to(c2w.dtype), j.to(c2w.dtype))
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return RayBatch(rays_o, rays_d, depth[j, i], color[j, i])


def near_far_from_bound(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    bound: torch.Tensor,
    gt_depth: Optional[torch.Tensor],
    n_samples: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray near ``[N, n_samples]`` and far ``[N, 1]``.

    near = 0.01 * gt_depth; far = slab-exit distance against the scene bound
    + 0.01, clamped to at most ``1.2 * max(gt_depth)``.
    """
    t = (bound[None, :, :] - rays_o[:, :, None]) / rays_d[:, :, None]  # [N,3,2]
    far_bb = torch.amin(torch.amax(t, dim=2), dim=1)[:, None] + 0.01
    if gt_depth is None:
        near = torch.full(
            (rays_o.shape[0], n_samples), 0.01, dtype=rays_o.dtype,
            device=rays_o.device,
        )
        return near, far_bb
    gt = gt_depth.reshape(-1, 1)
    near = (gt * 0.01).expand(-1, n_samples)
    far = torch.minimum(torch.clamp(far_bb, min=0.0), torch.amax(gt * 1.2))
    return near, far
