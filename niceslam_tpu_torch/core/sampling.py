"""Depth sampling along rays: stratified + depth-guided surface samples.

Rows with zero ground-truth depth are handled with ``where`` rather than
boolean indexing, so every ray batch keeps its shape.
"""
from __future__ import annotations

from typing import Optional

import torch


def stratified_z_vals(
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    perturb: float = 0.0,
    gen: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """``n_samples`` z-values linearly spaced in [near, far] per ray, with
    optional stratified jitter drawn from ``gen``."""
    t_vals = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype, device=near.device)
    z_vals = near * (1.0 - t_vals) + far * t_vals
    if perturb > 0.0:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        t_rand = torch.rand(
            z_vals.shape, generator=gen, dtype=z_vals.dtype, device=z_vals.device
        )
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def surface_z_vals(
    gt_depth: torch.Tensor, n_surface: int, band: float = 0.05
) -> torch.Tensor:
    """``n_surface`` z-values spanning [1-band, 1+band] * gt_depth per ray;
    rays with zero depth span [1e-3, max(gt_depth in batch)] instead."""
    gt = gt_depth.reshape(-1, 1)
    t = torch.linspace(0.0, 1.0, n_surface, dtype=gt.dtype, device=gt.device)
    z_nonzero = (1.0 - band) * gt * (1.0 - t) + (1.0 + band) * gt * t
    z_zero = 0.001 * (1.0 - t) + torch.amax(gt) * t  # [n_surface]
    return torch.where(gt > 0.0, z_nonzero, z_zero[None, :])


def merge_z_vals(z_strat: torch.Tensor, z_surf: torch.Tensor) -> torch.Tensor:
    """Sort-merge stratified and surface samples along the ray."""
    return torch.sort(torch.cat([z_strat, z_surf], dim=-1), dim=-1).values


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    gen: Optional[torch.Generator] = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """Inverse-CDF importance sampling of ``n_samples`` z-values per ray.

    ``bins [N, B+1]``, ``weights [N, B]``. Midpoint-deterministic ``u`` when
    ``deterministic``; otherwise uniform draws from ``gen``.
    """
    w = weights + 1e-5
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    shape = cdf.shape[:-1] + (n_samples,)
    if deterministic:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=bins.dtype, device=bins.device)
        u = u.expand(shape).contiguous()
    else:
        u = torch.rand(shape, generator=gen, dtype=bins.dtype, device=bins.device)

    # jnp.searchsorted's default side is "left".
    idx = torch.searchsorted(cdf.contiguous(), u, right=False)
    below = torch.clamp(idx - 1, 0, cdf.shape[-1] - 1)
    above = torch.clamp(idx, 0, cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bin_b = torch.gather(bins, -1, torch.clamp(below, 0, bins.shape[-1] - 1))
    bin_a = torch.gather(bins, -1, torch.clamp(above, 0, bins.shape[-1] - 1))
    denom = torch.where(cdf_a - cdf_b < 1e-5, torch.ones_like(cdf_a), cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    return bin_b + t * (bin_a - bin_b)


def points_along_rays(
    rays_o: torch.Tensor, rays_d: torch.Tensor, z_vals: torch.Tensor
) -> torch.Tensor:
    """``o + d * z`` -> ``[N, S, 3]`` sample points."""
    return rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
