"""Per-ray volumetric renderer over the grid hierarchy.

- near = 0.01 * gt_depth; far = min(ray exit from the scene bound + 0.01,
  1.2 * max gt_depth);
- ``n_surface`` samples in [1-band, 1+band] * gt_depth plus ``n_samples``
  stratified samples, sort-merged;
- points outside the scene bound get occupancy 100 (forced opaque) after the
  decoder; the returned per-sample ``occ`` is the logit before that override.

The z-values are built on DETACHED rays while the sample points use the live
rays, so pose gradients (and forward-mode tangents) reach the points but not
the sample placement.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..core import compositing, rays as rays_mod, sampling
from ..models.decoders import nice_forward


class RenderConfig(NamedTuple):
    n_samples: int = 32
    n_surface: int = 16
    n_importance: int = 0
    perturb: float = 0.0
    lindisp: bool = False
    occupancy: bool = True
    surface_band: float = 0.05


def render_rays(
    params,
    grids: Dict[str, torch.Tensor],
    bounds: Dict[str, torch.Tensor],
    scene_bound: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    gt_depth: Optional[torch.Tensor],
    stage: str,
    cfg: RenderConfig = RenderConfig(),
    gen: Optional[torch.Generator] = None,
) -> compositing.RenderOutputs:
    """Render a ray batch ``[N, 3]`` at the given stage.

    ``gt_depth=None`` renders without depth guidance (no surface samples).
    ``gen`` feeds the stratified jitter when ``cfg.perturb > 0``.
    """
    det_o = rays_o.detach()
    det_d = rays_d.detach()
    n_surface = cfg.n_surface if gt_depth is not None else 0

    near, far = rays_mod.near_far_from_bound(
        det_o, det_d, scene_bound, gt_depth, cfg.n_samples
    )
    z_vals = sampling.stratified_z_vals(near, far, cfg.n_samples, cfg.perturb, gen)
    if n_surface > 0:
        z_surf = sampling.surface_z_vals(gt_depth, n_surface, cfg.surface_band)
        z_vals = sampling.merge_z_vals(z_vals, z_surf)

    def eval_composite(z_vals):
        pts = sampling.points_along_rays(rays_o, rays_d, z_vals)  # [N, S, 3]
        n_rays, S = pts.shape[0], pts.shape[1]
        flat = pts.reshape(-1, 3)
        raw = nice_forward(params, grids, flat, bounds, stage)  # [N*S, 4]
        inside = torch.all(
            (flat > scene_bound[:, 0]) & (flat < scene_bound[:, 1]), dim=-1
        )
        occ = torch.where(inside, raw[:, 3], torch.full_like(raw[:, 3], 100.0))
        full = torch.cat([raw[:, :3], occ[:, None]], dim=-1).reshape(n_rays, S, 4)
        out = compositing.raw_to_outputs(full, z_vals, rays_d, occupancy=cfg.occupancy)
        return out._replace(
            occ=raw[:, 3].reshape(n_rays, S),
            z_vals=z_vals,
            sample_valid=inside.reshape(n_rays, S),
        )

    out = eval_composite(z_vals)
    if cfg.n_importance > 0:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_imp = sampling.sample_pdf(
            mids, out.weights[..., 1:-1].detach(), cfg.n_importance, gen,
            deterministic=gen is None,
        )
        z_all = sampling.merge_z_vals(z_vals, z_imp.detach())
        out = eval_composite(z_all)
    return out
