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

:func:`render_image` renders a whole image in row chunks (visualizer and
evaluation), without gradients.
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


def ray_samples(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    scene_bound: torch.Tensor,
    gt_depth: Optional[torch.Tensor],
    cfg: RenderConfig = RenderConfig(),
    gen: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The sample depths ``z_vals [N, S]`` of :func:`render_rays`' first
    evaluation, placed on the detached rays: ``n_samples`` stratified, and
    with ``gt_depth`` ``n_surface`` around it, sort-merged."""
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
    return z_vals


def evaluate_z_vals(
    params,
    grids: Dict[str, torch.Tensor],
    bounds: Dict[str, torch.Tensor],
    scene_bound: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z_vals: torch.Tensor,
    stage: str,
    cfg: RenderConfig = RenderConfig(),
) -> compositing.RenderOutputs:
    """One evaluation of :func:`render_rays`: decode the points at depths
    ``z_vals [N, S]`` on the live rays and composite them; ``occ`` is the
    logit before the out-of-bound override, ``sample_valid`` the in-bound
    mask."""
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


def importance_z_vals(
    z_vals: torch.Tensor,
    weights: torch.Tensor,
    cfg: RenderConfig,
    gen: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The depths of :func:`render_rays`' second evaluation: ``z_vals`` and
    ``cfg.n_importance`` samples of the first evaluation's detached
    ``weights`` (deterministic without ``gen``), sort-merged and detached."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_imp = sampling.sample_pdf(
        mids, weights[..., 1:-1].detach(), cfg.n_importance, gen,
        deterministic=gen is None,
    )
    return sampling.merge_z_vals(z_vals, z_imp.detach())


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
    z_vals: Optional[torch.Tensor] = None,
) -> compositing.RenderOutputs:
    """Render a ray batch ``[N, 3]`` at the given stage.

    ``gt_depth=None`` renders without depth guidance (no surface samples).
    ``gen`` feeds the stratified jitter when ``cfg.perturb > 0``, and the
    importance draws. With ``cfg.n_importance > 0`` the first evaluation's
    weights place the depths of a second one (:func:`importance_z_vals`),
    whose outputs are returned. ``z_vals`` given are the depths of the last
    evaluation, placed by the caller (the map-sharded mapping program,
    ``parallel/sharded_mapper.py``): then only that one runs.
    """
    if z_vals is None:
        z_vals = ray_samples(rays_o, rays_d, scene_bound, gt_depth, cfg, gen)
        if cfg.n_importance > 0:
            first = evaluate_z_vals(params, grids, bounds, scene_bound, rays_o, rays_d,
                                    z_vals, stage, cfg)
            z_vals = importance_z_vals(z_vals, first.weights, cfg, gen)
    return evaluate_z_vals(params, grids, bounds, scene_bound, rays_o, rays_d, z_vals,
                           stage, cfg)


def render_image(
    params,
    grids: Dict[str, torch.Tensor],
    bounds: Dict[str, torch.Tensor],
    scene_bound: torch.Tensor,
    intr: rays_mod.Intrinsics,
    c2w: torch.Tensor,
    gt_depth: Optional[torch.Tensor] = None,
    stage: str = "color",
    cfg: RenderConfig = RenderConfig(),
    rows_per_chunk: int = 16,
    programs=None,
) -> compositing.RenderOutputs:
    """Render the image at pose ``c2w`` in chunks of ``rows_per_chunk * W``
    rays, as the JAX package's ``render_image`` does: H is padded to a
    multiple of ``rows_per_chunk`` by repeating the last row (rays and
    ``gt_depth``), each chunk goes through :func:`render_rays` (its far
    bound reads the chunk's own largest depth), and the padding is cropped
    off. Returns ``rgb [H, W, 3]``, ``depth``, ``depth_var [H, W]`` and
    ``weights [H, W, S]``.

    A chunk is one program (``slam/programs.py``; the counterpart of the
    JAX package's ``lax.map`` in one jitted program), keyed on the stage,
    ``cfg``, ``rows_per_chunk``, W, whether ``gt_depth`` is given, the
    grids' shapes and the sampler route: the map is copied into its buffers
    once per image, each chunk's rays before its call. The program lives in
    ``programs`` (a ``slam.programs.Programs``), by default the process-wide
    ones, graphs on a card; ``Programs(capture=False)`` runs the same
    buffers eagerly (on a card, only to compare the two). It passes no generator,
    so nothing is drawn: ``cfg.n_importance`` samples deterministically,
    and ``cfg.perturb > 0`` raises, as in the JAX package."""
    from ..slam.programs import shared_programs  # slam imports this module

    if cfg.perturb > 0.0:
        raise ValueError("render_image draws nothing: perturb > 0 needs a generator")
    H, W = intr.H, intr.W
    pad = (-H) % rows_per_chunk
    n = rows_per_chunk * W
    with torch.no_grad():
        ro, rd = rays_mod.rays_for_image(intr, c2w)
        if pad:
            ro = torch.cat([ro, ro[-1:].expand(pad, W, 3)], 0)
            rd = torch.cat([rd, rd[-1:].expand(pad, W, 3)], 0)
            if gt_depth is not None:
                gt_depth = torch.cat([gt_depth, gt_depth[-1:].expand(pad, W)], 0)
        ro, rd = ro.reshape(-1, n, 3), rd.reshape(-1, n, 3)
        chunks = [(ro[k], rd[k]) for k in range(ro.shape[0])]
        if gt_depth is not None:
            gd = gt_depth.reshape(-1, n)
            chunks = [(o, d, gd[k]) for k, (o, d) in enumerate(chunks)]

    def chunk(params, grids, bounds, scene_bound, o, d, g=None):
        out = render_rays(params, grids, bounds, scene_bound, o, d, g, stage, cfg)
        return out.rgb, out.depth, out.depth_var, out.weights

    fixed = (params, grids, bounds, scene_bound)
    if programs is None:
        programs = shared_programs(c2w.device)
    prog = programs.static_program(
        f"render_chunk {stage} rows={rows_per_chunk} W={W}", (cfg,), c2w.device, chunk, fixed,
        chunks[0])
    prog.load(*fixed)
    outs = [tuple(t.clone() for t in prog.run(*args)) for args in chunks]
    Hp = H + pad
    rgb, depth, depth_var, weights = (torch.cat(ts) for ts in zip(*outs))
    return compositing.RenderOutputs(
        rgb=rgb.reshape(Hp, W, 3)[:H],
        depth=depth.reshape(Hp, W)[:H],
        depth_var=depth_var.reshape(Hp, W)[:H],
        weights=weights.reshape(Hp, W, -1)[:H],
    )
