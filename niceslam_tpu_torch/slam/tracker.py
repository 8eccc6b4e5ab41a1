"""Camera tracker: damped Gauss-Newton / IRLS pose solve against the map.

Per iteration: a FRESH pixel batch; residuals are metric depth + color
errors at the current twist ``xi`` (a local se(3) perturbation of the warm
start); the Jacobian comes from ``torch.func.jacfwd`` of the whole render
(6 tangents, vmapped, through the sampler's ``jvp``/``vmap`` rules); IRLS
Huber weights on the uncertainty-normalized errors; the 10 x median
dynamic-pixel rule and the absolute depth gate with its 80 %-masked
fallback; a motion-model prior, relative Levenberg-Marquardt damping, an
optional scalar depth-offset nuisance column, and a per-iteration step
clip. The solve returns the FINAL iterate.

Pixel draws are injectable (``pixels``) so a test can replay the JAX
reference's draws; by default they come from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.pose import se3_exp
from ..core.rays import Intrinsics, draw_pixels, pixel_dirs
from ..render.renderer import RenderConfig, render_rays


class TrackConfig(NamedTuple):
    pixels: int = 200
    iters: int = 10
    use_color: bool = True
    w_color_loss: float = 0.5
    handle_dynamic: bool = True
    depth_err_gate: float = 0.3
    gn_lambda: float = 1e-2
    gn_step_clip: float = 0.02
    gn_color_sigma: float = 0.2
    gn_prior_sigma_r: float = 0.02
    gn_prior_sigma_t: float = 0.03
    gn_depth_offset_sigma: float = 0.0
    ignore_edge_H: int = 20
    ignore_edge_W: int = 20


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """``optax.huber_loss(x, 0, delta)``."""
    ax = torch.abs(x)
    return torch.where(ax <= delta, 0.5 * x * x, delta * (ax - 0.5 * delta))


def draw_track_pixels(
    gen: Optional[torch.Generator], intr: Intrinsics, cfg: TrackConfig, device
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """One ``(i, j)`` pixel batch per GN iteration."""
    return [
        draw_pixels(gen, intr, cfg.pixels, cfg.ignore_edge_H, cfg.ignore_edge_W, device)
        for _ in range(cfg.iters)
    ]


def gn_prior(cfg: TrackConfig, device) -> torch.Tensor:
    """The GN step's diagonal prior, float32 ``[k, k]``: rotation and
    translation precisions, then the depth offset's where it is estimated.
    Filled on ``device``: a ``torch.tensor`` of the values would be a copy
    from the host that waits for the stream."""
    parts = [(3, cfg.gn_prior_sigma_r), (3, cfg.gn_prior_sigma_t)]
    if cfg.gn_depth_offset_sigma > 0:
        parts.append((1, cfg.gn_depth_offset_sigma))
    return torch.diag(torch.cat([
        torch.full((k,), 1.0 / sigma**2, dtype=torch.float32, device=device)
        for k, sigma in parts
    ]))


def gn_step(
    params, grids, bounds, scene_bound, intr: Intrinsics,
    color: torch.Tensor, depth: torch.Tensor, init: torch.Tensor,
    xi: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
    cfg: TrackConfig, rcfg: RenderConfig,
):
    """One linearization at twist ``xi`` on pixels ``(i, j)``.

    Returns ``(xi_new, robust loss at xi)``.
    """
    n = i.shape[0]
    dev = init.device
    dirs_cam = pixel_dirs(intr, i.to(torch.float32), j.to(torch.float32))
    gt_d = depth[j, i]
    gt_c = color[j, i]
    valid = (gt_d > 0).to(torch.float32)

    def render_at(x):
        T = se3_exp(x) @ init
        rays_d = dirs_cam @ T[:3, :3].T
        rays_o = T[:3, 3].expand(rays_d.shape)
        out = render_rays(
            params, grids, bounds, scene_bound, rays_o, rays_d, gt_d, "color", rcfg
        )
        return (out.depth, out.rgb), (out.depth, out.rgb, out.depth_var)

    with torch.no_grad():
        (Jd, Jc), (d, rgb, var) = torch.func.jacfwd(render_at, has_aux=True)(xi)
    Jc = Jc.reshape(n * 3, 6)  # [N, 3, 6] -> [3N, 6]

    e = d - gt_d
    inv_sig = 1.0 / torch.sqrt(var + 1e-10)
    u = e * inv_sig
    mask = valid
    if cfg.handle_dynamic:
        # jnp.median averages the two middle values; torch.median does not.
        med = torch.quantile(torch.abs(u), 0.5)
        mask = mask * (torch.abs(u) < 10.0 * med).to(mask.dtype)
    if cfg.depth_err_gate > 0:
        gate = (torch.abs(e) < cfg.depth_err_gate).to(mask.dtype)
        keep_frac = torch.sum(mask * gate) / torch.clamp(torch.sum(mask), min=1.0)
        mask = mask * torch.where(keep_frac < 0.2, torch.ones_like(gate), gate)
    hub = torch.clamp(1.0 / torch.clamp(torch.abs(u), min=1e-6), max=1.0)
    wd = mask * hub * inv_sig * inv_sig

    ec = rgb - gt_c  # [N, 3]
    uc = ec / cfg.gn_color_sigma
    hub_c = torch.clamp(1.0 / torch.clamp(torch.abs(uc), min=1e-6), max=1.0)
    if cfg.use_color:
        wc = cfg.w_color_loss * mask[:, None] * hub_c / (cfg.gn_color_sigma**2)
    else:
        wc = torch.zeros_like(ec)

    if cfg.gn_depth_offset_sigma > 0:
        # Scalar depth-offset nuisance: a column of ones on depth rows, zeros
        # on color rows, with a weak zero-mean prior; re-estimated per
        # linearization and never carried.
        Jd = torch.cat([Jd, torch.ones((n, 1), device=dev)], dim=1)
        Jc = torch.cat([Jc, torch.zeros((n * 3, 1), device=dev)], dim=1)
        x_a = torch.cat([xi, torch.zeros((1,), device=dev)])
    else:
        x_a = xi
    prior = gn_prior(cfg, dev)
    k = prior.shape[0]
    A = Jd.T @ (wd[:, None] * Jd) + Jc.T @ (wc.reshape(-1, 1) * Jc)
    g = Jd.T @ (wd * e) + Jc.T @ (wc * ec).reshape(-1)
    A = (
        A + prior + cfg.gn_lambda * torch.diag(torch.diag(A))
        + 1e-6 * torch.eye(k, device=dev)
    )
    g = g + prior @ x_a
    delta = -torch.linalg.solve(A, g)[:6]
    nrm = torch.linalg.norm(delta)
    delta = delta * torch.clamp(cfg.gn_step_clip / (nrm + 1e-12), max=1.0)

    loss = torch.sum(mask * huber(u))
    if cfg.use_color:
        loss = loss + cfg.w_color_loss * torch.sum(mask[:, None] * huber(uc))
    return xi + delta, loss


def track_frame(
    params,
    grids: Dict[str, torch.Tensor],
    bounds: Dict[str, torch.Tensor],
    scene_bound: torch.Tensor,
    intr: Intrinsics,
    color: torch.Tensor,
    depth: torch.Tensor,
    init_c2w: torch.Tensor,
    cfg: TrackConfig = TrackConfig(),
    rcfg: RenderConfig = RenderConfig(),
    gen: Optional[torch.Generator] = None,
    pixels: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve the frame's pose from ``init_c2w``; returns ``(c2w [4, 4],
    per-iteration losses [iters])``.

    ``pixels`` (one ``(i, j)`` pair per iteration) overrides the draws from
    ``gen``.
    """
    init = init_c2w.to(torch.float32)
    if pixels is None:
        pixels = draw_track_pixels(gen, intr, cfg, init.device)
    xi = torch.zeros((6,), dtype=torch.float32, device=init.device)
    losses = []
    for i, j in pixels:
        xi, loss = gn_step(
            params, grids, bounds, scene_bound, intr, color, depth, init,
            xi, i, j, cfg, rcfg,
        )
        losses.append(loss)
    return se3_exp(xi) @ init, torch.stack(losses)
