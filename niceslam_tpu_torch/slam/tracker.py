"""Camera tracker: the pose solve against the map, by one of two methods.

``method="gn"`` (the default), damped Gauss-Newton / IRLS. Per iteration: a
FRESH pixel batch; residuals are metric depth + color errors at the current
twist ``xi`` (a local se(3) perturbation of the warm start); the Jacobian
comes from ``torch.func.jacfwd`` of the whole render (6 tangents, vmapped,
through the sampler's ``jvp``/``vmap`` rules); IRLS Huber weights on the
uncertainty-normalized errors; the 10 x median dynamic-pixel rule and the
absolute depth gate with its 80 %-masked fallback; a motion-model prior,
relative Levenberg-Marquardt damping, an optional scalar depth-offset
nuisance column, and a per-iteration step clip. The solve returns the FINAL
iterate.

``method="adam"``, the reference's first-order loop: per iteration a fresh
pixel batch, :func:`tracking_loss` and its gradient with respect to the
7-vector camera tensor (reverse mode: on the fused route K2 runs with no
grid gradient), and ``optax.scale_by_adam``'s step (the mapper's
hand-written one) scaled by ``lr``, or with ``separate_LR`` by ``0.2 lr``
on the quaternion and ``lr`` on the translation. It returns the BEST iterate:
the post-step tensor of the iteration whose pre-step loss was the lowest.

Pixel draws are injectable (``pixels``) so a test can replay the JAX
reference's draws; by default they come from a ``torch.Generator``.

A solve is a loop of :func:`track_iteration` over a :class:`SolveState`
whose device step counter picks each iteration's draws and bias
corrections, so one captured CUDA graph of an iteration serves the whole
solve (``slam/programs.py``); :func:`track_frame` runs it eagerly.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.pose import camera_from_tensor, se3_exp, tensor_from_camera, to_homogeneous
from ..core.rays import Intrinsics, draw_pixels, pixel_dirs, sample_rays
from ..render.renderer import RenderConfig, render_rays
from .mapper import adam_direction, adam_moments_, bias_corrections, stack_draws


class TrackConfig(NamedTuple):
    pixels: int = 200
    iters: int = 10
    lr: float = 1e-3
    separate_LR: bool = False
    use_color: bool = True
    w_color_loss: float = 0.5
    handle_dynamic: bool = True
    depth_err_gate: float = 0.3
    method: str = "gn"
    gn_lambda: float = 1e-2
    gn_step_clip: float = 0.02
    gn_color_sigma: float = 0.2
    gn_prior_sigma_r: float = 0.02
    gn_prior_sigma_t: float = 0.03
    gn_depth_offset_sigma: float = 0.0
    ignore_edge_H: int = 20
    ignore_edge_W: int = 20


def track_config(t) -> TrackConfig:
    """The tracker's knobs from a ``TrackingConfig`` (``cfg.tracking``)."""
    return TrackConfig(
        pixels=t.pixels,
        iters=t.iters,
        lr=t.lr,
        separate_LR=t.seperate_LR,
        use_color=t.use_color_in_tracking,
        w_color_loss=t.w_color_loss,
        handle_dynamic=t.handle_dynamic,
        depth_err_gate=t.depth_err_gate,
        method=t.method,
        gn_prior_sigma_r=t.gn_prior_sigma_r,
        gn_prior_sigma_t=t.gn_prior_sigma_t,
        gn_step_clip=t.gn_step_clip,
        gn_depth_offset_sigma=t.gn_depth_offset_sigma,
        ignore_edge_H=t.ignore_edge_H,
        ignore_edge_W=t.ignore_edge_W,
    )


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
    # No error check: on the card it would read the solver's status back,
    # which waits for the stream every iteration.
    delta = -torch.linalg.solve_ex(A, g, check_errors=False)[0][:6]
    nrm = torch.linalg.norm(delta)
    delta = delta * torch.clamp(cfg.gn_step_clip / (nrm + 1e-12), max=1.0)

    loss = torch.sum(mask * huber(u))
    if cfg.use_color:
        loss = loss + cfg.w_color_loss * torch.sum(mask[:, None] * huber(uc))
    return xi + delta, loss


def tracking_loss(
    params, grids, bounds, scene_bound, intr: Intrinsics,
    cam_tensor: torch.Tensor, color: torch.Tensor, depth: torch.Tensor,
    i: torch.Tensor, j: torch.Tensor, cfg: TrackConfig, rcfg: RenderConfig,
) -> torch.Tensor:
    """The Adam tracker's loss at camera tensor ``cam_tensor [7]`` on pixels
    ``(i, j)``: uncertainty-weighted depth L1 plus ``w_color_loss`` times the
    color L1 over the pixels that pass the 10 x median rule and the absolute
    depth gate (dropped for the batch when it would keep < 20 % of them). The
    variance and both masks carry no gradient."""
    c2w = to_homogeneous(camera_from_tensor(cam_tensor))
    batch = sample_rays(intr, c2w, depth, color, i, j)
    out = render_rays(
        params, grids, bounds, scene_bound, batch.rays_o, batch.rays_d,
        batch.gt_depth, "color", rcfg,
    )
    abs_err = torch.abs(batch.gt_depth - out.depth)
    err = abs_err / torch.sqrt(out.depth_var.detach() + 1e-10)
    mask = batch.gt_depth > 0
    if cfg.handle_dynamic:
        e = err.detach()
        # jnp.median averages the two middle values; torch.median does not.
        mask = mask & (e < 10.0 * torch.quantile(e, 0.5))
    if cfg.depth_err_gate > 0:
        gate = abs_err.detach() < cfg.depth_err_gate
        keep_frac = torch.sum((mask & gate).to(torch.float32)) / torch.clamp(
            torch.sum(mask.to(torch.float32)), min=1.0
        )
        mask = mask & (gate | (keep_frac < 0.2))
    w = mask.to(err.dtype)
    loss = torch.sum(err * w)
    if cfg.use_color:
        closs = torch.sum(torch.abs(batch.gt_color - out.rgb) * w[:, None])
        loss = loss + cfg.w_color_loss * closs
    return loss


def adam_lr(cfg: TrackConfig, device) -> torch.Tensor:
    """The Adam step's learning rate per camera-tensor entry, float32 ``[7]``:
    ``lr``, or with ``separate_LR`` ``0.2 lr`` on the quaternion (the
    reference's two parameter groups). Filled on ``device``."""
    q = 0.2 if cfg.separate_LR else 1.0
    return torch.cat([
        torch.full((4,), q, dtype=torch.float32, device=device),
        torch.full((3,), 1.0, dtype=torch.float32, device=device),
    ]) * cfg.lr


class SolveState(NamedTuple):
    """What one pose solve's iterations read and write besides the map and
    the frame, all on the device: a solve is :func:`start_solve`, then
    ``iters`` calls of :func:`track_iteration` (or replays of one captured
    call, ``slam/programs.py``), then :func:`solve_result`."""

    init: torch.Tensor  # [4, 4] warm start
    pixels: torch.Tensor  # [iters, 2, P] int64: each iteration's (i, j)
    losses: torch.Tensor  # [iters] float32
    step: torch.Tensor  # [1] int64: the iteration to run
    x: torch.Tensor  # the iterate: GN twist [6], Adam camera tensor [7]
    # Adam only (None for GN): moments, best post-step tensor and its
    # pre-step loss, per-entry learning rates, bias corrections [iters].
    mu: Optional[torch.Tensor] = None
    nu: Optional[torch.Tensor] = None
    best: Optional[torch.Tensor] = None
    best_loss: Optional[torch.Tensor] = None
    lr: Optional[torch.Tensor] = None
    c1: Optional[torch.Tensor] = None
    c2: Optional[torch.Tensor] = None


def new_solve_state(cfg: TrackConfig, iters: int, device) -> SolveState:
    """Buffers for a solve of ``iters`` iterations by ``cfg.method``."""
    if cfg.method not in ("gn", "adam"):
        raise ValueError(f"unknown tracking method {cfg.method!r}; expected 'gn' or 'adam'")
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    st = SolveState(
        init=z(4, 4),
        pixels=torch.zeros((iters, 2, cfg.pixels), dtype=torch.long, device=device),
        losses=z(iters),
        step=torch.zeros((1,), dtype=torch.long, device=device),
        x=z(6) if cfg.method == "gn" else z(7),
    )
    if cfg.method == "gn":
        return st
    c1, c2 = bias_corrections(iters, device)
    return st._replace(mu=z(7), nu=z(7), best=z(7), best_loss=z(), lr=adam_lr(cfg, device),
                       c1=c1, c2=c2)


@torch.no_grad()
def start_solve(st: SolveState, init: torch.Tensor, pixels: torch.Tensor) -> None:
    """Set ``st`` to the start of a solve from ``init [4, 4]`` on the draws
    ``pixels [iters, 2, P]``."""
    st.init.copy_(init)
    st.pixels.copy_(pixels)
    st.step.zero_()
    if st.mu is None:
        st.x.zero_()
        return
    st.x.copy_(tensor_from_camera(st.init))
    st.best.copy_(st.x)
    st.best_loss.fill_(float("inf"))
    st.mu.zero_()
    st.nu.zero_()


def track_iteration(
    params, grids, bounds, scene_bound, intr: Intrinsics,
    color: torch.Tensor, depth: torch.Tensor, st: SolveState,
    cfg: TrackConfig, rcfg: RenderConfig,
) -> None:
    """Iteration ``st.step`` of the solve, in place on ``st``: GN's
    linearization and step, or Adam's gradient and step with its best-iterate
    rule; its loss into ``st.losses``; then the step counter + 1. Every value
    that changes from one iteration to the next is read from the device."""
    i, j = st.pixels.index_select(0, st.step)[0]
    if st.mu is None:
        x, loss = gn_step(
            params, grids, bounds, scene_bound, intr, color, depth, st.init,
            st.x, i, j, cfg, rcfg,
        )
        with torch.no_grad():
            st.x.copy_(x)
    else:
        c = st.x.detach().requires_grad_(True)
        loss = tracking_loss(
            params, grids, bounds, scene_bound, intr, c, color, depth, i, j, cfg, rcfg,
        )
        (g,) = torch.autograd.grad(loss, c)
        with torch.no_grad():
            loss = loss.detach()
            adam_moments_(st.mu, st.nu, g)
            c1, c2 = (t.index_select(0, st.step) for t in (st.c1, st.c2))
            new = st.x - st.lr * adam_direction(st.mu, st.nu, c1, c2)
            # The reference keeps the post-step tensor when the pre-step loss
            # improves on the best so far.
            better = loss < st.best_loss
            st.best.copy_(torch.where(better, new, st.best))
            st.best_loss.copy_(torch.where(better, loss, st.best_loss))
            st.x.copy_(new)
    with torch.no_grad():
        st.losses.index_copy_(0, st.step, loss.reshape(1))
        st.step.add_(1)


def solve_result(st: SolveState) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(c2w [4, 4], per-iteration losses [iters])`` of a finished solve:
    GN's final iterate, Adam's best; new tensors."""
    if st.mu is None:
        pose = se3_exp(st.x) @ st.init
    else:
        pose = to_homogeneous(camera_from_tensor(st.best))
    return pose, st.losses.clone()


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
    """Solve the frame's pose from ``init_c2w`` by ``cfg.method``; returns
    ``(c2w [4, 4], per-iteration losses [iters])``.

    ``pixels`` (one ``(i, j)`` pair per iteration) overrides the draws from
    ``gen``.
    """
    init = init_c2w.to(torch.float32)
    if pixels is None:
        pixels = draw_track_pixels(gen, intr, cfg, init.device)
    st = new_solve_state(cfg, len(pixels), init.device)
    start_solve(st, init, stack_draws(pixels, init.device))
    for _ in range(len(pixels)):
        track_iteration(
            params, grids, bounds, scene_bound, intr, color, depth, st, cfg, rcfg,
        )
    return solve_result(st)
