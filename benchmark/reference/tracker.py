"""Plain PyTorch reference of the Gauss-Newton pose solve.

Each iteration draws a fresh pixel batch (rows then columns, inside the
``ignore_edge`` crop, from the generator handed in), renders it at the
current twist ``xi`` about the warm start and linearises depth and colour
with ``torch.func.jacfwd`` of the plain render (``render.py``):

- depth residuals are normalised by the rendered depth's standard deviation
  and weighted by Huber IRLS weights; pixels more than 10 median
  normalised errors off are dropped, and so are pixels whose absolute depth
  error passes ``depth_err_gate``, unless that would drop over 80 % of them;
- colour residuals are Huber-weighted at a scale of 0.2 and multiplied by
  ``w_color_loss``;
- the normal equations get a diagonal motion prior (0.02 rad, 0.03 m, and
  the depth offset's sigma when a scalar depth-offset column is estimated),
  relative Levenberg-Marquardt damping of 0.01 and 1e-6 on the diagonal;
- the pose step is clipped to a norm of ``gn_step_clip``.

The solve returns the last iterate and each iteration's robust loss.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from . import render as R

COLOR_SIGMA = 0.2
LM_DAMPING = 1e-2


def draw(gen: torch.Generator, cam: R.Camera, n: int, iters: int, edge_h: int, edge_w: int,
         device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    out = []
    for _ in range(iters):
        j = torch.randint(edge_h, cam.H - edge_h, (n,), generator=gen, device=device)
        i = torch.randint(edge_w, cam.W - edge_w, (n,), generator=gen, device=device)
        out.append((i, j))
    return out


def huber(x):
    ax = torch.abs(x)
    return torch.where(ax <= 1.0, 0.5 * x * x, ax - 0.5)


def gn_iteration(dec, grids, bounds, scene_bound, cam: R.Camera, color, depth, init, xi,
                 i, j, t: dict, n_samples: int, n_surface: int):
    n = i.shape[0]
    dev = init.device
    dirs = R.pixel_dirs(cam, i.float(), j.float())
    gt_d = depth[j, i]
    gt_c = color[j, i]

    def at(x):
        T = R.se3_exp(x) @ init
        rd = dirs @ T[:3, :3].T
        ro = T[:3, 3].expand(rd.shape)
        out = R.render(dec, grids, bounds, scene_bound, ro, rd, gt_d, "color",
                       n_samples, n_surface)
        return (out.depth, out.rgb), (out.depth, out.rgb, out.var)

    with torch.no_grad():
        (Jd, Jc), (d, rgb, var) = torch.func.jacfwd(at, has_aux=True)(xi)
    Jc = Jc.reshape(n * 3, 6)
    e = d - gt_d
    inv_sig = 1.0 / torch.sqrt(var + 1e-10)
    u = e * inv_sig
    mask = (gt_d > 0).float()
    if t["handle_dynamic"]:
        mask = mask * (torch.abs(u) < 10.0 * torch.quantile(torch.abs(u), 0.5)).float()
    if t["depth_err_gate"] > 0:
        gate = (torch.abs(e) < t["depth_err_gate"]).float()
        keep = torch.sum(mask * gate) / torch.clamp(torch.sum(mask), min=1.0)
        mask = mask * torch.where(keep < 0.2, torch.ones_like(gate), gate)
    wd = mask * torch.clamp(1.0 / torch.clamp(torch.abs(u), min=1e-6), max=1.0) * inv_sig ** 2
    ec = rgb - gt_c
    uc = ec / COLOR_SIGMA
    if t["use_color_in_tracking"]:
        wc = (t["w_color_loss"] * mask[:, None]
              * torch.clamp(1.0 / torch.clamp(torch.abs(uc), min=1e-6), max=1.0)
              / COLOR_SIGMA ** 2)
    else:
        wc = torch.zeros_like(ec)
    sig = [t["gn_prior_sigma_r"]] * 3 + [t["gn_prior_sigma_t"]] * 3
    x_a = xi
    if t["gn_depth_offset_sigma"] > 0:
        Jd = torch.cat([Jd, torch.ones((n, 1), device=dev)], dim=1)
        Jc = torch.cat([Jc, torch.zeros((n * 3, 1), device=dev)], dim=1)
        x_a = torch.cat([xi, torch.zeros((1,), device=dev)])
        sig.append(t["gn_depth_offset_sigma"])
    prior = torch.diag(1.0 / torch.tensor(sig, dtype=torch.float32, device=dev) ** 2)
    A = Jd.T @ (wd[:, None] * Jd) + Jc.T @ (wc.reshape(-1, 1) * Jc)
    g = Jd.T @ (wd * e) + Jc.T @ (wc * ec).reshape(-1)
    A = A + prior + LM_DAMPING * torch.diag(torch.diag(A)) + 1e-6 * torch.eye(len(sig),
                                                                              device=dev)
    g = g + prior @ x_a
    step = -torch.linalg.solve(A, g)[:6]
    step = step * torch.clamp(t["gn_step_clip"] / (torch.linalg.norm(step) + 1e-12), max=1.0)
    loss = torch.sum(mask * huber(u))
    if t["use_color_in_tracking"]:
        loss = loss + t["w_color_loss"] * torch.sum(mask[:, None] * huber(uc))
    return xi + step, loss


def gn_solve(dec, grids, bounds, scene_bound, cam: R.Camera, color, depth, init,
             draws, t: dict, n_samples: int, n_surface: int):
    """``(c2w [4, 4], losses [iters])`` of the solve from ``init`` on the
    per-iteration pixel ``draws``."""
    xi = torch.zeros(6, dtype=torch.float32, device=init.device)
    losses = []
    for i, j in draws:
        xi, loss = gn_iteration(dec, grids, bounds, scene_bound, cam, color, depth, init, xi,
                                i, j, t, n_samples, n_surface)
        losses.append(loss)
    return R.se3_exp(xi) @ init, torch.stack(losses)
