"""Plain PyTorch reference of one mapping pass.

A pass optimises the feature grids, the decoders that the configuration
trains and, under bundle adjustment, the window's camera vectors, with
Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected, one step count for the
pass) on a loss over a window of frames:

- the coarse pass: the coarse stage only; the staged pass: middle for the
  first ``int(0.4 n) + 1`` iterations, fine up to ``int(0.6 n) + 1``, colour
  for the rest, each stage with its own learning rates from the
  configuration's ``mapping.stage_*`` table (times ``lr_factor``);
- each iteration draws ``mapping.pixels`` rays: a window frame uniformly
  among the valid ones, then a row, then a column, from the generator
  handed in;
- the loss: the depth L1 over rays with a depth reading, plus in the colour
  stage ``w_color_loss`` times the colour L1;
- moments come from the unmasked gradient of every trained leaf (a leaf the
  stage does not reach gets none and its moments decay); a leaf whose
  learning rate is 0 in a row is not stepped; a grid's step is multiplied
  by its frustum mask: the voxels whose centres project into some valid
  window frame, in front of it, no deeper than its depth reading + 0.5 m;
- bundle adjustment moves the camera vectors of the frames that are not
  fixed, at ``BA_cam_lr`` in the colour stage (their moments are kept in
  every stage).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import render as R

B1, B2, EPS = 0.9, 0.999, 1e-8
LEVELS = ("coarse", "middle", "fine", "color")


def stage_plan(n: int, coarse: bool, middle_ratio: float, fine_ratio: float) -> List[str]:
    if coarse:
        return ["coarse"] * n
    n_mid = min(int(n * middle_ratio) + 1, n)
    n_fine = max(min(int(n * fine_ratio) + 1, n) - n_mid, 0)
    return ["middle"] * n_mid + ["fine"] * n_fine + ["color"] * (n - n_mid - n_fine)


def draw(gen: torch.Generator, valid: np.ndarray, n: int, rows: int, cam: R.Camera, device):
    idx = torch.as_tensor(np.flatnonzero(valid), device=device)
    out = []
    for _ in range(rows):
        k = torch.randint(0, len(idx), (n,), generator=gen, device=device)
        j = torch.randint(0, cam.H, (n,), generator=gen, device=device)
        i = torch.randint(0, cam.W, (n,), generator=gen, device=device)
        out.append((idx[k], i, j))
    return out


def invert(c2w: torch.Tensor) -> torch.Tensor:
    Rt = c2w[:3, :3].T
    return R.homogeneous(Rt, -(Rt @ c2w[:3, 3]))


def frustum_mask(poses, valid: np.ndarray, depths, cam: R.Camera, bound, shape):
    """``[Z, Y, X, 1]`` float: the voxel centres of a level that some valid
    window frame sees (``poses [F, 4, 4]``, ``depths [F, H, W]``)."""
    nz, ny, nx = shape
    b = bound.cpu().numpy()
    dev = poses.device
    zs, ys, xs = (torch.linspace(float(b[a, 0]), float(b[a, 1]), n, device=dev)
                  for a, n in ((2, nz), (1, ny), (0, nx)))
    Zg, Yg, Xg = torch.meshgrid(zs, ys, xs, indexing="ij")
    pts = torch.stack([Xg, Yg, Zg], dim=-1).reshape(-1, 3)
    seen = torch.zeros(pts.shape[0], dtype=torch.bool, device=dev)
    for f in np.flatnonzero(valid):
        w2c = invert(poses[f])
        p = pts @ w2c[:3, :3].T + w2c[:3, 3]
        z = p[:, 2]
        zs_ = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
        u = -p[:, 0] / zs_ * cam.fx + cam.cx
        v = p[:, 1] / zs_ * cam.fy + cam.cy
        obs = depths[f][torch.clamp(torch.round(v).long(), 0, cam.H - 1),
                        torch.clamp(torch.round(u).long(), 0, cam.W - 1)]
        inside = (u >= 0) & (u < cam.W) & (v >= 0) & (v < cam.H)
        ok = torch.where(obs > 0, -z <= obs + 0.5, torch.ones_like(inside))
        seen |= inside & (z < 0) & ok
    return seen.reshape(nz, ny, nx, 1).float()


def loss_at(params, bounds, scene_bound, cam: R.Camera, colors, depths, valid_t, fixed_t,
            fidx, i, j, stage: str, w_color: float, n_samples: int, n_surface: int):
    cams = torch.where(fixed_t[:, None], params["cams"].detach(), params["cams"])
    c2w = R.cam_to_c2w(cams)
    dirs = R.pixel_dirs(cam, i.float(), j.float())
    ro = c2w[fidx, :3, 3]
    rd = torch.einsum("nij,nj->ni", c2w[fidx, :3, :3], dirs)
    gt_d = depths[fidx, j, i]
    ray_w = valid_t[fidx].float()
    out = R.render(params["decoders"], params["grids"], bounds, scene_bound, ro, rd, gt_d,
                   stage, n_samples, n_surface)
    loss = torch.sum(torch.abs(gt_d - out.depth) * (gt_d > 0).float() * ray_w)
    if stage == "color":
        loss = loss + w_color * torch.sum(torch.abs(colors[fidx, j, i] - out.rgb)
                                          * ray_w[:, None])
    return loss


def map_pass(grids: Dict[str, torch.Tensor], decoders, cams, poses, colors, depths,
             valid: np.ndarray, fixed: np.ndarray, bounds, scene_bound, cam: R.Camera,
             m: dict, coarse: bool, iters: int, lr_factor: float, draws,
             trained_decoders: List[str], n_samples: int, n_surface: int,
             loss_scale: float = 1.0):
    """Run the pass; returns ``(grids, decoders, cams, losses [iters], the
    norm of the first gradient each trained leaf gets)``. ``m`` is the
    configuration's ``mapping`` block; ``loss_scale`` multiplies the loss
    (for a planted fault)."""
    if m.get("tv_weight", 0.0) or m.get("fs_weight", 0.0) or m.get("lock_after", 0):
        raise ValueError("the reference has no TV, free-space or lock terms")
    dev = colors.device
    ba = bool(np.any(valid & ~fixed))
    params = {"grids": {k: v.detach().clone().requires_grad_(True) for k, v in grids.items()},
              "decoders": R.tree_to(decoders, dev),
              "cams": cams.detach().clone().requires_grad_(ba)}
    named = [(("grids", lvl), params["grids"][lvl]) for lvl in LEVELS]
    for lvl in trained_decoders:
        for path, leaf in R.leaves(params["decoders"][lvl], f"{lvl}/"):
            leaf.requires_grad_(True)
            named.append((("decoders", lvl, path), leaf))
    if ba:
        named.append((("cams",), params["cams"]))
    leaves = [t for _, t in named]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    masks = None
    if m["frustum_feature_selection"]:
        masks = {lvl: frustum_mask(poses, valid, depths, cam, bounds[lvl], g.shape[:3])
                 for lvl, g in grids.items()}
    valid_t = torch.as_tensor(valid, device=dev)
    fixed_t = torch.as_tensor(fixed, device=dev)
    stages = stage_plan(iters, coarse, m["middle_iter_ratio"], m["fine_iter_ratio"])
    losses, first = [], {}
    one = np.float32(1.0)
    for t, (stage, (fidx, i, j)) in enumerate(zip(stages, draws), start=1):
        lrs = m[f"stage_{stage}"]
        loss = loss_at(params, bounds, scene_bound, cam, colors, depths, valid_t, fixed_t,
                       fidx, i, j, stage, m["w_color_loss"], n_samples, n_surface) * loss_scale
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        losses.append(loss.detach())
        for (key, _), g in zip(named, grads):
            if g is not None and key not in first:
                first[key] = float(torch.linalg.norm(g))
        c1 = float(one - np.float32(B1) ** np.float32(t))
        c2 = float(one - np.float32(B2) ** np.float32(t))
        with torch.no_grad():
            for (key, p), g, a, b in zip(named, grads, mu, nu):
                a.mul_(B1)
                b.mul_(B2)
                if g is not None:
                    a.add_((1 - B1) * g)
                    b.add_((1 - B2) * g * g)
                if key[0] == "grids":
                    lr = lrs[f"{key[1]}_lr"] * lr_factor
                elif key[0] == "decoders":
                    lr = lrs["decoders_lr"] * lr_factor
                else:
                    lr = m["BA_cam_lr"] if stage == "color" else 0.0
                if lr == 0.0:
                    continue
                upd = (a / c1) / (torch.sqrt(b / c2) + EPS)
                if key[0] == "grids" and masks is not None:
                    upd = upd * masks[key[1]]
                p.sub_(lr * upd)
    out_dec = R.tree_to(params["decoders"], dev)
    return ({k: v.detach() for k, v in params["grids"].items()}, out_dec,
            params["cams"].detach(), torch.stack(losses), first)
