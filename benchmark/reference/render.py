"""Plain PyTorch reference of NICE-SLAM's render path.

Written from the method's published description (Zhu et al., "NICE-SLAM",
CVPR 2022, and the upstream code's defaults), in float32 with TF32 off and
no kernels, graphs, caches or batching tricks:

- rays from a pinhole camera looking along -z (x right, y up);
- per ray ``N_samples`` depths evenly spaced from ``0.01 d`` to the ray's
  exit from the scene bound (at most ``1.2`` times the batch's largest
  depth), and ``N_surface`` depths evenly spaced in ``[0.95 d, 1.05 d]``,
  merged in order; the depths are placed on the detached rays, so pose
  derivatives reach the points but not their placement;
- trilinear interpolation of each level's ``[Z, Y, X, C]`` feature grid
  with ``grid_sample``'s ``align_corners=True`` and border clamping, written
  as the weighted sum of the eight corner rows;
- the decoders: 93 Gaussian Fourier features ``sin(x B)``, five ReLU layers
  of width 32, each adding a linear map of the sampled feature, the
  features concatenated again after layer 2; the coarse decoder reads the
  feature alone; the fine occupancy is the middle decoder's plus the fine
  decoder's residual (the fine decoder reads its feature and the detached
  middle one); colour comes from the colour decoder;
- points outside the scene bound are opaque (occupancy 100);
- alpha ``sigmoid(10 occ)``, transmittance the exclusive product of
  ``1 - alpha + 1e-10``, and depth, colour and depth variance as the
  weighted sums.

Nothing here imports the program under test.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

SKIPS = (2,)


class Camera(NamedTuple):
    H: int
    W: int
    fx: float
    fy: float
    cx: float
    cy: float


def camera(cam: dict) -> Camera:
    """The cropped pinhole camera of a configuration's ``cam`` block."""
    e = cam["crop_edge"]
    return Camera(cam["H"] - 2 * e, cam["W"] - 2 * e, cam["fx"], cam["fy"],
                  cam["cx"] - e, cam["cy"] - e)


def pixel_dirs(cam: Camera, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    return torch.stack([(i - cam.cx) / cam.fx, -(j - cam.cy) / cam.fy, -torch.ones_like(i)],
                       dim=-1)


def trilinear(grid: torch.Tensor, pts: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """``grid [Z, Y, X, C]`` at world points ``pts [N, 3]`` inside ``bound
    [3, 2]`` (x, y, z rows) -> ``[N, C]``."""
    Z, Y, X, C = grid.shape
    lo, hi = bound[:, 0], bound[:, 1]
    n = (pts - lo) / (hi - lo) * 2.0 - 1.0
    v = [torch.clamp((n[:, a] + 1.0) * 0.5 * (d - 1), 0.0, d - 1)
         for a, d in ((2, Z), (1, Y), (0, X))]
    start = [torch.floor(c).long().clamp(0, d - 2) for c, d in zip(v, (Z, Y, X))]
    w = [c - s.to(c.dtype) for c, s in zip(v, start)]
    flat = grid.reshape(-1, C)
    out = torch.zeros((pts.shape[0], C), dtype=grid.dtype, device=grid.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                row = ((start[0] + dz) * Y + (start[1] + dy)) * X + (start[2] + dx)
                wt = ((w[0] if dz else 1 - w[0]) * (w[1] if dy else 1 - w[1])
                      * (w[2] if dx else 1 - w[2]))
                out = out + wt[:, None] * flat.index_select(0, row)
    return out


def _dense(p, x):
    return x @ p["w"] + p["b"]


def mlp(p, pts, feat):
    """A middle, fine or colour decoder."""
    emb = torch.sin(pts @ p["embed_B"].detach())
    h = emb
    for k in range(len(p["linears"])):
        h = torch.relu(_dense(p["linears"][k], h)) + _dense(p["fc_c"][k], feat)
        if k in SKIPS:
            h = torch.cat([emb, h], dim=-1)
    return _dense(p["out"], h)


def mlp_no_xyz(p, feat):
    """The coarse decoder."""
    h = feat
    for k in range(len(p["linears"])):
        h = torch.relu(_dense(p["linears"][k], h))
        if k in SKIPS:
            h = torch.cat([feat, h], dim=-1)
    return _dense(p["out"], h)


def decode(dec, grids, bounds, pts, stage: str):
    """``(rgb [N, 3] or None, occupancy [N])`` at a mapping stage."""
    if stage == "coarse":
        return None, mlp_no_xyz(dec["coarse"], trilinear(grids["coarse"], pts,
                                                          bounds["coarse"]))[:, 0]
    mid = trilinear(grids["middle"], pts, bounds["middle"])
    occ = mlp(dec["middle"], pts, mid)[:, 0]
    if stage == "middle":
        return None, occ
    fine = trilinear(grids["fine"], pts, bounds["fine"])
    occ = occ + mlp(dec["fine"], pts, torch.cat([fine, mid.detach()], dim=-1))[:, 0]
    if stage == "fine":
        return None, occ
    col = trilinear(grids["color"], pts, bounds["color"])
    return mlp(dec["color"], pts, col)[:, :3], occ


class Render(NamedTuple):
    rgb: torch.Tensor
    depth: torch.Tensor
    var: torch.Tensor


def sample_depths(rays_o, rays_d, gt_depth, scene_bound, n_samples: int, n_surface: int,
                  band: float = 0.05) -> torch.Tensor:
    """The sample depths ``[N, n_samples + n_surface]`` on detached rays."""
    o, d = rays_o.detach(), rays_d.detach()
    t = (scene_bound[None] - o[:, :, None]) / d[:, :, None]
    exit_ = torch.amin(torch.amax(t, dim=2), dim=1)[:, None] + 0.01
    gt = gt_depth.reshape(-1, 1)
    near = gt * 0.01
    far = torch.minimum(torch.clamp(exit_, min=0.0), torch.amax(gt * 1.2))
    s = torch.linspace(0.0, 1.0, n_samples, dtype=gt.dtype, device=gt.device)
    z = near * (1.0 - s) + far * s
    u = torch.linspace(0.0, 1.0, n_surface, dtype=gt.dtype, device=gt.device)
    surf = (1.0 - band) * gt * (1.0 - u) + (1.0 + band) * gt * u
    surf = torch.where(gt > 0.0, surf, (0.001 * (1.0 - u) + torch.amax(gt) * u)[None])
    return torch.sort(torch.cat([z, surf], dim=-1), dim=-1).values


def render(dec, grids, bounds, scene_bound, rays_o, rays_d, gt_depth, stage: str,
           n_samples: int, n_surface: int) -> Render:
    """Colour, depth and depth variance of each ray ``[N, 3]``."""
    z = sample_depths(rays_o, rays_d, gt_depth, scene_bound, n_samples, n_surface)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    n, S = z.shape
    flat = pts.reshape(-1, 3)
    rgb, occ = decode(dec, grids, bounds, flat, stage)
    inside = torch.all((flat > scene_bound[:, 0]) & (flat < scene_bound[:, 1]), dim=-1)
    occ = torch.where(inside, occ, torch.full_like(occ, 100.0)).reshape(n, S)
    alpha = torch.sigmoid(10.0 * occ)
    keep = 1.0 - alpha + 1e-10
    trans = torch.cumprod(torch.cat([torch.ones_like(keep[:, :1]), keep[:, :-1]], dim=-1),
                          dim=-1)
    wts = alpha * trans
    depth = torch.sum(wts * z, dim=-1)
    var = torch.sum(wts * (z - depth[:, None]) ** 2, dim=-1)
    if rgb is None:
        col = torch.zeros((n, 3), dtype=z.dtype, device=z.device)
    else:
        col = torch.sum(wts[..., None] * rgb.reshape(n, S, 3), dim=-2)
    return Render(col, depth, var)


# ------------------------------------------------------------------ poses
def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternions ``[..., 4]`` (w, x, y, z; any norm) -> ``[..., 3, 3]``."""
    w, x, y, z = q.unbind(-1)
    s = 2.0 / torch.sum(q * q, dim=-1)
    return torch.stack([
        torch.stack([1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)], -1),
        torch.stack([s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)], -1),
        torch.stack([s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)], -1),
    ], dim=-2)


def homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype, device=top.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def cam_to_c2w(cam: torch.Tensor) -> torch.Tensor:
    """Camera vectors ``[..., 7]`` (quaternion, translation) -> ``[..., 4, 4]``."""
    return homogeneous(quat_to_rot(cam[..., :4]), cam[..., 4:])


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist ``[6]`` (rotation, translation) -> ``[4, 4]``."""
    w, v = xi[:3], xi[3:]
    th2 = torch.sum(w * w)
    small = th2 < 1e-12
    th2s = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2s)
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2s)
    Cc = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (1.0 - A) / th2s)
    z = torch.zeros_like(w[0])
    K = torch.stack([torch.stack([z, -w[2], w[1]]), torch.stack([w[2], z, -w[0]]),
                     torch.stack([-w[1], w[0], z])])
    I3 = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = I3 + A * K + B * (K @ K)
    V = I3 + B * K + Cc * (K @ K)
    return homogeneous(R, V @ v)


def load_npz_decoders(path: str, device) -> Dict:
    """The decoders of a flat ``.npz`` (keys ``level/linears/0/w``, weights
    ``[in, out]``), as nested dicts and lists on ``device``."""
    import numpy as np

    blob = np.load(path)
    tree: dict = {}
    for key in blob.files:
        parts = key.split("/")
        node = tree
        for p, nxt in zip(parts[:-1], parts[1:]):
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.as_tensor(blob[key], dtype=torch.float32, device=device)

    def lists(node):
        if isinstance(node, dict) and node and all(k.isdigit() for k in node):
            return [lists(node[str(k)]) for k in range(len(node))]
        if isinstance(node, dict):
            return {k: lists(v) for k, v in node.items()}
        return node

    return lists(tree)


def leaves(tree, prefix: str = ""):
    """``(path, tensor)`` of every leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for k, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def level_bounds(bound, divisable: float, coarse_enlarge: float, device):
    """The scene bound snapped so that each extent is a multiple of
    ``divisable``, and each level's sampling bound (the coarse level's
    enlarged about the origin)."""
    import numpy as np

    b = np.asarray(bound, np.float32).copy()
    ext = b[:, 1] - b[:, 0]
    b[:, 1] = (np.floor(ext / divisable).astype(np.int64) + 1) * divisable + b[:, 0]
    out = {lvl: torch.as_tensor(b * (coarse_enlarge if lvl == "coarse" else 1.0),
                                device=device) for lvl in ("coarse", "middle", "fine", "color")}
    return torch.as_tensor(b, device=device), out


def init_grids(bound, grid_len: dict, c_dim: int, coarse_enlarge: float, seed: int):
    """The four grids as NICE-SLAM initialises them, drawn from a CPU
    generator seeded with ``seed``: N(0, 0.01^2), the fine level N(0, 1e-4^2),
    each level ``[Z, Y, X, C]`` over the snapped bound."""
    import numpy as np

    b = np.asarray(bound, np.float32).copy()
    ext = b[:, 1] - b[:, 0]
    div = grid_len["bound_divisable"]
    b[:, 1] = (np.floor(ext / div).astype(np.int64) + 1) * div + b[:, 0]
    gen = torch.Generator().manual_seed(seed)
    grids = {}
    for lvl in ("coarse", "middle", "fine", "color"):
        e = (b[:, 1] - b[:, 0]) * (coarse_enlarge if lvl == "coarse" else 1.0)
        n = [max(int(x / grid_len[lvl]), 2) for x in e]
        g = torch.randn((n[2], n[1], n[0], c_dim), generator=gen, dtype=torch.float32)
        grids[lvl] = g * (1e-4 if lvl == "fine" else 0.01)
    return grids


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.detach().to(device).clone()
