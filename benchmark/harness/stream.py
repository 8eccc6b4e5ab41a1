"""The frame stream: a closed camera path through an analytic furnished
room, rendered on the card.

One general generator reads a traffic file's parameters:

- the room is the configuration's bound shrunk by ``shrink`` about its
  centre; ``boxes`` are furniture, each ``[cx, cy, cz, hx, hy, hz]``: its
  centre as fractions of the room (0 the room's low corner, 1 the high one)
  and its half sizes as fractions of the room's extent;
- every face is a colour of its own (the room's six walls, then each box's)
  under a texture of ``checker``-metre squares, each square's shade drawn by
  a hash of its integer coordinates between ``shade`` and 1: the pattern
  never repeats, so no view is ambiguous;
- the camera orbits the room's centre: at frame ``k`` the orbit angle is
  ``a = 2 pi orbit_fraction k / arc_frames`` at radius ``radius``, with
  height ``height_amp sin(2a)``, yaw ``yaw_rate a`` and pitch
  ``pitch_amp sin(a)``; ``period`` frames close the path;
- depth is the exact z-depth of the first surface a pixel's ray meets.

The seed sets only where on the closed path a run starts, so every seed
streams the same frames in another order.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

WALL_COLORS = np.array([
    (0.3, 0.9, 0.3), (0.9, 0.9, 0.3), (0.3, 0.9, 0.9),  # min x, y, z walls
    (0.9, 0.3, 0.3), (0.3, 0.3, 0.9), (0.9, 0.3, 0.9),  # max x, y, z walls
], np.float32)
BOX_COLORS = np.array([(0.95, 0.6, 0.2), (0.2, 0.6, 0.95), (0.6, 0.95, 0.2),
                       (0.95, 0.2, 0.6), (0.6, 0.2, 0.95), (0.2, 0.95, 0.6)], np.float32)


def room(bound, shrink: float) -> np.ndarray:
    b = np.asarray(bound, np.float64)
    c, h = b.mean(1), 0.5 * (b[:, 1] - b[:, 0]) * (1.0 - shrink)
    return np.stack([c - h, c + h], 1)


def furniture(box: np.ndarray, boxes) -> np.ndarray:
    """``[K, 3, 2]`` world bounds of the traffic's boxes inside ``box``."""
    lo, ext = box[:, 0], box[:, 1] - box[:, 0]
    out = [np.stack([lo + np.asarray(b[:3]) * ext - np.asarray(b[3:]) * ext,
                     lo + np.asarray(b[:3]) * ext + np.asarray(b[3:]) * ext], 1) for b in boxes]
    return np.asarray(out, np.float64).reshape(-1, 3, 2)


def poses(traffic: dict, box: np.ndarray) -> List[np.ndarray]:
    """The camera-to-world matrices of one period (float32 ``[4, 4]``)."""
    c = box.mean(1)
    out = []
    for k in range(traffic["period"]):
        a = 2 * math.pi * traffic["orbit_fraction"] * k / traffic["arc_frames"]
        eye = c + np.array([traffic["radius"] * math.cos(a),
                            traffic["height_amp"] * math.sin(2 * a),
                            traffic["radius"] * math.sin(a)])
        yaw, pitch = traffic["yaw_rate"] * a, traffic["pitch_amp"] * math.sin(a)
        ry = np.array([[math.cos(yaw), 0, math.sin(yaw)], [0, 1, 0],
                       [-math.sin(yaw), 0, math.cos(yaw)]])
        rx = np.array([[1, 0, 0], [0, math.cos(pitch), -math.sin(pitch)],
                       [0, math.sin(pitch), math.cos(pitch)]])
        m = np.eye(4)
        m[:3, :3] = ry @ rx
        m[:3, 3] = eye
        out.append(m.astype(np.float32))
    return out


def _hash01(q: torch.Tensor) -> torch.Tensor:
    """A value in [0, 1] from integer coordinates ``q [..., 3]``, the same
    on every device."""
    q = q.to(torch.int64)
    h = q[..., 0] * 73856093 ^ q[..., 1] * 19349663 ^ q[..., 2] * 83492791
    return torch.remainder(h, 1021).to(torch.float32) / 1020.0


def render(cam, c2w: torch.Tensor, box: torch.Tensor, obstacles: torch.Tensor,
           checker: float, shade: float):
    """Colour ``[B, H, W, 3]`` and depth ``[B, H, W]`` seen from ``c2w [B, 4,
    4]`` (a pinhole camera looking along -z) inside the room ``box [3, 2]``
    with the boxes ``obstacles [K, 3, 2]``."""
    dev = c2w.device
    j, i = torch.meshgrid(torch.arange(cam.H, dtype=torch.float32, device=dev),
                          torch.arange(cam.W, dtype=torch.float32, device=dev), indexing="ij")
    dirs = torch.stack([(i - cam.cx) / cam.fx, -(j - cam.cy) / cam.fy, -torch.ones_like(i)], -1)
    d = torch.einsum("hwk,bjk->bhwj", dirs, c2w[:, :3, :3])
    o = c2w[:, None, None, :3, 3]
    inf = float("inf")
    # The room from inside: the nearest wall ahead.
    t = (box.T[None, None, None] - o[..., None, :]) / d[..., None, :]  # [B, H, W, 2, 3]
    t = torch.where(torch.isfinite(t) & (t > 1e-9), t, torch.full_like(t, inf))
    t_hit, face = torch.min(t.reshape(*t.shape[:3], 6), dim=-1)
    axis = face % 3
    color_id = face
    # The boxes from outside: each one's entry, where the ray enters it.
    for k in range(obstacles.shape[0]):
        t1 = (obstacles[k, :, 0] - o) / d
        t2 = (obstacles[k, :, 1] - o) / d
        near, near_axis = torch.max(torch.minimum(t1, t2), dim=-1)
        far = torch.min(torch.maximum(t1, t2), dim=-1).values
        hit = (far >= near) & (near > 1e-6) & (near < t_hit)
        t_hit = torch.where(hit, near, t_hit)
        axis = torch.where(hit, near_axis, axis)
        color_id = torch.where(hit, torch.full_like(color_id, 6 + k), color_id)
    pts = o + d * t_hit[..., None]
    cell = torch.floor(pts / checker)
    cell = torch.where(torch.arange(3, device=dev) == axis[..., None], torch.zeros_like(cell),
                       cell)
    s = shade + (1.0 - shade) * _hash01(cell + 1000.0 * color_id[..., None])
    palette = torch.as_tensor(np.concatenate([WALL_COLORS, BOX_COLORS]), device=dev)
    color = palette[color_id % len(palette)] * s[..., None]
    return color, t_hit


def stage(cam, bound, traffic: dict, device, batch: int = 8) -> Tuple[list, list, list]:
    """One period of the stream on ``device``: ``(colors, depths, poses)``,
    the first two lists of per-frame tensors."""
    box = room(bound, traffic["shrink"])
    ps = poses(traffic, box)
    box_t = torch.as_tensor(box, dtype=torch.float32, device=device)
    obs = torch.as_tensor(furniture(box, traffic.get("boxes", [])), dtype=torch.float32,
                          device=device)
    colors, depths = [], []
    for s in range(0, len(ps), batch):
        c2w = torch.as_tensor(np.stack(ps[s:s + batch]), device=device)
        c, d = render(cam, c2w, box_t, obs, traffic["checker"], traffic.get("shade", 0.75))
        colors += list(c.unbind(0))
        depths += list(d.unbind(0))
    return colors, depths, ps
