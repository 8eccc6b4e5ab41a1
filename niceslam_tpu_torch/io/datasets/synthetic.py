"""Synthetic analytic RGB-D scene: a textured box room with a known trajectory.

A numpy copy of the JAX package's synthetic dataset: exact depth, color and
poses rendered analytically from the same camera model the SLAM stack uses,
so ATE assertions are meaningful and no files are needed.
"""
from __future__ import annotations

import numpy as np

from ...core.rays import Intrinsics
from .base import Frame

WALL_COLORS = {
    # axis, sign -> base RGB
    (0, +1): (0.9, 0.3, 0.3),
    (0, -1): (0.3, 0.9, 0.3),
    (1, +1): (0.3, 0.3, 0.9),
    (1, -1): (0.9, 0.9, 0.3),
    (2, +1): (0.9, 0.3, 0.9),
    (2, -1): (0.3, 0.9, 0.9),
}


def render_box_scene(
    intr: Intrinsics, c2w: np.ndarray, box: np.ndarray, checker: float = 0.5
):
    """Analytic RGB-D of the box interior from pose ``c2w``.

    ``box`` is [3, 2] (min/max per axis). Returns (color [H,W,3], depth
    [H,W] z-depth), float32.
    """
    box = np.asarray(box, np.float32)
    j, i = np.meshgrid(
        np.arange(intr.H, dtype=np.float32),
        np.arange(intr.W, dtype=np.float32),
        indexing="ij",
    )
    dirs = np.stack(
        [
            (i - intr.cx) / intr.fx,
            -(j - intr.cy) / intr.fy,
            -np.ones_like(i),
        ],
        axis=-1,
    )
    R, t = c2w[:3, :3].astype(np.float32), c2w[:3, 3].astype(np.float32)
    d = dirs @ R.T  # [H, W, 3]
    o = t[None, None, :]

    with np.errstate(divide="ignore", invalid="ignore"):
        t_faces = (box.T[None, None] - o[..., None, :]) / d[..., None, :]
    # Exit distance: smallest positive t among the faces.
    t_faces = np.where(t_faces <= 1e-9, np.float32(np.inf), t_faces)
    t_faces = t_faces.reshape(intr.H, intr.W, 6)  # [min xyz, max xyz]
    hit_flat = np.argmin(t_faces, axis=-1)
    t_exit = np.take_along_axis(t_faces, hit_flat[..., None], axis=-1)[..., 0]
    face_axis = hit_flat % 3

    pts = o + d * t_exit[..., None]
    # Checkerboard from the two in-plane coordinates.
    fl = np.floor(pts / checker)
    own = np.take_along_axis(fl, face_axis[..., None], axis=-1)[..., 0]
    chk = (fl.sum(axis=-1) - own) % 2
    shade = (0.75 + 0.25 * chk).astype(np.float32)
    base_table = np.array(
        [WALL_COLORS[(a, -1)] for a in range(3)]
        + [WALL_COLORS[(a, +1)] for a in range(3)],
        np.float32,
    )  # index = hit_flat: rows 0-2 are the min faces, 3-5 the max faces
    color = base_table[hit_flat] * shade[..., None]
    depth = t_exit  # dirs have unit |z| -> t is z-depth
    return color.astype(np.float32), depth.astype(np.float32)


def circular_trajectory(
    n: int,
    radius: float = 0.35,
    height_amp: float = 0.1,
    arc_fraction: float = 0.3,
):
    """Smooth arc inside the box, looking around the room."""
    poses = []
    for k in range(n):
        a = 2 * np.pi * arc_fraction * k / max(n, 1)
        eye = np.array(
            [radius * np.cos(a), height_amp * np.sin(2 * a), radius * np.sin(a)]
        )
        yaw = a * 0.5
        pitch = 0.1 * np.sin(a)
        Ry = np.array(
            [
                [np.cos(yaw), 0, np.sin(yaw)],
                [0, 1, 0],
                [-np.sin(yaw), 0, np.cos(yaw)],
            ]
        )
        Rx = np.array(
            [
                [1, 0, 0],
                [0, np.cos(pitch), -np.sin(pitch)],
                [0, np.sin(pitch), np.cos(pitch)],
            ]
        )
        c2w = np.eye(4)
        c2w[:3, :3] = Ry @ Rx
        c2w[:3, 3] = eye
        poses.append(c2w.astype(np.float32))
    return poses


class SyntheticBoxReader:
    """Frame reader over the analytic box scene (config-driven)."""

    def __init__(
        self,
        cfg,
        n_frames: int = 60,
        depth_noise: float = 0.0,
        trajectory_kwargs: dict | None = None,
    ):
        c = cfg.cam
        self.intr = Intrinsics(
            H=c.H - 2 * c.crop_edge,
            W=c.W - 2 * c.crop_edge,
            fx=c.fx,
            fy=c.fy,
            cx=c.cx - c.crop_edge,
            cy=c.cy - c.crop_edge,
        )
        self.box = np.asarray(cfg.bound, np.float32) * 0.9
        self.poses = circular_trajectory(n_frames, **(trajectory_kwargs or {}))
        self.depth_noise = depth_noise
        self._rng = np.random.default_rng(7)

    def __len__(self):
        return len(self.poses)

    def __getitem__(self, idx: int) -> Frame:
        c2w = self.poses[idx]
        color, depth = render_box_scene(self.intr, c2w, self.box)
        if self.depth_noise > 0:
            depth = depth + self._rng.normal(
                0, self.depth_noise, depth.shape
            ).astype(np.float32)
        return Frame(idx=idx, color=color, depth=depth, gt_c2w=c2w)
