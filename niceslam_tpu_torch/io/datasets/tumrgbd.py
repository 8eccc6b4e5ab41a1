"""TUM RGB-D reader: timestamp association of rgb/depth/groundtruth lists.

A copy of the JAX package's reader, with its PNGs (colour and 16-bit depth)
decoded by ``io/png.py`` instead of OpenCV. Association: nearest-timestamp
matching within 20 ms (the TUM tooling's ``associate.py``); the ground
truth ``tx ty tz qx qy qz qw`` is matched to each colour timestamp within
20 ms and converted from OpenCV-style c2w to OpenGL.
"""
from __future__ import annotations

import os

import numpy as np

from .. import png
from .base import Frame, crop_frame, opencv_to_opengl, register


def _read_list(path):
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1:]))
    return out


def _associate(a, b, max_dt=0.02):
    """Greedy nearest-timestamp matching (classic TUM associate.py)."""
    pairs = []
    bi = 0
    bt = [t for t, _ in b]
    for ta, va in a:
        while bi + 1 < len(bt) and abs(bt[bi + 1] - ta) <= abs(bt[bi] - ta):
            bi += 1
        if bt and abs(bt[bi] - ta) <= max_dt:
            pairs.append(((ta, va), b[bi]))
    return pairs


@register("tumrgbd")
class TUMReader:
    def __init__(self, cfg):
        from scipy.spatial.transform import Rotation

        self.root = cfg.data_input_folder
        self.crop = cfg.cam.crop_edge
        self.scale = cfg.cam.png_depth_scale
        rgb = _read_list(os.path.join(self.root, "rgb.txt"))
        dep = _read_list(os.path.join(self.root, "depth.txt"))
        gt_path = os.path.join(self.root, "groundtruth.txt")
        gts = _read_list(gt_path) if os.path.exists(gt_path) else []

        self.items = []
        for (t_rgb, v_rgb), (t_dep, v_dep) in _associate(rgb, dep):
            pose = None
            if gts:
                k = int(np.argmin([abs(t - t_rgb) for t, _ in gts]))
                tg, vg = gts[k]
                if abs(tg - t_rgb) <= 0.02:
                    tx, ty, tz, qx, qy, qz, qw = map(float, vg)
                    c2w = np.eye(4, dtype=np.float32)
                    c2w[:3, :3] = Rotation.from_quat([qx, qy, qz, qw]).as_matrix()
                    c2w[:3, 3] = [tx, ty, tz]
                    pose = opencv_to_opengl(c2w)
            self.items.append((v_rgb[0], v_dep[0], pose))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Frame:
        rgb_rel, dep_rel, pose = self.items[idx]
        color = png.read_png_rgb(os.path.join(self.root, rgb_rel))
        color = (color / 255.0).astype(np.float32)
        depth = png.read_png_grey(os.path.join(self.root, dep_rel)).astype(np.float32) / self.scale
        color, depth = crop_frame(color, depth, self.crop)
        return Frame(idx=idx, color=color, depth=depth, gt_c2w=pose)
