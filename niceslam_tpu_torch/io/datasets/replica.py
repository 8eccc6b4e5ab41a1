"""Replica sequence reader (results/frameNNNNNN.jpg + depthNNNNNN.png, traj.txt).

A copy of the JAX package's reader. Depth PNGs decode through ``io/png.py``;
the colour frames are JPEG, which only OpenCV decodes here, so ``cv2`` is
imported when a frame is read and a clear ``ImportError`` says so where it
is missing. ``traj.txt``: 16 floats per line, row-major OpenCV c2w,
converted to OpenGL.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from .. import png
from .base import Frame, crop_frame, opencv_to_opengl, register


def import_cv2(layout: str):
    """``cv2``, or an ``ImportError`` saying that this layout's JPEG colour
    frames need it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"the {layout} layout stores its colour frames as JPEG, which needs OpenCV "
            "(cv2) and it is not installed; the Co-Fusion, TUM RGB-D and synthetic "
            "layouts read without it"
        ) from e
    return cv2


@register("replica")
class ReplicaReader:
    def __init__(self, cfg):
        self.root = cfg.data_input_folder
        self.crop = cfg.cam.crop_edge
        self.scale = cfg.cam.png_depth_scale
        self.color_paths = sorted(glob.glob(os.path.join(self.root, "results", "frame*.jpg")))
        self.depth_paths = sorted(glob.glob(os.path.join(self.root, "results", "depth*.png")))
        traj = os.path.join(self.root, "traj.txt")
        self.poses = []
        if os.path.exists(traj):
            with open(traj) as f:
                for line in f:
                    m = np.fromstring(line, sep=" ", dtype=np.float64)
                    if m.size == 16:
                        self.poses.append(opencv_to_opengl(m.reshape(4, 4).astype(np.float32)))

    def __len__(self):
        return len(self.color_paths)

    def __getitem__(self, idx: int) -> Frame:
        cv2 = import_cv2("replica")
        color = cv2.imread(self.color_paths[idx], cv2.IMREAD_COLOR)
        color = (color[..., ::-1] / 255.0).astype(np.float32)
        depth = png.read_png_grey(self.depth_paths[idx]).astype(np.float32) / self.scale
        color, depth = crop_frame(color, depth, self.crop)
        pose = self.poses[idx] if idx < len(self.poses) else None
        return Frame(idx=idx, color=color, depth=depth, gt_c2w=pose)
