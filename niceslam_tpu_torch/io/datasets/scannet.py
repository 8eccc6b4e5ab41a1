"""ScanNet scene reader (color/*.jpg, depth/*.png, pose/*.txt).

A copy of the JAX package's reader. Depth PNGs decode through ``io/png.py``;
the JPEG colour frames need OpenCV, imported when a frame is read (a clear
``ImportError`` where it is missing), which also resizes colour to the
depth resolution where the two differ (ScanNet colour is 1296x968, depth
640x480). ``apartment`` is the same layout.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from .. import png
from .base import Frame, crop_frame, opencv_to_opengl, register
from .replica import import_cv2


def _num_key(p):
    return int(os.path.splitext(os.path.basename(p))[0])


@register("scannet")
class ScanNetReader:
    layout = "scannet"

    def __init__(self, cfg):
        self.root = cfg.data_input_folder
        self.crop = cfg.cam.crop_edge
        self.scale = cfg.cam.png_depth_scale
        self.H, self.W = cfg.cam.H, cfg.cam.W
        self.color_paths = sorted(
            glob.glob(os.path.join(self.root, "color", "*.jpg")), key=_num_key)
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.root, "depth", "*.png")), key=_num_key)
        self.pose_paths = sorted(
            glob.glob(os.path.join(self.root, "pose", "*.txt")), key=_num_key)

    def __len__(self):
        return min(len(self.color_paths), len(self.depth_paths))

    def __getitem__(self, idx: int) -> Frame:
        cv2 = import_cv2(self.layout)
        color = cv2.imread(self.color_paths[idx], cv2.IMREAD_COLOR)
        color = (color[..., ::-1] / 255.0).astype(np.float32)
        depth = png.read_png_grey(self.depth_paths[idx]).astype(np.float32) / self.scale
        if color.shape[:2] != depth.shape[:2]:
            color = cv2.resize(color, (depth.shape[1], depth.shape[0]),
                               interpolation=cv2.INTER_LINEAR)
        color, depth = crop_frame(color, depth, self.crop)
        pose = None
        if idx < len(self.pose_paths):
            m = np.loadtxt(self.pose_paths[idx]).astype(np.float32)
            if m.shape == (4, 4) and np.isfinite(m).all():
                pose = opencv_to_opengl(m)
        return Frame(idx=idx, color=color, depth=depth, gt_c2w=pose)


@register("apartment")
class ApartmentReader(ScanNetReader):
    """Apartment multi-room capture; same on-disk layout as ScanNet exports."""

    layout = "apartment"
