"""Co-Fusion sequence reader (colour PNG + EXR depth, ``gt-cam-0.txt``).

A copy of the JAX package's reader without OpenCV on its main path: colour
PNGs decode through ``io/png.py`` and EXR depth through the repository's
native decoder (``io/native_loader.py``). OpenCV reads only an EXR whose
compression the native decoder refuses, where it is installed. The
trajectory ``trajectories/gt-cam-0.txt`` holds ``id tx ty tz qx qy qz qw``
per line, OpenCV-style c2w, converted to OpenGL.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from .. import native_loader, png
from .base import Frame, crop_frame, opencv_to_opengl, register


def _imread_exr(path: str) -> np.ndarray:
    try:
        return native_loader.read_exr(path)
    except IOError as native_err:
        try:
            os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
            import cv2
        except ImportError:
            raise IOError(
                f"{path}: the native EXR decoder refused it ({native_err}); this EXR "
                "compression needs OpenCV (cv2), which is not installed"
            ) from native_err
    img = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    if img is None:
        raise IOError(f"failed to read EXR {path}")
    if img.ndim == 3:
        img = img[..., 0]
    return img.astype(np.float32)


def _imread_color(path: str) -> np.ndarray:
    return (png.read_png_rgb(path) / 255.0).astype(np.float32)


def _load_cofusion_trajectory(path: str) -> dict[int, np.ndarray]:
    """Co-Fusion gt format: ``id tx ty tz qx qy qz qw`` per line."""
    from scipy.spatial.transform import Rotation

    poses = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) != 8:
                continue
            fid = int(float(parts[0]))
            tx, ty, tz, qx, qy, qz, qw = map(float, parts[1:])
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :3] = Rotation.from_quat([qx, qy, qz, qw]).as_matrix()
            c2w[:3, 3] = [tx, ty, tz]
            poses[fid] = opencv_to_opengl(c2w)
    return poses


@register("cofusion")
class CoFusionReader:
    def __init__(self, cfg):
        self.root = cfg.data_input_folder
        self.crop = cfg.cam.crop_edge
        self.scale = cfg.cam.png_depth_scale
        self.color_paths = sorted(glob.glob(os.path.join(self.root, "colour", "*.png")))
        self.depth_paths = sorted(glob.glob(os.path.join(self.root, "depth_noise", "*.exr")))
        if not self.depth_paths:
            self.depth_paths = sorted(glob.glob(os.path.join(self.root, "depth", "*.exr")))
        n = min(len(self.color_paths), len(self.depth_paths))
        self.color_paths, self.depth_paths = self.color_paths[:n], self.depth_paths[:n]
        traj = os.path.join(self.root, "trajectories", "gt-cam-0.txt")
        self.poses = _load_cofusion_trajectory(traj) if os.path.exists(traj) else {}

    def __len__(self):
        return len(self.color_paths)

    def __getitem__(self, idx: int) -> Frame:
        color = _imread_color(self.color_paths[idx])
        depth = _imread_exr(self.depth_paths[idx])
        if self.scale not in (0.0, 1.0):
            depth = depth / self.scale
        color, depth = crop_frame(color, depth, self.crop)
        return Frame(idx=idx, color=color, depth=depth, gt_c2w=self.poses.get(idx))
