"""Frame visualizer: periodic rendered-vs-observed image panels.

The JAX package's ``utils/visualizer.py`` on the port: a side-by-side panel
(gt color | rendered color | gt depth | rendered depth | residual) written as
PNG by ``io/png.py`` in RGB order (the JAX package hands ``cv2`` BGR, so the
files hold the same pixels). The render runs where the map lives; the
outputs and the frame come back to the host here, once per panel.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..io.png import write_png
from ..render.renderer import render_image


def _colorize_depth(d, dmax=None):
    d = np.asarray(d)
    dmax = dmax or max(float(d.max()), 1e-6)
    x = np.clip(d / dmax, 0, 1)
    # simple perceptual ramp (dark blue -> yellow)
    rgb = np.stack([x, x**1.5, 1.0 - x], axis=-1)
    return (rgb * 255).astype(np.uint8)


def make_panel(gt_color, gt_depth, rgb, depth) -> np.ndarray:
    """uint8 ``[H, 5W, 3]`` RGB panel from host float32 arrays: the frame's
    color and depth and the rendered ones."""
    rc = np.clip(np.asarray(rgb), 0, 1)
    rd = np.asarray(depth)
    gc = np.asarray(gt_color)
    gd = np.asarray(gt_depth)
    dmax = max(float(gd.max()), 1e-6)
    return np.concatenate(
        [
            (gc * 255).astype(np.uint8),
            (rc * 255).astype(np.uint8),
            _colorize_depth(gd, dmax),
            _colorize_depth(rd, dmax),
            _colorize_depth(np.abs(gd - rd), dmax * 0.2),
        ],
        axis=1,
    )


def save_frame_vis(
    out_dir: str,
    frame_idx: int,
    params,
    grids,
    bounds,
    scene_bound,
    intr,
    c2w,
    gt_color,
    gt_depth,
    rcfg,
):
    """Render the color stage at ``c2w`` guided by ``gt_depth`` and write
    ``out_dir/frame_<idx>.png``; returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    dev = scene_bound.device
    gt_color = torch.as_tensor(gt_color, dtype=torch.float32, device=dev)
    gt_depth = torch.as_tensor(gt_depth, dtype=torch.float32, device=dev)
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
    out = render_image(params, grids, bounds, scene_bound, intr, c2w, gt_depth, "color", rcfg)
    panel = make_panel(gt_color.cpu().numpy(), gt_depth.cpu().numpy(),
                       out.rgb.cpu().numpy(), out.depth.cpu().numpy())
    path = os.path.join(out_dir, f"frame_{frame_idx:06d}.png")
    write_png(path, panel)
    return path
