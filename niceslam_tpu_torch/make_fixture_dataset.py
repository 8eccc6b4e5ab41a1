"""Write the synthetic box scene to disk in a real dataset layout.

The port's counterpart of ``scripts/make_fixture_dataset.py``: the same
arguments, the same four layouts, the same file names, trajectory and list
text, and the same pixels and depths, without JAX, so that a machine that
has only the port can write the fixtures it runs on:

    python -m niceslam_tpu_torch.make_fixture_dataset --layout cofusion \\
        --out data/cofusion_synth849 --frames 849 --arc 2.0
    python -m niceslam_tpu_torch configs/cofusion_synth849.yaml \\
        --set data.input_folder=data/cofusion_synth849

Layouts:

- ``cofusion``: ``colour/Color0NNN.png`` + ``depth_noise/Depth0NNN.exr``
  (float32, ZIP) + ``trajectories/gt-cam-0.txt``;
- ``replica``: ``results/frameNNNNNN.jpg`` + ``results/depthNNNNNN.png`` +
  ``traj.txt``;
- ``tumrgbd``: ``rgb/`` + ``depth/`` + ``rgb.txt``, ``depth.txt``,
  ``groundtruth.txt``;
- ``scannet``: ``color/N.jpg`` + ``depth/N.png`` + ``pose/N.txt``.

PNGs are written by ``io/png.py`` (filter 0, ``zlib``), so the bytes differ
from OpenCV's while the decoded arrays are the same. JPEG colour (replica,
scannet) is written by ``cv2`` at quality 97, as the JAX script does: the
same bytes under the same OpenCV. uint16 depth PNGs hold ``depth *
--depth-scale``, clipped to 65535. Poses are OpenCV-style camera-to-world
(the readers convert them back to OpenGL).

Rendering and compressing a 640x480 frame takes ~0.15 s of one core, so a
long fixture is written by spawned processes, one per 32 frames up to one
per core (at most 8); each file is the same whatever their number.
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Optional

import numpy as np

from .core.rays import Intrinsics
from .io import exr_write, png
from .io.datasets.base import opencv_to_opengl
from .io.datasets.synthetic import circular_trajectory, render_box_scene

LAYOUTS = ("cofusion", "replica", "tumrgbd", "scannet")
# The scene box: the Co-Fusion bound shrunk to 0.9 (the JAX script's literal).
BOX = np.asarray([[-4.5, 3.82], [-1.5, 2.02], [-3.0, 2.76]], np.float32) * 0.9


def intrinsics(H: int = 480, W: int = 640, fx: float = 360.0) -> Intrinsics:
    """The fixture's camera: square pixels, principal point at the centre."""
    return Intrinsics(H=H, W=W, fx=fx, fy=fx, cx=W / 2.0, cy=H / 2.0)


def render(intr: Intrinsics, c2w: np.ndarray):
    """One frame of the scene at OpenGL pose ``c2w``: colour as the uint8
    ``[H, W, 3]`` RGB that the files hold, and float32 depth ``[H, W]``."""
    color, depth = render_box_scene(intr, c2w, BOX)
    return (np.clip(color, 0, 1) * 255).astype(np.uint8), depth


def _quat_line(idx, c2w_cv: np.ndarray) -> str:
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(c2w_cv[:3, :3]).as_quat()  # x, y, z, w
    t = c2w_cv[:3, 3]
    return (f"{idx} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
            f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n")


def _stamp(k: int) -> str:
    """The TUM layout's timestamp of frame ``k``."""
    return f"{1000.0 + 0.033 * k:.6f}"


def _jpeg(layout: str, path: str, rgb: np.ndarray) -> None:
    from .io.datasets.replica import import_cv2

    cv2 = import_cv2(layout)
    if not cv2.imwrite(path, rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 97]):
        raise IOError(f"cv2 could not write {path}")


def _depth16(depth: np.ndarray, scale: float) -> np.ndarray:
    return np.clip(depth * scale, 0, 65535).astype(np.uint16)


def _write_frame(layout: str, root: str, k: int, c2w: np.ndarray, intr: Intrinsics,
                 depth_scale: float):
    """Render frame ``k`` and write its image files (not the trajectory);
    returns the colour and depth rendered (:func:`render`)."""
    rgb, depth = render(intr, c2w)
    if layout == "cofusion":
        png.write_png(os.path.join(root, "colour", f"Color0{k:03d}.png"), rgb)
        exr_write.write_exr(os.path.join(root, "depth_noise", f"Depth0{k:03d}.exr"),
                            depth.astype(np.float32))
    elif layout == "replica":
        _jpeg(layout, os.path.join(root, "results", f"frame{k:06d}.jpg"), rgb)
        png.write_png(os.path.join(root, "results", f"depth{k:06d}.png"),
                      _depth16(depth, depth_scale))
    elif layout == "tumrgbd":
        t = _stamp(k)
        png.write_png(os.path.join(root, "rgb", f"{t}.png"), rgb)
        png.write_png(os.path.join(root, "depth", f"{t}.png"), _depth16(depth, depth_scale))
    else:  # scannet
        _jpeg(layout, os.path.join(root, "color", f"{k}.jpg"), rgb)
        png.write_png(os.path.join(root, "depth", f"{k}.png"), _depth16(depth, depth_scale))
        np.savetxt(os.path.join(root, "pose", f"{k}.txt"), opencv_to_opengl(c2w))
    return rgb, depth


def _write_frames(job):
    """Write a run of frames; with ``keep``, returns what was rendered."""
    layout, root, ks, poses, intr, depth_scale, keep = job
    out = [_write_frame(layout, root, k, c2w, intr, depth_scale) for k, c2w in zip(ks, poses)]
    return out if keep else None


def _write_text(layout: str, root: str, poses) -> None:
    """The trajectory and list files, in frame order."""
    def put(name, lines):
        with open(os.path.join(root, name), "w") as f:
            f.writelines(lines)

    cv = [opencv_to_opengl(c2w) for c2w in poses]
    if layout == "cofusion":
        put(os.path.join("trajectories", "gt-cam-0.txt"),
            [_quat_line(k, p) for k, p in enumerate(cv)])
    elif layout == "replica":
        put("traj.txt", [" ".join(f"{v:.9f}" for v in p.reshape(-1)) + "\n" for p in cv])
    elif layout == "tumrgbd":
        head = ["# synthetic fixture\n"]
        ts = [_stamp(k) for k in range(len(cv))]
        put("rgb.txt", head + [f"{t} rgb/{t}.png\n" for t in ts])
        put("depth.txt", head + [f"{t} depth/{t}.png\n" for t in ts])
        put("groundtruth.txt", head + [_quat_line(t, p) for t, p in zip(ts, cv)])


_DIRS = {"cofusion": ("colour", "depth_noise", "trajectories"), "replica": ("results",),
         "tumrgbd": ("rgb", "depth"), "scannet": ("color", "depth", "pose")}


def default_workers(frames: int) -> int:
    """One process per 32 frames, up to one per core (at most 8)."""
    return max(1, min(8, os.cpu_count() or 1, frames // 32))


def write_layout(layout: str, out: str, frames: int = 60, H: int = 480, W: int = 640,
                 fx: float = 360.0, depth_scale: float = 1000.0, arc: float = 0.3,
                 workers: Optional[int] = None, keep: bool = False):
    """Write ``frames`` frames of the scene in ``layout`` under ``out`` along
    ``circular_trajectory(frames, arc_fraction=arc)``; returns those OpenGL
    poses (float32 ``[4, 4]`` each), and with ``keep`` also the colours
    (uint8 RGB) and depths rendered: ``(poses, colours, depths)``.
    Contiguous runs of frames are rendered and written by ``workers``
    spawned processes (:func:`default_workers` if None; with one, in this
    process)."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; the layouts are {LAYOUTS}")
    intr = intrinsics(H, W, fx)
    poses = circular_trajectory(frames, arc_fraction=arc)
    for d in ("",) + _DIRS[layout]:
        os.makedirs(os.path.join(out, d), exist_ok=True)
    _write_text(layout, out, poses)
    if workers is None:
        workers = default_workers(frames)
    runs = [r for r in np.array_split(np.arange(frames), max(1, min(workers, frames))) if len(r)]
    jobs = [(layout, out, [int(k) for k in r], [poses[k] for k in r], intr, depth_scale, keep)
            for r in runs]
    if len(jobs) <= 1:
        done = [_write_frames(job) for job in jobs]
    else:
        # A worker that dies raises here (BrokenProcessPool), where a
        # multiprocessing pool would start another and wait forever.
        with ProcessPoolExecutor(len(jobs), mp_context=mp.get_context("spawn")) as pool:
            done = [f.result() for f in [pool.submit(_write_frames, job) for job in jobs]]
    if not keep:
        return poses
    rendered = [f for run in done for f in run]
    return poses, [f[0] for f in rendered], [f[1] for f in rendered]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layout", required=True, choices=LAYOUTS)
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--H", type=int, default=480)
    ap.add_argument("--W", type=int, default=640)
    ap.add_argument("--fx", type=float, default=360.0)
    ap.add_argument("--depth-scale", type=float, default=1000.0,
                    help="uint16 depth scale for png layouts")
    ap.add_argument("--arc", type=float, default=0.3,
                    help="trajectory arc_fraction: total orbit fraction "
                    "(>1 = multiple loops)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    write_layout(args.layout, args.out, args.frames, args.H, args.W, args.fx,
                 args.depth_scale, args.arc)
    print(f"{args.layout} fixture: {args.frames} frames -> {args.out}")
    print(f"written in {time.perf_counter() - t0:.2f} s by "
          f"{default_workers(args.frames)} process(es)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
