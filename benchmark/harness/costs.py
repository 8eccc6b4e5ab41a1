"""The benchmark's yardstick of work: analytic operations and bytes from
shapes, and the card's peaks.

A frozen copy of the port's ``utils/roofline.py`` cost formulas (so that a
change to the program cannot move the yardstick), with what each formula
approximates written beside it, and the least bytes of the sampler's work.

Approximations of the copied formulas, kept as they are:

- ``trilinear_cost`` assumes every corner read misses the cache (eight
  corner rows per point, capped at the whole grid plus the index stream);
- ``mlp_cost`` approximates the widths of the layers after the skip and
  counts a backward pass as twice the forward's operations;
- ``render_cost`` costs the Gauss-Newton tracker's forward-mode Jacobian
  (``jacfwd``, six tangents) as one reverse pass, as the port's bench does;
- ``mapping_step_cost`` adds Adam as four reads or writes of every grid
  and nothing for the decoders.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

# NVIDIA's data sheet, H100 SXM at its 700 W limit, dense rates.
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_S = 3.35e12
F32 = 4

# The grid levels each stage reads, with the width multiplier of the
# decoder's feature input (the fine decoder reads its own and the middle
# feature).
STAGE_LEVELS = {
    "coarse": ("coarse",),
    "middle": ("middle",),
    "fine": ("fine", "middle"),
    "color": ("color", "fine", "middle"),
}


def peaks_for(name: str) -> Tuple[float, float]:
    """``(fp32 FLOP/s, HBM bytes/s)`` of the card called ``name``; raises
    for a card without a row."""
    if "h100" in name.lower():
        return H100_FP32_FLOPS, H100_HBM_BYTES_S
    raise ValueError(f"no peaks for device {name!r}")


def trilinear_cost(n_pts: int, c_dim: int, grid_bytes: int, backward: bool = False):
    gather = min(8 * n_pts * c_dim * F32, grid_bytes + 8 * n_pts * 4)
    out = n_pts * c_dim * F32
    bytes_ = gather + out
    flops = n_pts * c_dim * 14
    if backward:
        bytes_ *= 2
        flops *= 2
    return float(flops), float(bytes_)


def mlp_cost(n_pts: int, hidden: int = 32, emb: int = 93, c_in: int = 32,
             color: bool = False, backward: bool = False):
    out_dim = 4 if color else 1
    f = 2 * n_pts * (3 * emb + emb * hidden + 4 * hidden * hidden + (hidden + emb) * hidden
                     + 5 * c_in * hidden + (hidden + emb) * out_dim)
    b = n_pts * (3 + emb + 6 * hidden + c_in + out_dim) * F32
    if backward:
        f *= 3
        b *= 2
    return float(f), float(b)


def render_cost(n_rays: int, n_samples: int, c_dim: int, grid_bytes: Dict[str, int],
                stage: str, backward: bool = True):
    n = n_rays * n_samples
    flops = bytes_ = 0.0
    for lvl in STAGE_LEVELS[stage]:
        f, b = trilinear_cost(n, c_dim, grid_bytes[lvl], backward)
        flops, bytes_ = flops + f, bytes_ + b
        f, b = mlp_cost(n, c_in=2 * c_dim if lvl == "fine" else c_dim,
                        color=lvl == "color", backward=backward)
        flops, bytes_ = flops + f, bytes_ + b
    flops += n * 12
    bytes_ += n * 6 * F32
    return flops, bytes_


def mapping_step_cost(n_rays: int, n_samples: int, c_dim: int,
                      grid_bytes: Dict[str, int], stage: str):
    f, b = render_cost(n_rays, n_samples, c_dim, grid_bytes, stage, backward=True)
    return f, b + 4 * sum(grid_bytes.values())


def window_work(cfg: dict, solves: int, rows: Iterable[str], grid_bytes: Dict[str, int]):
    """``(flops, bytes)`` of ``solves`` pose solves of ``tracking.iters``
    iterations each and of the mapping iterations whose stages are
    ``rows``."""
    r, c_dim = cfg["rendering"], cfg["model"]["c_dim"]
    samples = r["N_samples"] + r["N_surface"]
    t = cfg["tracking"]
    f, b = render_cost(t["pixels"], samples, c_dim, grid_bytes, "color")
    flops, nbytes = solves * t["iters"] * f, solves * t["iters"] * b
    for stage in rows:
        f, b = mapping_step_cost(cfg["mapping"]["pixels"], samples, c_dim, grid_bytes, stage)
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes


def sampler_bytes(cfg: dict, solves: int, rows: Iterable[Tuple[str, bool]],
                  grid_bytes: Dict[str, int]) -> float:
    """Least bytes of the trilinear sampler's work: each input read once and
    each output written once, whatever implements it.

    - a Gauss-Newton iteration samples every level of the colour stage at
      ``tracking.pixels x samples`` points: it reads the points' coordinates
      (12 bytes) and writes the features (4C) and their derivative in the
      point (12C);
    - a mapping iteration samples the levels of its stage at
      ``mapping.pixels x samples`` points: the forward reads coordinates and
      writes features; the backward reads the features' cotangent (4C) and
      the coordinates and writes each level's whole grid gradient, and the
      points' gradient (12 bytes) where bundle adjustment moves cameras.

    Grid reads are left out: the rows a batch touches depend on the data, so
    the count stays a lower bound. ``rows`` holds ``(stage, ba)`` of each
    mapping iteration."""
    r, c = cfg["rendering"], cfg["model"]["c_dim"]
    samples = r["N_samples"] + r["N_surface"]
    n = cfg["tracking"]["pixels"] * samples
    total = solves * cfg["tracking"]["iters"] * len(STAGE_LEVELS["color"]) * n * (
        12 + 4 * c + 12 * c)
    n = cfg["mapping"]["pixels"] * samples
    for stage, ba in rows:
        for lvl in STAGE_LEVELS[stage]:
            total += n * (12 + 4 * c)
            total += n * (4 * c + 12) + grid_bytes[lvl] + (n * 12 if ba else 0)
    return float(total)


def grid_bytes(cfg: dict) -> Dict[str, int]:
    """Bytes of each level's float32 grid over the configuration's bound,
    snapped as NICE-SLAM snaps it."""
    import numpy as np

    gl, enlarge = cfg["grid_len"], cfg["model"]["coarse_bound_enlarge"]
    b = np.asarray(cfg["bound"], np.float32).copy()
    ext = b[:, 1] - b[:, 0]
    b[:, 1] = (np.floor(ext / gl["bound_divisable"]).astype(np.int64) + 1) \
        * gl["bound_divisable"] + b[:, 0]
    out = {}
    for lvl in ("coarse", "middle", "fine", "color"):
        e = (b[:, 1] - b[:, 0]) * (enlarge if lvl == "coarse" else 1.0)
        n = [max(int(x / gl[lvl]), 2) for x in e]
        out[lvl] = n[0] * n[1] * n[2] * cfg["model"]["c_dim"] * F32
    return out
