"""Analytic roofline model of the system's hot ops.

Per-op FLOP and byte counts derived from shapes (the JAX package's
``utils/roofline.py`` cost functions, the same formulas), combined with a
device's peak compute and memory rate into a speed-of-light time:

    t_sol = max(bytes / BW_peak, flops / FLOP_peak)

``achieved = t_sol / t_measured`` is the fraction of speed-of-light. The hot
ops are bandwidth-bound (the tiny-MLP matmuls are 32 wide; the gather and
scatter traffic of trilinear interpolation dominates), so the bytes term
sets the bound.

Peaks are keyed on the device's name (``torch.cuda.get_device_name``); a
device without a row raises rather than borrowing another device's figures.
"""
from __future__ import annotations

from typing import Dict, NamedTuple


class ChipPeaks(NamedTuple):
    name: str
    flops_bf16: float  # FLOP/s
    flops_f32: float   # FLOP/s
    hbm_gbps: float    # bytes/s / 1e9


# Lowercased substrings of the device name -> peaks.
_PEAKS = {
    # NVIDIA's data sheet, H100 SXM at its 700 W limit, dense rates: HBM3
    # 3.35 TB/s, fp32 outside the tensor cores 67 TFLOP/s, bf16 989 TFLOP/s.
    "h100 80gb hbm3": ChipPeaks("h100-sxm", 989e12, 67e12, 3350.0),
    "cpu": ChipPeaks("cpu", 1e12, 5e11, 50.0),  # rough; tests only
}


def device_peaks(name: str) -> ChipPeaks:
    """Peaks of the device called ``name``: ``torch.cuda.get_device_name(dev)``
    or ``"cpu"``. Raises for a device without a row."""
    key = name.lower()
    for k, v in _PEAKS.items():
        if k in key:
            return v
    raise ValueError(f"no roofline peaks for device {name!r}; known: {sorted(_PEAKS)}")


def sol_ms(flops: float, bytes_: float, peaks: ChipPeaks,
           dtype: str = "f32") -> float:
    """Speed-of-light milliseconds for an op of given analytic cost."""
    f_peak = peaks.flops_bf16 if dtype == "bf16" else peaks.flops_f32
    t = max(bytes_ / (peaks.hbm_gbps * 1e9), flops / f_peak)
    return t * 1e3


# ---------------------------------------------------------------- op costs
def trilinear_cost(n_pts: int, c_dim: int, grid_bytes: int,
                   backward: bool = False) -> Dict[str, float]:
    """8 corner-row gathers + lerp per point; VJP adds a scatter-add of the
    same traffic. Traffic model: every corner read misses (worst case), but
    never more than the whole grid + index streams."""
    elem = 4  # f32
    gather = min(8 * n_pts * c_dim * elem, grid_bytes + 8 * n_pts * 4)
    out = n_pts * c_dim * elem
    bytes_ = gather + out
    flops = n_pts * c_dim * 14  # 7 lerps x (mul+add)
    if backward:
        bytes_ *= 2   # re-gather weights + scatter-add corner rows
        flops *= 2
    return {"flops": float(flops), "bytes": float(bytes_)}


def mlp_cost(n_pts: int, hidden: int = 32, emb: int = 93,
             c_in: int = 32, color: bool = False,
             backward: bool = False) -> Dict[str, float]:
    """5-block tiny MLP: emb matmul + 5 hidden matmuls + 5 fc_c adds + out.

    Activation traffic dominates (the parameters stay in cache):
    ~N*(emb + 6*hidden).
    """
    out_dim = 4 if color else 1
    f = 2 * n_pts * (
        3 * emb                      # fourier sin(x@B)
        + emb * hidden               # layer 0
        + 4 * hidden * hidden        # layers 1-4 (pre-skip widths approx)
        + (hidden + emb) * hidden    # skip re-concat layer
        + 5 * c_in * hidden          # per-layer fc_c projections
        + (hidden + emb) * out_dim
    )
    bytes_ = n_pts * (3 + emb + 6 * hidden + c_in + out_dim) * 4
    if backward:
        f *= 3       # fwd + two matmuls per layer in bwd
        bytes_ *= 2
    return {"flops": float(f), "bytes": float(bytes_)}


def compositing_cost(n_rays: int, n_samples: int) -> Dict[str, float]:
    n = n_rays * n_samples
    return {"flops": float(n * 12), "bytes": float(n * 6 * 4)}


# The grid levels each stage of ``models/decoders.nice_forward`` samples:
# the fine and color stages sample the middle feature once for the fine +
# middle residual, so each listed level costs one trilinear and one MLP.
STAGE_LEVELS = {
    "coarse": ("coarse",),
    "middle": ("middle",),
    "fine": ("fine", "middle"),
    "color": ("color", "fine", "middle"),
}


def render_cost(n_rays: int, n_samples: int, c_dim: int,
                grid_bytes: Dict[str, int], stage: str = "color",
                backward: bool = False) -> Dict[str, float]:
    """Aggregate analytic cost of render_rays at a stage (the decoder levels
    it touches, ``STAGE_LEVELS``)."""
    n = n_rays * n_samples
    flops = bytes_ = 0.0
    for lvl in STAGE_LEVELS[stage]:
        t = trilinear_cost(n, c_dim, grid_bytes.get(lvl, 1 << 30), backward)
        flops += t["flops"]
        bytes_ += t["bytes"]
        m = mlp_cost(
            n, c_in=2 * c_dim if lvl == "fine" else c_dim,
            color=lvl == "color", backward=backward,
        )
        flops += m["flops"]
        bytes_ += m["bytes"]
    c = compositing_cost(n_rays, n_samples)
    flops += c["flops"]
    bytes_ += c["bytes"]
    return {"flops": flops, "bytes": bytes_}


def mapping_step_cost(n_pixels: int, n_samples: int, c_dim: int,
                      grid_bytes: Dict[str, int]) -> Dict[str, float]:
    """One joint mapping iteration: fwd + bwd render at the color stage
    (worst case) + Adam over the grids."""
    r = render_cost(n_pixels, n_samples, c_dim, grid_bytes, "color",
                    backward=True)
    adam_bytes = 4 * sum(grid_bytes.values())  # read p,m,v + write (masked)
    return {"flops": r["flops"], "bytes": r["bytes"] + adam_bytes}
