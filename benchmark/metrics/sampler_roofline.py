"""The trilinear sampler's share of its roofline over the traced cycle, in
percent: the least time of the cycle's sampler work (``costs.sampler_bytes``
over the card's memory bandwidth) divided by the device time of the
sampler's kernels in the trace, K1-K5 and the fixed-point sums, by their
names in ``niceslam_tpu_torch/csrc``. Nothing for a family whose map has no
trilinear sampler (``sampler_bytes`` gives ``None``)."""
import re

KERNELS = re.compile(
    r"\b(trilerp_fwd_kernel|trilerp_bwd_points_kernel|trilerp_bwd_fill_kernel"
    r"|corner_table_kernel|gather_rows_kernel|scatter_corners_count_kernel"
    r"|scatter_corners_fill_kernel|scan_kernel|row_sum_kernel)\b")


def read(ctx):
    if ctx.trace is None or ctx.device.type != "cuda":
        return None
    t = sum(s for name, s in ctx.trace["kernels"].items() if KERNELS.search(name))
    if t <= 0:
        return None
    least = ctx.costs.sampler_bytes(ctx.config, ctx.cycle.solves, ctx.cycle.rows,
                                    ctx.grid_bytes)
    if least is None:
        return None
    _, hbm = ctx.costs.peaks_for(ctx.device_name)
    least /= hbm
    ctx.log(f"sampler: {len([n for n in ctx.trace['kernels'] if KERNELS.search(n)])} "
            f"kernel names, {t:.6f} s on the card, least time {least:.6f} s")
    return 100.0 * least / t
