"""The whole window's share of the card's float32 peak, in percent: the
analytic operations of every pose solve and mapping iteration the window
ran (``costs.window_work``, the frozen roofline formulas) over the
window's seconds and 67 TFLOP/s. The same work's bytes over the card's
bandwidth are logged beside it."""


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    w = ctx.window
    flops, nbytes = ctx.costs.window_work(ctx.config, w.solves, [s for s, _ in w.rows],
                                          ctx.grid_bytes)
    f_peak, hbm = ctx.costs.peaks_for(ctx.device_name)
    ctx.log(f"step_hbm {100.0 * nbytes / w.seconds / hbm:.6f} % of {hbm / 1e12} TB/s "
            f"({w.solves} solves, {len(w.rows)} mapping iterations)")
    return 100.0 * flops / w.seconds / f_peak
