"""Share of the traced cycle's wall time in which no kernel, copy or set
ran on the card, in percent."""


def read(ctx):
    t = ctx.trace
    if t is None or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
