"""idle_share.<cells>: 1 - (union of device activity) / (wall time) over
the traced stretch, in %."""


def read(ctx, suffix):
    r = ctx.reduced
    if r is None or r.window_s <= 0 or r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
