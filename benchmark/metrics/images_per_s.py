"""images_per_s: images of whole calls completed, over the time from the
window's start to the last completion."""
from benchmark.harness.stats import rate


def read(ctx, suffix):
    if not ctx.images or ctx.t_last <= ctx.t_start:
        return None
    return rate(ctx.images, ctx.t_last - ctx.t_start)
