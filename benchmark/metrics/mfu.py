"""mfu.<cells>: the configuration's FLOPs per image (convolutions and
matrix products of one pass of the plain reference, each counted once)
times the images the traced stretch completed, over its wall time times
the dense TF32 peak, in %."""
from benchmark.harness.stats import mfu_pct


def read(ctx, suffix):
    r = ctx.reduced
    if r is None or r.busy_s <= 0:
        return None
    return mfu_pct(ctx.config["flops_per_image"], ctx.images, r.window_s)
