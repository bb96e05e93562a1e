"""modconv_roofline.<cells>: the least time of the masked convs' work,
as a share of the device time of the ``masked_conv`` span, in %. The work
is the configuration's 13 layer shapes at the mix's batch, once per
synthesis pass; each layer's least time is the larger of its FLOPs over
the dense TF32 peak and its bytes over HBM bandwidth, counted from what the
layer computes (``stats.masked_conv_cost``: an up layer is one transposed
conv with one weight), so the share reads the same work whatever kernel
implements it."""
from benchmark.harness.stats import least_time_s, roofline_pct

LAYERS = ("masked_conv", "synthesis")


def read(ctx, suffix):
    r = ctx.reduced
    mc = ctx.config.get("masked_conv")
    passes = r.span_calls.get("synthesis", 0) if r else 0
    device_s = r.span_device_s.get("masked_conv", 0.0) if r else 0.0
    if mc is None or not passes or device_s <= 0:
        return None
    least = passes * least_time_s(mc["launches"], ctx.traffic["batch"],
                                  itemsize=mc["itemsize"], regions=mc["regions"])
    return roofline_pct(least, device_s)
