"""swap_e2e_ms.<cells>: device time of the kernels launched inside the
``swap_e2e`` span, per call, over the traced stretch, in ms."""
from benchmark.metrics._span_ms import device_ms_per_call

LAYERS = ("fused_swap",)


def read(ctx, suffix):
    return device_ms_per_call(ctx, "swap_e2e")
