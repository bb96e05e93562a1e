"""synthesis_ms.<cells>: device time of the kernels launched inside the
``synthesis`` span, per call, over the traced stretch, in ms."""
from benchmark.metrics._span_ms import device_ms_per_call

LAYERS = ("synthesis",)


def read(ctx, suffix):
    return device_ms_per_call(ctx, "synthesis")
