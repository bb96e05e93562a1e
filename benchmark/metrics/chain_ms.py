"""chain_ms.<cells>: device time of the kernels launched inside the
``chain`` span, per call, over the traced stretch, in ms."""
from benchmark.metrics._span_ms import device_ms_per_call

LAYERS = ("chain",)


def read(ctx, suffix):
    return device_ms_per_call(ctx, "chain")
