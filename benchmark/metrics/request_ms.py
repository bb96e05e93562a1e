"""request_ms.p<q>: the q-th percentile of the host-clock time of every
call completed in the window, in ms."""
from benchmark.harness.stats import percentile


def read(ctx, suffix):
    if not ctx.latency_s or not suffix.startswith("p"):
        return None
    return percentile([1e3 * t for t in ctx.latency_s], float(suffix[1:]))
