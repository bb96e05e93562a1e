"""Shared by the readers of a span's device time per call."""


def device_ms_per_call(ctx, span):
    r = ctx.reduced
    if r is None or not r.span_calls.get(span) or span not in r.span_device_s:
        return None
    return 1e3 * r.span_device_s[span] / r.span_calls[span]
