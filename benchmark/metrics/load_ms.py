"""load_ms.<cells>: host time of ``FaceSwapper._load`` (PIL decode and
resize of both images), summed per request, mean over the traced stretch,
in ms."""

LAYERS = ("load",)


def read(ctx, suffix):
    times = ctx.host.get("request.load")
    if not times or not ctx.calls:
        return None
    return 1e3 * sum(times) / ctx.calls
