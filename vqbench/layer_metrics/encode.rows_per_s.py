"""encode.rows_per_s: corpus rows over the synchronised seconds of the
build's encode calls (the benchmark's span around the quantizer's
``compress`` or ``encode_fn``)."""


def read(ctx):
    s = ctx.spans.get("encode")
    if not s:
        return None
    return ctx.rows / s
