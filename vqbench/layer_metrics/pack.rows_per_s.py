"""pack.rows_per_s: corpus rows over the synchronised seconds of the
build's packed layout (the benchmark's span around the quantizer's
``prepare_scan``: norm order, word planes, factors, tile stats)."""


def read(ctx):
    s = ctx.spans.get("pack")
    if not s:
        return None
    return ctx.rows / s
