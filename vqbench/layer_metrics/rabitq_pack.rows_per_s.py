"""rabitq_pack.rows_per_s: corpus rows over the synchronised seconds of the
build's packed layout of Extended RaBitQ codes (the benchmark's span
around the quantizer's ``prepare_scan``: byte rows parsed, words, α, c2
and tile stats written in place)."""


def read(ctx):
    s = ctx.spans.get("pack")
    if not s:
        return None
    return ctx.rows / s
