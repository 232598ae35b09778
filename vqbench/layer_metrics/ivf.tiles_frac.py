"""ivf.tiles_frac: tiles the IVF routing masked in (the index's
``last_tiles_scanned``) over the index's tiles, the mean over batches."""


def read(ctx):
    seen = [c for c in ctx.counters if "tiles" in c]
    if not seen:
        return None
    return sum(c["tiles"] / c["tiles_total"] for c in seen) / len(seen)
