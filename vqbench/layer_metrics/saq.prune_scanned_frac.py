"""saq.prune_scanned_frac: the (query block, tile) pairs the dense packed
scan's variance prune let through (the index's ``last_tiles_scanned``) over
the pairs a scan without it covers (``last_scan_units``: query blocks ×
tiles), the mean over the counted batches; None where the program counts
no such work."""


def read(ctx):
    seen = [c for c in ctx.counters if c.get("units")]
    if not seen:
        return None
    return sum(c["scanned"] / c["units"] for c in seen) / len(seen)
