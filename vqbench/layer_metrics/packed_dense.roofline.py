"""packed_dense.roofline: the flat packed scan's least time
(``costs/packed_dense.py``, every row counted, whatever the prune skips)
over all the device time the traced batches took, %."""

from vqbench.costs import packed_dense


def read(ctx):
    work = [w for w in ctx.work if w["family"] == "packed_dense"]
    if not work or len(work) != ctx.trace["batches"] or ctx.trace["busy_s"] <= 0:
        return None
    return 100.0 * sum(packed_dense.bound_s(**w) for w in work) / ctx.trace["busy_s"]
