"""rabitq_dense.roofline: the flat packed scan's least time over Extended
RaBitQ's words (``costs/packed_dense.py``: every row's B·D code bits and
its α and c2 read once, or 2 bf16 operations per dimension of every
(query, row) pair) over all the device time the traced batches took, %:
the dense kernel's shared-table dequant at work."""

from vqbench.costs import packed_dense


def read(ctx):
    work = [w for w in ctx.work if w["family"] == "packed_dense"]
    if not work or len(work) != ctx.trace["batches"] or ctx.trace["busy_s"] <= 0:
        return None
    return 100.0 * sum(packed_dense.bound_s(**w) for w in work) / ctx.trace["busy_s"]
