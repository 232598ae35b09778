"""pq_scan.roofline: the PQ scan's least time (``costs/pq_scan.py``, from
the shapes alone) over all the device time the traced batches took, %."""

from vqbench.costs import pq_scan


def read(ctx):
    work = [w for w in ctx.work if w["family"] == "pq_scan"]
    if not work or len(work) != ctx.trace["batches"] or ctx.trace["busy_s"] <= 0:
        return None
    return 100.0 * sum(pq_scan.bound_s(**w) for w in work) / ctx.trace["busy_s"]
