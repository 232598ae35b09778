"""packed_scan.roofline: the IVF packed scan's least time
(``costs/packed_scan.py``, from the probed lists IVF semantics need) over
all the device time the traced batches took, %."""

from vqbench.costs import packed_scan


def read(ctx):
    work = [w for w in ctx.work if w["family"] == "packed_scan"]
    if not work or len(work) != ctx.trace["batches"] or ctx.trace["busy_s"] <= 0:
        return None
    return 100.0 * sum(packed_scan.bound_s(**w) for w in work) / ctx.trace["busy_s"]
