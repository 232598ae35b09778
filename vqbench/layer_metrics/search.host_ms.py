"""search.host_ms: the host's milliseconds a batch from the entry of the
index's ``search_with_scores`` until every kernel is enqueued: the
program's ``search`` span less its ``search.fetch`` (``vq_tpu_torch/
utils/trace.py``), the median over the newest 64 unprofiled batches; None
below 16 of them, or with a program that records no spans."""

import statistics


def read(ctx):
    try:
        from vq_tpu_torch.utils.trace import recent
    except ImportError:
        return None
    recs = [r for r in recent("search", 64) if "search.fetch" in r]
    if len(recs) < 16:
        return None
    return 1e3 * statistics.median(r["search"] - r["search.fetch"] for r in recs)
