"""search.wait_ms: the host's milliseconds a batch waiting, once every
kernel is enqueued, for the device to finish and the answers to reach the
host: the program's ``search.fetch`` span (``vq_tpu_torch/utils/
trace.py``), the median over the newest 64 unprofiled batches; None below
16 of them, or with a program that records no spans."""

import statistics


def read(ctx):
    try:
        from vq_tpu_torch.utils.trace import recent
    except ImportError:
        return None
    recs = [r for r in recent("search", 64) if "search.fetch" in r]
    if len(recs) < 16:
        return None
    return 1e3 * statistics.median(r["search.fetch"] for r in recs)
