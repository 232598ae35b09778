"""Latency / throughput metrics — counterpart of
``vq_tpu/metrics/performance.py``.

The port's ``compress``/``decompress`` return card tensors and return
before the card has finished, so every timed window ends with a copy to
the host (``_device.to_host``), as the JAX package's ``np.asarray`` does:
a timing never ends before the work.  Timings are best-of-N wall clocks.
`measure_qps` times end-to-end index search (``search_with_scores``
returns numpy, which waits for the card).
"""

from __future__ import annotations

from time import perf_counter
from typing import Dict, Tuple

import numpy as np
import torch

from vq_tpu_torch._device import to_host


def time_compress(model, X) -> Tuple[torch.Tensor, float]:
    """(codes where the model lives, seconds of compress and the codes'
    copy to the host)."""
    start = perf_counter()
    codes = model.compress(X)
    to_host(codes)
    return codes, float(perf_counter() - start)


def time_decompress(model, codes) -> Tuple[np.ndarray, float]:
    """(reconstruction as numpy on the host, seconds)."""
    start = perf_counter()
    rec = to_host(model.decompress(codes))
    return rec, float(perf_counter() - start)


def measure_qps(
    index,
    queries,
    k: int = 10,
    repeats: int = 3,
    warmup: int = 1,
) -> Dict[str, float]:
    """End-to-end search throughput, best-of-`repeats` after `warmup` runs
    (warm-up absorbs the kernels' first-call build and caches)."""
    queries = np.asarray(to_host(queries), dtype=np.float32)
    if queries.ndim == 1:
        queries = queries[None, :]
    for _ in range(warmup):
        index.search_with_scores(queries, k=k)
    durations = []
    for _ in range(max(1, repeats)):
        start = perf_counter()
        index.search_with_scores(queries, k=k)
        durations.append(max(perf_counter() - start, 1e-12))
    nq = float(len(queries))
    qps = [nq / d for d in durations]
    lat = [d / nq * 1000.0 for d in durations]
    return {
        "qps": float(np.max(qps)),
        "qps_mean": float(np.mean(qps)),
        "qps_std": float(np.std(qps)),
        "avg_query_latency_ms": float(np.min(lat)),
        "latency_ms_std": float(np.std(lat)),
    }
