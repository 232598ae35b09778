"""Rank distortion — counterpart of ``vq_tpu/metrics/rank.py``.

Fraction of the true top-k neighbors missing from the retrieved top-k —
equal to 1 − recall@k, taken from the ids of the one search.
"""

from __future__ import annotations

import numpy as np

from vq_tpu_torch._device import to_host


def compute_rank_distortion_per_query(true_ids, retrieved_ids, k: int = 10) -> np.ndarray:
    true_ids = to_host(true_ids)[:, :k]
    retrieved_ids = to_host(retrieved_ids)[:, :k]
    out = np.zeros(len(true_ids))
    for i, (t, r) in enumerate(zip(true_ids, retrieved_ids)):
        missing = len(set(t.tolist()) - set(r.tolist()))
        out[i] = missing / k
    return out


def compute_rank_distortion(true_ids, retrieved_ids, k: int = 10) -> float:
    return float(np.mean(compute_rank_distortion_per_query(true_ids, retrieved_ids, k)))
