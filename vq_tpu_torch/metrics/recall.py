"""Recall metrics — counterpart of ``vq_tpu/metrics/recall.py``.

Recall is a pure set overlap on (nq, k) id arrays; the scans that produce
the ids live in ``kernels/adc.py`` and the indexes, and run once.
"""

from __future__ import annotations

from typing import Dict, Sequence

from vq_tpu_torch._device import to_host


def recall_at_k(true_ids, retrieved_ids, k: int) -> float:
    """Mean |gt_top_k ∩ retrieved_top_k| / k over queries; both arrays
    sorted best-first, truncated to k columns here."""
    true_ids = to_host(true_ids)[:, :k]
    retrieved_ids = to_host(retrieved_ids)[:, :k]
    hits = 0.0
    for t, r in zip(true_ids, retrieved_ids):
        hits += len(set(t.tolist()) & set(r.tolist())) / k
    return float(hits / len(true_ids))


def recall_at_ks(true_ids, retrieved_ids, ks: Sequence[int] = (1, 10, 100)) -> Dict[int, float]:
    """Recall at several cutoffs."""
    max_k = min(true_ids.shape[1], retrieved_ids.shape[1])
    return {k: recall_at_k(true_ids, retrieved_ids, k) for k in ks if k <= max_k}


def evaluate_recall(index, queries, ground_truth) -> Dict[str, float]:
    """Search `index` and report recall@10/@100."""
    k = min(100, ground_truth.shape[1])
    ids, _ = index.search_with_scores(queries, k=k)
    out = {}
    for kk in (10, 100):
        if kk <= k:
            out[f"recall@{kk}"] = recall_at_k(ground_truth, ids, kk)
    return out
