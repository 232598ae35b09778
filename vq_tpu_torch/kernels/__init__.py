"""Compute of the port: ADC scan and top-k, k-means, and the hand-written
CUDA kernels (``csrc/``) behind ``pq_scan`` and ``packed_scan``.  The
re-exports are the JAX package's (``vq_tpu/kernels/__init__.py``); none of
them loads a CUDA library on import (``_build`` does, at the first
launch)."""

from vq_tpu_torch.kernels.adc import (
    build_lut,
    decode_pq,
    exact_topk,
    pairwise_sqdist,
    scan_codes_topk,
    scan_generic_topk,
)
from vq_tpu_torch.kernels.kmeans import assign, assign_batched, kmeans, kmeans_batched

__all__ = [
    "kmeans",
    "kmeans_batched",
    "assign",
    "assign_batched",
    "pairwise_sqdist",
    "decode_pq",
    "build_lut",
    "scan_codes_topk",
    "scan_generic_topk",
    "exact_topk",
]


def kernel_launches() -> dict:
    """The four hand-written kernels' launch counters (``pq_scan``,
    ``packed_scan``), by kernel; not a re-export of the JAX package."""
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.kernels import pq_scan as ps

    return {"pq_scan_topk_fused": ps.pq_scan_topk_fused.launches,
            "pq_score_all": ps.pq_score_all.launches,
            "packed_scan_topk": pk.packed_scan_topk.launches,
            "packed_scan_topk_gather": pk.packed_scan_topk.gather_launches}
