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
