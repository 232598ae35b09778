"""Harness metrics — counterpart of ``vq_tpu/metrics`` (numpy on the host).

Every function takes numpy arrays or tensors on any device; a tensor is
copied to the host first (``_device.to_host``)."""

from vq_tpu_torch.metrics.recall import recall_at_k, recall_at_ks, evaluate_recall
from vq_tpu_torch.metrics.distortion import (
    compute_distortion,
    reconstruction_mse,
)
from vq_tpu_torch.metrics.pairwise import (
    compute_asymmetric_pairwise_distortion,
    compute_pairwise_distortion,
)
from vq_tpu_torch.metrics.rank import compute_rank_distortion, compute_rank_distortion_per_query
from vq_tpu_torch.metrics.performance import time_compress, time_decompress, measure_qps

__all__ = [
    "recall_at_k",
    "recall_at_ks",
    "evaluate_recall",
    "compute_distortion",
    "reconstruction_mse",
    "compute_pairwise_distortion",
    "compute_asymmetric_pairwise_distortion",
    "compute_rank_distortion",
    "compute_rank_distortion_per_query",
    "time_compress",
    "time_decompress",
    "measure_qps",
]
