"""Pairwise distance distortion — counterpart of
``vq_tpu/metrics/pairwise.py``.

For random distinct pairs (i, j):  distortion = |‖x̂_i−x̂_j‖ / ‖x_i−x_j‖ − 1|,
reported as mean/median/max/std over decompressed pairs only (2·P rows).
`compute_asymmetric_pairwise_distortion` keeps one side of each pair
uncompressed (the query side of an ADC scan): |‖x_i−x̂_j‖ / ‖x_i−x_j‖ − 1|.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vq_tpu_torch._device import to_host


def _pairs(n: int, num_pairs: int, seed: int):
    rng = np.random.default_rng(seed)
    idx1 = rng.integers(0, n, num_pairs)
    idx2 = rng.integers(0, n, num_pairs)
    mask = idx1 != idx2
    idx1, idx2 = idx1[mask], idx2[mask]
    if len(idx1) == 0:
        m = min(num_pairs, n - 1)
        idx1 = np.arange(m)
        idx2 = np.arange(m) + 1
    return idx1, idx2


def _summary(rel: np.ndarray, num_pairs: int) -> Dict[str, float]:
    return {
        "mean": float(np.mean(rel)),
        "median": float(np.median(rel)),
        "max": float(np.max(rel)),
        "std": float(np.std(rel)),
        "num_pairs": int(num_pairs),
    }


def compute_pairwise_distortion(X, X_hat, num_pairs: int = 1000,
                                seed: int = 42) -> Dict[str, float]:
    idx1, idx2 = _pairs(len(X), num_pairs, seed)
    X = np.asarray(to_host(X), dtype=np.float32)
    X_hat = np.asarray(to_host(X_hat), dtype=np.float32)
    orig = np.linalg.norm(X[idx1] - X[idx2], axis=1)
    comp = np.linalg.norm(X_hat[idx1] - X_hat[idx2], axis=1)
    return _summary(np.abs(comp / (orig + 1e-10) - 1.0), len(idx1))


def compute_asymmetric_pairwise_distortion(X, codes, model, num_pairs: int = 1000,
                                           seed: int = 42) -> Dict[str, float]:
    """|‖x_i − x̂_j‖ / ‖x_i − x_j‖ − 1|: the i side stays exact (an ADC
    query), the j side is ``model.decompress`` of its row of ``codes``
    (numpy codes or a tensor on any device, sliced where they live)."""
    idx1, idx2 = _pairs(len(X), num_pairs, seed)
    X = np.asarray(to_host(X), dtype=np.float32)
    x_j_hat = np.asarray(to_host(model.decompress(torch.as_tensor(codes[idx2]))),
                         dtype=np.float32)
    orig = np.linalg.norm(X[idx1] - X[idx2], axis=1)
    asym = np.linalg.norm(X[idx1] - x_j_hat, axis=1)
    return _summary(np.abs(asym / (orig + 1e-10) - 1.0), len(idx1))
