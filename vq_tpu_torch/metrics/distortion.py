"""Reconstruction distortion metrics — counterpart of
``vq_tpu/metrics/distortion.py``.

Two conventions coexist in the reference and both are kept:
- `compute_distortion` — mean per-vector squared error, Σ_d (x−x̂)² averaged
  over rows (the sweep pipeline).
- `reconstruction_mse` — mean per-element squared error (the study
  pipeline).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from vq_tpu_torch._device import to_host


def compute_distortion(X, X_hat) -> float:
    diffs = (np.asarray(to_host(X), dtype=np.float32)
             - np.asarray(to_host(X_hat), dtype=np.float32))
    return float(np.mean(np.sum(diffs**2, axis=1)))


def reconstruction_mse(X, X_hat, sample: Optional[int] = None) -> float:
    X = np.asarray(to_host(X), dtype=np.float32)
    X_hat = np.asarray(to_host(X_hat), dtype=np.float32)
    if sample is not None and len(X) > sample:
        X, X_hat = X[:sample], X_hat[:sample]
    return float(np.mean((X - X_hat) ** 2))
