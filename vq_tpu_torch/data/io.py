"""fvecs / ivecs binary IO — a copy of ``vq_tpu/data/io.py``.

Format parity with the reference's faiss_export helpers
(src/haag_vq/utils/faiss_export.py:46-124) and the SAQ engine's loaders
(external/saq/include/saq/io_utils.h): each row is an int32 dimension header
followed by `dim` float32 (fvecs) or int32 (ivecs) payload values.
"""

from __future__ import annotations

import os

import numpy as np


def _load_vecs(path: str, payload_dtype) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size == 0:
        return np.zeros((0, 0), dtype=payload_dtype)
    dim = int(np.frombuffer(raw[:4].tobytes(), dtype=np.int32)[0])
    if dim <= 0:
        raise ValueError(f"{path}: bad leading dimension {dim}")
    row_bytes = 4 + dim * 4
    if raw.size % row_bytes != 0:
        raise ValueError(f"{path}: size {raw.size} not a multiple of row bytes {row_bytes}")
    n = raw.size // row_bytes
    mat = raw.reshape(n, row_bytes)
    dims = mat[:, :4].copy().view(np.int32).ravel()
    if not np.all(dims == dim):
        raise ValueError(f"{path}: inconsistent row dimensions")
    return mat[:, 4:].copy().view(payload_dtype).reshape(n, dim)


def load_fvecs(path: str) -> np.ndarray:
    return _load_vecs(path, np.float32)


def load_ivecs(path: str) -> np.ndarray:
    return _load_vecs(path, np.int32)


def _write_vecs(path: str, x: np.ndarray, payload_dtype) -> None:
    x = np.ascontiguousarray(x, dtype=payload_dtype)
    n, d = x.shape
    out = np.empty((n, 4 + d * 4), dtype=np.uint8)
    out[:, :4] = np.frombuffer(
        np.full(n, d, dtype=np.int32).tobytes(), dtype=np.uint8
    ).reshape(n, 4)
    out[:, 4:] = x.view(np.uint8).reshape(n, d * 4)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    out.tofile(path)


def write_fvecs(path: str, x: np.ndarray) -> None:
    _write_vecs(path, x, np.float32)


def write_ivecs(path: str, x: np.ndarray) -> None:
    _write_vecs(path, x, np.int32)
