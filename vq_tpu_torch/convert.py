"""JAX-package state (as numpy arrays) → the port's state.

With these, both packages search the same codes with the same codebooks:
the caller takes ``np.asarray`` of the JAX objects (this module never
imports jax) and hands the arrays over.

    params = pq_params_from_numpy(np.asarray(jax_pq.params.codebooks), "cuda")
    index = flat_index_from_numpy(codebooks, codes, norms, num_rows,
                                  jax_index.search_cfg, jax_pq.cfg)
"""

from __future__ import annotations

import numpy as np
import torch

from vq_tpu.core.config import PQConfig, SearchConfig
from vq_tpu_torch._device import resolve_device
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.methods.pq import PQ, PQParams


def pq_params_from_numpy(codebooks: np.ndarray, device=None) -> PQParams:
    """``PQParams.codebooks`` (M, K, dsub) → f32 tensor on ``device``."""
    cb = np.asarray(codebooks, dtype=np.float32)
    if cb.ndim != 3:
        raise ValueError(f"codebooks must be (M, K, dsub), got {cb.shape}")
    return PQParams(codebooks=torch.tensor(cb, device=resolve_device(device)))


def codes_from_numpy(codes: np.ndarray, device=None) -> torch.Tensor:
    """PQ codes (N, M) → uint8 tensor (int32 when a code exceeds 255)."""
    c = np.asarray(codes)
    if c.ndim != 2:
        raise ValueError(f"codes must be (N, M), got {c.shape}")
    dtype = np.uint8 if c.size == 0 or int(c.max()) <= 255 else np.int32
    return torch.tensor(c.astype(dtype), device=resolve_device(device))


def pq_from_numpy(codebooks: np.ndarray, cfg: PQConfig, seed: int = 0,
                  device=None) -> PQ:
    """A fitted ``PQ`` quantizer holding the given codebooks."""
    pq = PQ(cfg, seed=seed, device=resolve_device(device))
    pq.params = pq_params_from_numpy(codebooks, pq.device)
    pq._dim = pq.params.codebooks.shape[0] * pq.params.codebooks.shape[2]
    return pq


def flat_index_from_numpy(codebooks: np.ndarray, codes: np.ndarray, norms: np.ndarray,
                          num_rows: int, search_cfg: SearchConfig, pq_cfg: PQConfig,
                          device=None) -> FlatQuantizedIndex:
    """The state of a JAX ``FlatQuantizedIndex(PQ)`` (``codes``, ``norms``,
    ``num_rows``, search config; ``vq_tpu/index/flat.py``) → a port index."""
    index = FlatQuantizedIndex(pq_from_numpy(codebooks, pq_cfg, device=device), search_cfg)
    index.codes = codes_from_numpy(codes, index.device)
    index.norms = torch.tensor(np.asarray(norms, dtype=np.float32), device=index.device)
    index.num_rows = int(num_rows)
    return index
