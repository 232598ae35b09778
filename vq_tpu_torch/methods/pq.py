"""Product Quantization — counterpart of ``vq_tpu/methods/pq.py``.

M subquantizers × B bits, codebooks (M, 2^B, D/M).  Training runs all M
subspace k-means problems as one batched Lloyd program
(``kernels/kmeans.py``); encoding is a row-chunked batched matmul-argmin;
decoding is a gather.  Search goes through ``kernels/adc.py::
scan_codes_topk``, which on the card runs the hand-written PQ scan kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vq_tpu_torch.core.config import PQConfig
from vq_tpu_torch._device import as_f32, device_of, make_generator, to_device
from vq_tpu_torch.data.sampling import host_sample_rows
from vq_tpu_torch.kernels.adc import decode_pq, scan_codes_topk
from vq_tpu_torch.kernels.kmeans import kmeans_batched
from vq_tpu_torch.methods.base import BaseQuantizer

_ENCODE_ELEMS = 1 << 28  # cap on one chunk's (rows, M, K) f32 product


class PQParams(NamedTuple):
    codebooks: torch.Tensor  # (M, K, dsub) float32


def _to_subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    """(N, D) → (M, N, D/M)."""
    n, d = x.shape
    if d % m != 0:
        raise ValueError(f"dim {d} not divisible by num_subquantizers {m}")
    return x.reshape(n, m, d // m).transpose(0, 1)


def fit(x, cfg: PQConfig, seed: int = 0, device=None) -> PQParams:
    """Train codebooks on ≤ max_points_per_centroid·K rows of x, sampled
    before anything moves to ``device`` (default: x's device, or the card for host data)."""
    device = device_of(x, device)
    cap = cfg.kmeans.max_points_per_centroid * cfg.codebook_size
    xs = as_f32(host_sample_rows(x, cap, seed), device)
    codebooks = kmeans_batched(make_generator(seed, device),
                               _to_subspaces(xs, cfg.num_subquantizers),
                               cfg.codebook_size, cfg.kmeans)
    return PQParams(codebooks=codebooks.contiguous())


def encode_chunked(codebooks: torch.Tensor, x, rotation=None,
                   chunk: int = 65536) -> torch.Tensor:
    """Subspace argmin encode, row-chunked: (N, D) → (N, M) codes on the
    codebooks' device: uint8 for K ≤ 256, else uint16 (the JAX package's
    dtypes, so codes, footprints and saved indexes match byte for byte).

    Peak memory is one chunk, not the corpus: rows are read chunk by chunk
    (a host corpus is moved one chunk at a time) and the last chunk is
    simply shorter, so no padded copy of the corpus is made.  ‖x_sub‖² is
    constant per (row, m), so the argmin needs only ‖c‖² − 2·x_sub·c.
    """
    cb = codebooks
    m, kk, dsub = cb.shape
    n, d = x.shape
    if d != m * dsub:
        raise ValueError(f"dim {d} != M·dsub = {m}·{dsub}")
    if kk > 1 << 16:
        raise ValueError(f"codebook size {kk} > 65536: codes would not fit uint16")
    dtype = torch.uint8 if kk <= 256 else torch.uint16
    c2 = torch.sum(cb * cb, dim=-1)  # (M, K)
    chunk = max(1, min(chunk, _ENCODE_ELEMS // (m * kk)))
    out = torch.empty((n, m), dtype=dtype, device=cb.device)
    for st in range(0, n, chunk):
        xc = as_f32(x[st:st + chunk], cb.device)
        if rotation is not None:
            xc = xc @ rotation
        ip = torch.einsum("cmd,mkd->cmk", xc.reshape(-1, m, dsub), cb)
        out[st:st + xc.shape[0]] = torch.argmin(c2[None] - 2.0 * ip, dim=-1).to(dtype)
    return out


def encode(params: PQParams, x, chunk: int = 65536) -> torch.Tensor:
    """(N, D) → (N, M) codes (uint8 for B ≤ 8, uint16 above)."""
    return encode_chunked(params.codebooks, x, chunk=chunk)


def decode(params: PQParams, codes: torch.Tensor) -> torch.Tensor:
    return decode_pq(params.codebooks, codes)


class PQ(BaseQuantizer):
    name = "pq"

    def __init__(self, cfg: PQConfig = PQConfig(), seed: int = 0, device=None):
        super().__init__(device)
        self.cfg = cfg
        self.seed = seed

    def fit(self, X) -> "PQ":
        self._dim = X.shape[1]
        self.params = fit(X, self.cfg, seed=self.seed, device=self._bind_device(X))
        return self

    def compress(self, X) -> torch.Tensor:
        return encode(self.params, X)

    def decompress(self, codes) -> torch.Tensor:
        if isinstance(codes, np.ndarray):
            codes = torch.from_numpy(np.array(codes))  # a writable copy
        return decode(self.params, to_device(codes, self.device))

    def decode_fn(self):
        codebooks = self.params.codebooks
        return lambda ct: decode_pq(codebooks, ct)

    def scan_topk(self, queries, codes, k, metric, norms=None, tile_rows=16384,
                  use_bf16=True, approx=False, cache=None, num_valid=None):
        return scan_codes_topk(queries, codes, self.params.codebooks, k, metric, norms,
                               tile_rows, use_bf16, num_valid=num_valid, approx=approx)

    def code_bytes_per_vector(self) -> float:
        bytes_per_code = 1 if self.cfg.num_bits <= 8 else 2
        return float(self.cfg.num_subquantizers * bytes_per_code)

    def config_dict(self):
        return {
            "M": self.cfg.num_subquantizers,
            "B": self.cfg.num_bits,
            "kmeans_iters": self.cfg.kmeans.iters,
        }
