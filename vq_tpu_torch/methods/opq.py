"""Optimized Product Quantization — counterpart of ``vq_tpu/methods/opq.py``.

OPQ-NP: start from a PQ fit on the raw sample, then ``opq_iters`` times
  (1) one Lloyd step of all M sub-codebooks on X·R (``kmeans._lloyd_iter``,
      the port's one deterministic Lloyd step),
  (2) the orthogonal Procrustes update R = U·Vᵀ from the SVD of Xᵀ·X̂,
      with Xᵀ·X̂ accumulated over row chunks (X̂ is never whole),
then three polish steps of the codebooks on the final rotation.  R is
orthogonal, so L2/IP search in rotated space is exact: the queries are
rotated once and the corpus is scanned by the PQ scan (``kernels/adc.py::
scan_codes_topk``, the hand-written PQ kernels on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vq_tpu_torch._device import as_f32, device_of, make_generator, to_device
from vq_tpu_torch.core.config import OPQConfig
from vq_tpu_torch.data.sampling import host_sample_rows
from vq_tpu_torch.kernels.adc import decode_pq, scan_codes_topk
from vq_tpu_torch.kernels.kmeans import _lloyd_iter, assign_batched, kmeans_batched
from vq_tpu_torch.methods.base import BaseQuantizer
from vq_tpu_torch.methods.pq import _to_subspaces, encode_chunked

_XTX_BUDGET = 1 << 30  # bytes of one chunk's (n, M, K) work in Xᵀ·X̂


class OPQParams(NamedTuple):
    rotation: torch.Tensor  # (D, D) orthogonal, applied as X @ R
    codebooks: torch.Tensor  # (M, K, dsub)


def _xt_xhat(xt: torch.Tensor, xs: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Xᵀ·X̂ accumulated over row chunks: the Procrustes update needs only
    the (D, D) product, so the reconstruction X̂ exists one chunk at a time."""
    m, kk, _ = codebooks.shape
    chunk = max(512, _XTX_BUDGET // (4 * m * kk))
    d = xt.shape[1]
    acc = torch.zeros((d, d), dtype=torch.float32, device=xt.device)
    for i0 in range(0, xt.shape[0], chunk):
        codes = assign_batched(xs[:, i0:i0 + chunk], codebooks).T
        acc += xt[i0:i0 + chunk].T @ decode_pq(codebooks, codes)
    return acc


def _procrustes(m: torch.Tensor) -> torch.Tensor:
    """argmin over orthogonal R of ‖X·R − X̂‖_F = U·Vᵀ, U,S,Vᵀ = svd(Xᵀ·X̂).

    An f32 SVD on the card returns U·Vᵀ orthogonal to ~2e-5 an entry at
    D=1536; one Newton–Schulz step R·(3I − RᵀR)/2, which squares that
    error, brings it to f32 rounding."""
    u, _, vt = torch.linalg.svd(m, full_matrices=False)
    r = u @ vt
    return 1.5 * r - 0.5 * r @ (r.T @ r)


def fit(x, cfg: OPQConfig, train_cap: int = 100_000, seed: int = 0,
        device=None) -> OPQParams:
    """Rotation and codebooks from ≤ train_cap rows of x, sampled before
    anything moves to ``device`` (default: x's device, or the card)."""
    device = device_of(x, device)
    xt = as_f32(host_sample_rows(x, train_cap, seed), device)
    d = xt.shape[1]
    m = cfg.num_subquantizers
    if d % m != 0:
        raise ValueError(f"dim {d} not divisible by num_subquantizers {m}")
    r = torch.eye(d, dtype=torch.float32, device=device)
    codebooks = kmeans_batched(make_generator(seed, device), _to_subspaces(xt, m),
                               cfg.codebook_size, cfg.kmeans)
    for _ in range(cfg.opq_iters):
        xs = _to_subspaces(xt @ r, m)
        codebooks = _lloyd_iter(xs, codebooks)
        r = _procrustes(_xt_xhat(xt, xs, codebooks))
    xs = _to_subspaces(xt @ r, m)
    for _ in range(3):  # codebook polish on the final rotation
        codebooks = _lloyd_iter(xs, codebooks)
    return OPQParams(rotation=r.contiguous(), codebooks=codebooks.contiguous())


def encode(params: OPQParams, x) -> torch.Tensor:
    """The rotation folded into PQ's row-chunked encode (peak memory one
    chunk)."""
    return encode_chunked(params.codebooks, x, rotation=params.rotation)


def decode(params: OPQParams, codes: torch.Tensor) -> torch.Tensor:
    return decode_pq(params.codebooks, codes) @ params.rotation.T


class OPQ(BaseQuantizer):
    name = "opq"

    def __init__(self, cfg: OPQConfig = OPQConfig(), seed: int = 0, device=None):
        super().__init__(device)
        self.cfg = cfg
        self.seed = seed

    def fit(self, X) -> "OPQ":
        self._dim = X.shape[1]
        self.params = fit(X, self.cfg, seed=self.seed, device=self._bind_device(X))
        return self

    def compress(self, X) -> torch.Tensor:
        return encode(self.params, X)

    def decompress(self, codes) -> torch.Tensor:
        if isinstance(codes, np.ndarray):
            codes = torch.from_numpy(np.array(codes))
        return decode(self.params, to_device(codes, self.device))

    def decode_fn(self):
        params = self.params
        return lambda ct: decode(params, ct)

    def scan_topk(self, queries, codes, k, metric, norms=None, tile_rows=16384,
                  use_bf16=True, approx=False, cache=None, num_valid=None):
        """The rotation is orthogonal: rotate the queries once (f32), then
        the PQ scan in rotated space ranks exactly as L2/IP/NIP on x̂."""
        qr = as_f32(queries, self.device) @ self.params.rotation
        return scan_codes_topk(qr, codes, self.params.codebooks, k, metric, norms, tile_rows,
                               use_bf16, num_valid=num_valid, approx=approx)

    def code_bytes_per_vector(self) -> float:
        bytes_per_code = 1 if self.cfg.num_bits <= 8 else 2
        return float(self.cfg.num_subquantizers * bytes_per_code)

    def config_dict(self):
        return {"M": self.cfg.num_subquantizers, "B": self.cfg.num_bits,
                "opq_iters": self.cfg.opq_iters}
