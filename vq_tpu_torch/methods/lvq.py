"""Locally-adaptive Vector Quantization (LVQ) — counterpart of
``vq_tpu/methods/lvq.py``.

Global mean, then a per-vector uniform scalar quantizer over the row's own
[lo, lo + span]: self-contained rows [packed B-bit indices ‖ lo f32 ‖
delta f32] = ceil(D·B/8) + 8 bytes, byte-identical to the JAX package's
(``core/packing``).  Search is the generic decode scan, plain PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vq_tpu_torch._device import as_f32, to_device
from vq_tpu_torch.core.config import LVQConfig
from vq_tpu_torch.core.packing import (
    bytes_to_f32,
    f32_to_bytes,
    pack_bits,
    packed_bytes,
    unpack_bits,
)
from vq_tpu_torch.methods.base import BaseQuantizer

# rows per compress step: pack_bits holds an (n, D, bits) bit tensor, so the
# corpus is packed a chunk at a time (the JAX package's chunk)
_COMPRESS_CHUNK = 16384


class LVQParams(NamedTuple):
    mean: torch.Tensor  # (D,) global mean


def fit(x, device) -> LVQParams:
    return LVQParams(mean=torch.mean(as_f32(x, device), dim=0))


def encode(params: LVQParams, x, num_bits: int) -> torch.Tensor:
    x = as_f32(x, params.mean.device)
    levels = (1 << num_bits) - 1
    r = x - params.mean
    lo = torch.amin(r, dim=1)
    span = torch.amax(r, dim=1) - lo
    delta = torch.where(span == 0.0, torch.full_like(span, torch.finfo(torch.float32).tiny),
                        span / levels)
    idx = torch.clamp(torch.round((r - lo[:, None]) / delta[:, None]), 0, levels).to(torch.int32)
    return torch.cat([pack_bits(idx, num_bits), f32_to_bytes(lo), f32_to_bytes(delta)], dim=1)


def decode(params: LVQParams, codes: torch.Tensor, num_bits: int) -> torch.Tensor:
    d = params.mean.shape[0]
    ib = packed_bytes(d, num_bits)
    idx = unpack_bits(codes[:, :ib], num_bits, d)
    lo = bytes_to_f32(codes[:, ib:ib + 4])
    delta = bytes_to_f32(codes[:, ib + 4:ib + 8])
    return idx.to(torch.float32) * delta[:, None] + lo[:, None] + params.mean


class LVQ(BaseQuantizer):
    name = "lvq"

    def __init__(self, cfg: LVQConfig = LVQConfig(), device=None):
        super().__init__(device)
        if not 1 <= cfg.num_bits <= 8:
            raise ValueError("num_bits must be in [1, 8]")
        self.cfg = cfg

    def fit(self, X) -> "LVQ":
        self._dim = X.shape[1]
        self.params = fit(X, self._bind_device(X))
        return self

    def compress(self, X, chunk: int = _COMPRESS_CHUNK) -> torch.Tensor:
        n = X.shape[0]
        out = torch.empty((n, packed_bytes(self._dim, self.cfg.num_bits) + 8),
                          dtype=torch.uint8, device=self.device)
        for i0 in range(0, n, chunk):
            rows = encode(self.params, X[i0:i0 + chunk], self.cfg.num_bits)
            out[i0:i0 + rows.shape[0]] = rows
        return out

    def decompress(self, codes) -> torch.Tensor:
        if isinstance(codes, np.ndarray):
            codes = torch.from_numpy(np.array(codes))
        return decode(self.params, to_device(codes, self.device), self.cfg.num_bits)

    def decode_fn(self):
        params, bits = self.params, self.cfg.num_bits
        return lambda ct: decode(params, ct, bits)

    def code_bytes_per_vector(self) -> float:
        return float(packed_bytes(self._dim, self.cfg.num_bits) + 8)

    def config_dict(self):
        return {"B": self.cfg.num_bits}
