"""Scalar Quantization — counterpart of ``vq_tpu/methods/sq.py``.

Per-dimension min/max uniform quantization at 4/8/16 bits: two 4-bit codes
a byte (dim 2i in the low nibble), uint8 at 8 bits, uint16 at 16, as the
JAX package stores them.  The range is fitted by a streamed per-dimension
min/max (``data/sampling.chunked_min_max``); search is the generic decode
scan (``kernels/adc.py::scan_generic_topk``), plain PyTorch, as the JAX
package leaves it to XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vq_tpu_torch._device import as_f32, to_device
from vq_tpu_torch.core.config import SQConfig
from vq_tpu_torch.data.sampling import chunked_min_max
from vq_tpu_torch.methods.base import BaseQuantizer


class SQParams(NamedTuple):
    lo: torch.Tensor  # (D,) per-dim min
    scale: torch.Tensor  # (D,) (max-min)/(2^b - 1), zeros→1 guarded


def fit(x, cfg: SQConfig, device) -> SQParams:
    lo, hi = chunked_min_max(x, device)
    scale = (hi - lo) / ((1 << cfg.num_bits) - 1)
    return SQParams(lo=lo, scale=torch.where(scale > 0, scale, torch.ones_like(scale)))


def encode(params: SQParams, x, num_bits: int) -> torch.Tensor:
    x = as_f32(x, params.lo.device)
    levels = (1 << num_bits) - 1
    q = torch.clamp(torch.round((x - params.lo) / params.scale), 0, levels)
    if num_bits == 4:
        q = q.to(torch.uint8)
        if q.shape[1] % 2:
            q = torch.nn.functional.pad(q, (0, 1))
        return q[:, 0::2] | (q[:, 1::2] << 4)  # two dims a byte
    if num_bits <= 8:
        return q.to(torch.uint8)
    return q.to(torch.int32).to(torch.uint16)


def decode(params: SQParams, codes: torch.Tensor, num_bits: int, dim: int) -> torch.Tensor:
    if num_bits == 4:
        q = torch.stack([codes & 0x0F, codes >> 4], dim=-1).reshape(codes.shape[0], -1)[:, :dim]
    else:
        q = codes.to(torch.int32)
    return params.lo + q.to(torch.float32) * params.scale


class SQ(BaseQuantizer):
    name = "sq"

    def __init__(self, cfg: SQConfig = SQConfig(), device=None):
        super().__init__(device)
        if cfg.num_bits not in (4, 8, 16):
            raise ValueError("SQ supports 4, 8, or 16 bits")
        self.cfg = cfg

    def fit(self, X) -> "SQ":
        self._dim = X.shape[1]
        self.params = fit(X, self.cfg, self._bind_device(X))
        return self

    def compress(self, X) -> torch.Tensor:
        return encode(self.params, X, self.cfg.num_bits)

    def decompress(self, codes) -> torch.Tensor:
        if isinstance(codes, np.ndarray):
            codes = torch.from_numpy(np.array(codes))
        return decode(self.params, to_device(codes, self.device), self.cfg.num_bits, self._dim)

    def decode_fn(self):
        params, num_bits, dim = self.params, self.cfg.num_bits, self._dim
        return lambda ct: decode(params, ct, num_bits, dim)

    def encode_fn(self):
        params, num_bits = self.params, self.cfg.num_bits
        return lambda x: encode(params, x, num_bits)

    def code_bytes_per_vector(self) -> float:
        return self._dim * self.cfg.num_bits / 8.0

    def config_dict(self):
        return {"B": self.cfg.num_bits}
