"""Bit-packing of per-dimension quantization indices — counterpart of
``vq_tpu/core/packing.py``.

Row layout is part of the saved format and is byte-identical to the JAX
package's: B-bit indices packed MSB-first into uint8 bytes (numpy packbits
convention), followed by float32 side-channel fields viewed as 4 raw
little-endian bytes each.
"""

from __future__ import annotations

import torch


def packed_bytes(d: int, bits: int) -> int:
    """ceil(D*B/8) — code bytes for D dims at B bits."""
    return (d * bits + 7) // 8


def pack_bits(idx: torch.Tensor, bits: int) -> torch.Tensor:
    """(N, D) integer indices in [0, 2^bits) → (N, ceil(D*bits/8)) uint8,
    MSB-first within each index and within each byte."""
    n, d = idx.shape
    pos = torch.arange(bits - 1, -1, -1, dtype=torch.int32, device=idx.device)
    b = ((idx.to(torch.int32)[:, :, None] >> pos) & 1).to(torch.uint8).reshape(n, d * bits)
    pad = (-b.shape[1]) % 8
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=idx.device)
    # each byte's bit-weighted sum is < 256, so uint8 arithmetic is exact
    return (b.reshape(n, -1, 8) * weights).sum(dim=-1, dtype=torch.uint8)


def unpack_bits(packed: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """(N, nbytes) uint8 → (N, D) int32 indices (inverse of ``pack_bits``)."""
    n = packed.shape[0]
    pos = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    b = ((packed[:, :, None] >> pos) & 1).reshape(n, -1)[:, : d * bits]
    weights = 1 << torch.arange(bits - 1, -1, -1, dtype=torch.int32, device=packed.device)
    return (b.reshape(n, d, bits).to(torch.int32) * weights).sum(dim=-1, dtype=torch.int32)


def f32_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """(N,) float32 → (N, 4) uint8 raw little-endian view."""
    return x.to(torch.float32).contiguous().view(torch.uint8).reshape(-1, 4)


def bytes_to_f32(b: torch.Tensor) -> torch.Tensor:
    """(N, 4) uint8 → (N,) float32 (inverse of ``f32_to_bytes``)."""
    return b.contiguous().view(torch.float32).reshape(b.shape[:-1])
