"""Variable-width packing of per-dimension codes — counterpart of
``vq_tpu/core/ffd.py``.

Two byte layouts, both byte-identical to the JAX package's:

* FFD (First-Fit-Decreasing): every dim's b_d-bit field lies wholly inside
  one byte (b_d ≤ 8), placed by FFD with the "4-fix" (width-4 fields go
  after the width-3 ones, so a lone 4 cannot break the 3s' packing).  The
  layout is host numpy, a copy of the JAX package's.
* dense: one contiguous MSB-first bit stream over the dims, crossing bytes.

The JAX package packs FFD fields with an assignment-matrix product; here
the non-overlapping fields are shifted and summed into their bytes
(integer sums, so the order does not matter) and unpacked with a byte
gather, a shift and a mask.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class FFDLayout(NamedTuple):
    bits: np.ndarray  # (D,) widths
    byte_idx: np.ndarray  # (D,) byte each dim lands in (-1 for width 0)
    shift: np.ndarray  # (D,) left-shift placing the field (MSB-first), -1 for width 0
    n_bytes: int


def ffd_layout(bits_per_dim: np.ndarray, byte_cap: int = 8) -> FFDLayout:
    b = np.asarray(bits_per_dim, dtype=np.int64)
    d_total = b.shape[0]
    if np.any(b < 0) or np.any(b > byte_cap):
        raise ValueError(f"bit widths must be in [0, {byte_cap}]")
    byte_idx = np.full(d_total, -1, dtype=np.int64)
    bit_off = np.full(d_total, -1, dtype=np.int64)

    order = sorted((d for d in range(d_total) if b[d] > 0), key=lambda d: (-b[d], d))
    # 4-fix: width-4 fields go after the width-3 fields (cap 8 only)
    if byte_cap == 8:
        fours = [d for d in order if b[d] == 4]
        if fours:
            rest = [d for d in order if b[d] != 4]
            ins = next((i for i, d in enumerate(rest) if b[d] <= 2), len(rest))
            order = rest[:ins] + fours + rest[ins:]

    remaining: list = []
    for d in order:
        w = int(b[d])
        placed = next((i for i, r in enumerate(remaining) if r >= w), -1)
        if placed < 0:
            placed = len(remaining)
            remaining.append(byte_cap)
        bit_off[d] = byte_cap - remaining[placed]
        byte_idx[d] = placed
        remaining[placed] -= w

    shift = np.where(b > 0, byte_cap - bit_off - b, -1)
    return FFDLayout(bits=b, byte_idx=byte_idx, shift=shift, n_bytes=len(remaining))


def _layout_tensors(layout: FFDLayout, device):
    """(byte index, shift, mask) per dim as int64 tensors; width-0 dims get
    byte 0, shift 0 and mask 0."""
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    return (t(np.maximum(layout.byte_idx, 0)), t(np.maximum(layout.shift, 0)),
            t(np.where(layout.bits > 0, (1 << layout.bits) - 1, 0)))


def ffd_encode(codes: torch.Tensor, layout: FFDLayout) -> torch.Tensor:
    """(N, D) int codes → (N, n_bytes) uint8: each field shifted into place
    and summed into its byte (the fields of a byte do not overlap)."""
    byte_idx, shift, mask = _layout_tensors(layout, codes.device)
    fields = (codes.to(torch.int64) & mask) << shift
    out = torch.zeros((codes.shape[0], max(layout.n_bytes, 1)), dtype=torch.int64,
                      device=codes.device)
    out.index_add_(1, byte_idx, fields)
    return out[:, :layout.n_bytes].to(torch.uint8)


def ffd_decode_codes(packed: torch.Tensor, layout: FFDLayout) -> torch.Tensor:
    """(N, n_bytes) uint8 → (N, D) int32 codes (0 where width 0)."""
    byte_idx, shift, mask = _layout_tensors(layout, packed.device)
    if layout.n_bytes == 0:
        return torch.zeros((packed.shape[0], len(layout.bits)), dtype=torch.int32,
                           device=packed.device)
    gathered = packed.to(torch.int64)[:, byte_idx]
    return ((gathered >> shift) & mask).to(torch.int32)


def dense_layout_cols(bits_per_dim: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Static column indices for DENSE (cross-byte) variable-width packing:
    per-dim absolute bit offsets, MSB-first.

    Returns (dim_of_bit, weight_exp, total_bits): for global bit position p,
    dim_of_bit[p] is the source dim and weight_exp[p] the bit significance
    within that dim's field.
    """
    b = np.asarray(bits_per_dim, dtype=np.int64)
    dims = np.repeat(np.arange(len(b), dtype=np.int64), b)
    starts = np.repeat(np.cumsum(b) - b, b)
    exps = np.repeat(b, b) - 1 - (np.arange(len(dims), dtype=np.int64) - starts)
    return dims, exps.astype(np.int64), len(dims)


def dense_encode(codes: torch.Tensor, bits_per_dim: np.ndarray) -> torch.Tensor:
    """(N, D) codes → (N, ceil(Σb/8)) uint8, a contiguous MSB-first bit
    stream (the reference's 'dense' packing)."""
    dims, exps, total = dense_layout_cols(bits_per_dim)
    dev = codes.device
    n = codes.shape[0]
    bitsv = ((codes.to(torch.int32)[:, torch.as_tensor(dims, device=dev)]
              >> torch.as_tensor(exps, dtype=torch.int32, device=dev)) & 1).to(torch.uint8)
    pad = (-total) % 8
    if pad:
        bitsv = torch.nn.functional.pad(bitsv, (0, pad))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=dev)
    # each byte's bit-weighted sum is < 256, so uint8 arithmetic is exact
    return (bitsv.reshape(n, -1, 8) * weights).sum(dim=-1, dtype=torch.uint8)


def dense_decode_codes(packed: torch.Tensor, bits_per_dim: np.ndarray) -> torch.Tensor:
    """Inverse of ``dense_encode`` → (N, D) int32: each bit, weighted by its
    significance, added into its dim (integer sums)."""
    b = np.asarray(bits_per_dim, dtype=np.int64)
    dims, exps, total = dense_layout_cols(b)
    dev = packed.device
    n = packed.shape[0]
    pos = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
    bitsv = ((packed[:, :, None] >> pos) & 1).reshape(n, -1)[:, :total]
    vals = bitsv.to(torch.int32) << torch.as_tensor(exps, dtype=torch.int32, device=dev)
    out = torch.zeros((n, len(b)), dtype=torch.int32, device=dev)
    return out.index_add_(1, torch.as_tensor(dims, device=dev), vals)
