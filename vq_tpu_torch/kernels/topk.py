"""Exact top-k in ``lax.top_k``'s order: score descending, then id ascending.

``torch.topk`` does not promise which of several equal scores it returns, so
the order is made explicit: each (score, id) pair is packed into one int64
key whose integer order is that total order, and ``torch.topk`` runs on the
keys, which are unique.  The float → int map is the usual order-preserving
one (flip the magnitude bits of negative values).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_LOW31 = 0x7FFFFFFF
_ID_BASE = (1 << 31) - 1


def _ordered_int(bits: torch.Tensor) -> torch.Tensor:
    """int32 float bits (as int64) ↔ integers with the floats' order.  The
    map is its own inverse."""
    return torch.where(bits < 0, bits ^ _LOW31, bits)


def ordered_topk(
    scores: torch.Tensor, k: int, ids: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row of ``scores`` (Q, n) f32 → ((Q, k) f32, (Q, k) i32).

    ``ids`` (Q, n) or (n,) gives each column's id (default: its position),
    all in [0, 2³¹).  Requires k ≤ n.
    """
    q, n = scores.shape
    if ids is None:
        ids = torch.arange(n, device=scores.device, dtype=torch.int64)
    ids = ids.to(torch.int64).expand(q, n)
    bits = scores.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    key = (_ordered_int(bits) << 32) + (_ID_BASE - ids)
    top = torch.topk(key, k, dim=-1).values
    out_ids = (_ID_BASE - (top & 0xFFFFFFFF)).to(torch.int32)
    out_s = _ordered_int(top >> 32).to(torch.int32).view(torch.float32)
    return out_s, out_ids
