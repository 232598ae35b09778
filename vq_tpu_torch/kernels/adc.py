"""ADC (asymmetric distance) scan + streaming top-k — counterpart of
``vq_tpu/kernels/adc.py``.

The identity the JAX package builds on holds here too: the ADC scan over
PQ codes is the exact scan over their reconstructions,
adc_l2(q, codes) = ‖q − x̂‖², x̂ = decode(codes).  Scores are kept in
maximize form (2·q·x̂ − ‖x̂‖² for L2, q·x̂ for IP, q·x̂/‖x‖ for NIP;
``maximize_scores``, which every plain scan of the port scores with) and
turned back into the metric's value by ``_finalize``.

Routing of ``scan_codes_topk``: a CUDA tensor with K ≤ 256 (uint8 codes)
and metric L2 or IP goes to the hand-written kernels of
``kernels/pq_scan.py`` — k ≤ 128 to the fused scan + top-k, k > 128 to the
score kernel over row tiles followed by ``_streaming_topk``.  (The JAX
package sends k > 32 to its score kernel because its TPU fold is linear in
k; on the card the fused kernel is the faster route at k=100, PERF.md.)
Everything else (NIP, the CPU) runs the plain PyTorch scan below.

Every top-k here is exact and ordered by score descending, then id
ascending (``lax.top_k``'s order; see ``kernels/topk.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch.core.config import Metric
from vq_tpu_torch._device import as_f32, bf16_supported, device_of, round_bf16, to_device
from vq_tpu_torch.kernels.pq_scan import (  # noqa: F401  (decode_pq: public here too)
    MAX_K,
    decode_pq,
    pq_scan_topk_fused,
    pq_score_all,
)
from vq_tpu_torch.kernels.topk import ordered_topk


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, d) × (m, d) → (n, m) squared L2, via the matmul expansion."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1)
    return a2 - 2.0 * (a @ b.T) + b2[None, :]


def build_lut(codebooks: torch.Tensor, queries: torch.Tensor,
              metric: Metric = Metric.L2) -> torch.Tensor:
    """Per-query distance tables: (M, K, dsub) × (Q, D) → (Q, M, K)."""
    m, _, dsub = codebooks.shape
    q = queries.reshape(queries.shape[0], m, dsub).to(torch.float32)
    ip = torch.einsum("qmd,mkd->qmk", q, codebooks)
    if metric == Metric.L2:
        q2 = torch.sum(q * q, dim=-1, keepdim=True)
        c2 = torch.sum(codebooks * codebooks, dim=-1)
        return q2 - 2.0 * ip + c2[None, :, :]
    return ip


def _streaming_topk(
    score_tile_fn: Callable[[int], torch.Tensor],
    n: int,
    num_queries: int,
    k: int,
    tile: int,
    approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold per-tile scores (maximize) into a running (Q, k) top-k.

    ``score_tile_fn(start)`` returns (Q, w) f32 scores of rows start … start+w
    (w ≤ tile), with out-of-range columns already −inf.  Exact, in
    ``lax.top_k``'s order.

    ``approx`` is the JAX package's flag for ``lax.approx_max_k`` (recall
    target 0.99) on tiles ≥ 512 wide, which exists because the TPU's exact
    top-k is a full sort and its partial reduction is ~2× faster there.  Off
    the TPU that call returns ``lax.top_k``'s result, and the per-tile
    selection here stays the exact ``ordered_topk`` whatever the flag says:
    it meets the 0.99 recall target by construction and equals what the JAX
    package computes on the CPU.
    """
    del approx  # exact selection meets the approximate one's recall target
    k = min(k, n)
    best_s = best_i = None
    for start in range(0, n, tile):
        s = score_tile_fn(start)
        w = s.shape[1]
        ids = torch.arange(start, start + w, device=s.device)
        ts, ti = ordered_topk(s, min(k, w), ids)
        if best_s is not None:
            ts, ti = ordered_topk(torch.cat([best_s, ts], dim=1),
                                  min(k, best_s.shape[1] + ts.shape[1]),
                                  torch.cat([best_i, ti], dim=1))
        best_s, best_i = ts, ti
    return best_s, best_i


def _finalize(scores, idx, metric: Metric, q_sq: Optional[torch.Tensor]):
    """Convert internal maximize-scores back to the metric's natural value."""
    if metric == Metric.L2:
        return q_sq[:, None] - scores, idx  # ‖q‖² − (2·ip − ‖x̂‖²)
    return scores, idx


def maximize_scores(ip: torch.Tensor, x_sq: Callable[[], torch.Tensor], metric: Metric,
                    row_norms: Callable[[], torch.Tensor]) -> torch.Tensor:
    """q·x̂ → the metric's maximize form: 2·ip − ‖x̂‖² (L2), ip (IP),
    ip / ‖x‖ (NIP).  ``x_sq`` and ``row_norms`` give ‖x̂‖² and the original
    row norms, in ip's shape or its last axis's; each is called only by the
    metric that reads it."""
    if metric == Metric.L2:
        return 2.0 * ip - x_sq()
    if metric == Metric.IP:
        return ip
    return ip / torch.clamp(row_norms(), min=1e-30)


def _col_mask(s: torch.Tensor, start: int, limit: int) -> torch.Tensor:
    col = start + torch.arange(s.shape[1], device=s.device)
    return torch.where(col[None, :] < limit, s, torch.full_like(s, -math.inf))


def _nip_norms(norms, n: int, device) -> torch.Tensor:
    if norms is None:
        raise ValueError("Metric.NIP requires original row norms")
    return as_f32(norms, device)[:n]


def _score_kernel_topk(queries, codes, codebooks, k: int, l2: bool, use_bf16: bool,
                       limit: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-pass route on the card: the score kernel over row tiles, then
    ``_streaming_topk`` → maximize-form (Q, k) scores and ids.  One big tile
    while the (Q, tile) f32 score buffer stays ≤ 1.5 GB: a single top-k over
    all columns beats per-tile merges."""
    n, num_q = codes.shape[0], queries.shape[0]
    cap = max(16384, (int(1.5e9) // (4 * num_q)) // 512 * 512)
    tile = min(-(-n // 512) * 512, cap)

    def score_tile(start):
        ct = codes[start:start + tile].contiguous()
        s = pq_score_all(queries, ct, codebooks, l2=l2, use_bf16=use_bf16)
        return _col_mask(s, start, limit)

    return _streaming_topk(score_tile, n, num_q, k, tile)


def scan_codes_topk(
    queries,
    codes: torch.Tensor,
    codebooks: torch.Tensor,
    k: int,
    metric: Metric = Metric.L2,
    norms=None,
    tile_rows: int = 16384,
    use_bf16: bool = True,
    num_valid: Optional[int] = None,
    approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ADC scan over a PQ-coded corpus with streaming top-k.

    queries (Q, D) f32; codes (N, M) integer PQ codes; codebooks
    (M, K, dsub) f32; norms (N,) original ‖x‖, required for Metric.NIP;
    num_valid masks rows with id ≥ num_valid; ``approx`` goes to the plain
    route's ``_streaming_topk`` (the kernels' routes keep an exact top-k).
    Returns (scores (Q, k), ids (Q, k) i32): squared L2 distances for L2
    (ascending), inner products otherwise (descending).
    """
    dev = codes.device
    n = codes.shape[0]
    num_q = queries.shape[0]
    kk = codebooks.shape[1]
    k = min(k, n)
    use_bf16 = use_bf16 and bf16_supported(dev)
    queries = as_f32(queries, dev).contiguous()
    codebooks = codebooks.to(torch.float32).contiguous()
    q_sq = torch.sum(queries * queries, dim=-1)
    limit = n if num_valid is None else min(n, int(num_valid))

    use_kernel = (dev.type == "cuda" and metric in (Metric.L2, Metric.IP)
                  and codes.dtype == torch.uint8 and kk <= 256)
    l2 = metric == Metric.L2
    if use_kernel and k <= MAX_K:  # else the two-pass score kernel
        outs, outi = pq_scan_topk_fused(queries, codes.contiguous(), codebooks, k, l2=l2,
                                        limit=limit, use_bf16=use_bf16)
        return _finalize(outs, outi, metric, q_sq)

    if use_kernel:
        scores, idx = _score_kernel_topk(queries, codes, codebooks, k, l2, use_bf16, limit)
        return _finalize(scores, idx, metric, q_sq)

    tile = min(tile_rows, max(1, n))
    qd, cb = (round_bf16(queries), round_bf16(codebooks)) if use_bf16 else (queries, codebooks)
    norms_t = _nip_norms(norms, n, dev) if metric == Metric.NIP else None

    def score_tile(start):
        dec = decode_pq(cb, codes[start:start + tile])
        s = maximize_scores(qd @ dec.T, lambda: torch.sum(dec * dec, dim=-1), metric,
                            lambda: norms_t[start:start + dec.shape[0]])
        return _col_mask(s, start, limit)

    scores, idx = _streaming_topk(score_tile, n, num_q, k, tile, approx=approx)
    return _finalize(scores, idx, metric, q_sq)


def scan_generic_topk(
    queries,
    codes: torch.Tensor,
    decode_fn: Callable[[torch.Tensor], torch.Tensor],
    k: int,
    metric: Metric = Metric.L2,
    norms=None,
    tile_rows: int = 16384,
    use_bf16: bool = True,
    num_valid: Optional[int] = None,
    approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode→score→top-k scan for any quantizer: ``decode_fn(codes_tile)
    → (T, D)``.  The generic path behind FlatQuantizedIndex for non-PQ
    methods; PQ uses ``scan_codes_topk``."""
    dev = codes.device
    n = codes.shape[0]
    num_q = queries.shape[0]
    tile = min(tile_rows, max(1, n))
    use_bf16 = use_bf16 and bf16_supported(dev)
    queries = as_f32(queries, dev)
    q_sq = torch.sum(queries * queries, dim=-1)
    qd = round_bf16(queries) if use_bf16 else queries
    limit = n if num_valid is None else min(n, int(num_valid))
    norms_t = _nip_norms(norms, n, dev) if metric == Metric.NIP else None

    def score_tile(start):
        dec = decode_fn(codes[start:start + tile]).to(torch.float32)
        s = maximize_scores(qd @ (round_bf16(dec) if use_bf16 else dec).T,
                            lambda: torch.sum(dec * dec, dim=-1), metric,
                            lambda: norms_t[start:start + dec.shape[0]])
        return _col_mask(s, start, limit)

    scores, idx = _streaming_topk(score_tile, n, num_q, k, tile, approx=approx)
    return _finalize(scores, idx, metric, q_sq)


def exact_topk(
    queries,
    x,
    k: int,
    metric: Metric = Metric.L2,
    norms=None,
    tile_rows: int = 8192,
    num_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact brute-force top-k over raw (or reconstructed) vectors, in f32
    (TF32 is off, see ``_device``).  Runs where a tensor ``x`` lives; numpy
    ``x`` goes to the card (``_device.device_of``), so without one it
    raises.  Used for ground truth."""
    dev = device_of(x)
    if isinstance(x, np.ndarray):
        x = to_device(torch.from_numpy(np.ascontiguousarray(x)), dev)
    n = x.shape[0]
    num_q = queries.shape[0]
    tile = min(tile_rows, max(1, n))
    queries = as_f32(queries, dev)
    q_sq = torch.sum(queries * queries, dim=-1)
    limit = n if num_valid is None else min(n, int(num_valid))
    norms_t = None
    if metric == Metric.NIP:
        norms_t = (torch.linalg.norm(x.to(torch.float32), dim=-1) if norms is None
                   else as_f32(norms, dev))

    # No pad copy: the last tile's start is clamped in-bounds so every tile
    # has `tile` rows (a padded f32 corpus would be a 6 GB transient at
    # N=1M, D=1536); the rows it re-reads from the previous tile are dropped
    def score_tile(start):
        st = min(start, n - tile)
        xt = x[st:st + tile].to(torch.float32)
        s = maximize_scores(queries @ xt.T, lambda: torch.sum(xt * xt, dim=-1), metric,
                            lambda: norms_t[st:st + tile])
        return _col_mask(s[:, start - st:], start, limit)

    scores, idx = _streaming_topk(score_tile, n, num_q, k, tile)
    return _finalize(scores, idx, metric, q_sq)
