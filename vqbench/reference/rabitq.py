"""Plain Extended RaBitQ (a shared B-bit Gaussian level table) and its
packed layout at B ≤ 4.

Frozen copies, op for op, of the program's ``methods/rabitq.py`` (``fit``
with the row-source centroid of ``data/sampling.py::chunked_mean``,
``_encode_arrays``, ``_convert_rows``) and ``kernels/lloyd1d.py``
(``lloyd_1d_normal``), kept to what one flat L2 deployment uses.  The
words are ``reference/saq.py::pack_words``' tile order.  ``distances`` is
the unbiased estimator the flat scan ranks by, written plainly in the
original space's terms: with z = (q − c)·P,

    ‖q − x‖² ≈ ‖q − c‖² + ‖r‖² − 2·α·z·ŝ,   α = ‖r‖·√D / (t·‖ŝ‖²).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

ENCODE_CHUNK = 65536  # rows the program encodes at a time
PACK_CHUNK = 131072  # rows the program packs at a time
MEAN_BUDGET = 1 << 28  # bytes of f32 rows a centroid chunk holds
LLOYD_SAMPLES = 200_000
LLOYD_ITERS = 100


class Params(NamedTuple):
    centroid: torch.Tensor  # (D,)
    rotation: torch.Tensor  # (D, D), applied as v @ rotation
    levels: torch.Tensor  # (2^B,) sorted


def mean_chunk_rows(d: int) -> int:
    return max(1024, MEAN_BUDGET // (d * 4))


def chunk_sum(xb: torch.Tensor) -> torch.Tensor:
    """One chunk's column sums in f64."""
    return torch.sum(xb.to(torch.float64), dim=0)


def centroid(x, device, summed=chunk_sum) -> torch.Tensor:
    """The mean of every row of x, ``mean_chunk_rows`` rows at a time: the
    chunks' ``summed`` column sums added in row order in f64, over n,
    rounded to f32 once."""
    n, d = x.shape
    step = mean_chunk_rows(d)
    acc = torch.zeros((d,), dtype=torch.float64, device=device)
    for i0 in range(0, n, step):
        acc += summed(torch.as_tensor(x[i0:i0 + step]).to(device=device, dtype=torch.float32))
    return (acc / n).to(torch.float32)


def row_norms(xb: torch.Tensor) -> torch.Tensor:
    """The rows' f32 norms, in the index's norm chunks (``mean_chunk_rows``)."""
    step = mean_chunk_rows(xb.shape[1])
    return torch.cat([torch.linalg.norm(xb[i0:i0 + step], dim=1)
                      for i0 in range(0, xb.shape[0], step)])


def rotation(d: int, seed: int, device) -> torch.Tensor:
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((d, d)))
    return torch.from_numpy(q.astype(np.float32)).to(device)


def lloyd_levels(num_levels: int, seed: int, device) -> torch.Tensor:
    """Lloyd on a seeded N(0, 1) sample: quantile start, midpoint cuts on
    the sorted sample, bin means from prefix sums (in f64 on a card)."""
    g = torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    s = torch.sort(torch.randn((LLOYD_SAMPLES,), generator=g, device=device)).values
    s = s.reshape(1, -1).to(torch.float32).contiguous()
    n = s.shape[1]
    zero = torch.zeros((1, 1), dtype=torch.float32, device=s.device)
    csum = torch.cumsum(s.to(torch.float64), dim=1).to(torch.float32) if s.is_cuda else \
        torch.cumsum(s, dim=1)
    csum = torch.cat([zero, csum], dim=1)
    ranks = ((torch.arange(num_levels, dtype=torch.float32, device=s.device) + 0.5)
             / num_levels * n).to(torch.int64).clamp(0, n - 1)
    levels = s[:, ranks]
    first = torch.zeros((1, 1), dtype=torch.int64, device=s.device)
    last = torch.full((1, 1), n, dtype=torch.int64, device=s.device)
    for _ in range(LLOYD_ITERS):
        bounds = 0.5 * (levels[:, :-1] + levels[:, 1:])
        cut = torch.searchsorted(s, bounds.contiguous(), right=False)
        lo = torch.cat([first, cut], dim=1)
        hi = torch.cat([cut, last], dim=1)
        counts = (hi - lo).to(torch.float32)
        sums = torch.gather(csum, 1, hi) - torch.gather(csum, 1, lo)
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), levels)
        levels = torch.sort(new, dim=1).values
    return levels[0]


def fit(x, qcfg: dict, device, summed=chunk_sum) -> Params:
    d = x.shape[1]
    return Params(centroid(x, device, summed), rotation(d, qcfg["seed"], device),
                  lloyd_levels(1 << qcfg["num_bits"], qcfg["seed"], device))


def encode(params: Params, xb: torch.Tensor):
    """Rows → (idx (n, D) int32 nearest levels, ‖r‖ (n,), t (n,)),
    ``ENCODE_CHUNK`` rows at a time."""
    d = xb.shape[1]
    out = []
    for i0 in range(0, xb.shape[0], ENCODE_CHUNK):
        r = xb[i0:i0 + ENCODE_CHUNK] - params.centroid
        nrm = torch.linalg.norm(r, dim=1)
        o = r / torch.clamp(nrm, min=1e-12)[:, None]
        s = (o @ params.rotation) * math.sqrt(d)
        bounds = (0.5 * (params.levels[:-1] + params.levels[1:])).contiguous()
        idx = torch.searchsorted(bounds, s.contiguous(), right=False).to(torch.int32)
        s_hat = params.levels[idx.long()]
        num = torch.sum(s * s_hat, dim=1)
        den = torch.sum(s_hat * s_hat, dim=1)
        t = torch.where(den > 1e-12, num / den, torch.ones_like(den))
        out.append((idx, nrm, t))
    return tuple(torch.cat(parts) for parts in zip(*out))


def scale_shift(params: Params, idx: torch.Tensor, nrm: torch.Tensor, t: torch.Tensor):
    """→ (ŝ (n, D), α (n,), the L2 shift c2 = 2α·ŝ·(cP) + ‖r‖² (n,))."""
    d = idx.shape[1]
    s_hat = params.levels[idx.long()]
    snorm_sq = torch.sum(s_hat * s_hat, dim=1)
    alpha = nrm * math.sqrt(d) / torch.clamp(t * snorm_sq, min=1e-12)
    c2 = 2.0 * alpha * (s_hat @ (params.centroid @ params.rotation)) + nrm * nrm
    return s_hat, alpha, c2


def distances(params: Params, q: torch.Tensor, s_hat, alpha, nrm, fp8=None) -> torch.Tensor:
    """(P, n) estimator distances of the queries q to rows (ŝ, α, ‖r‖);
    ``fp8`` rounds the product's operands (the control's scan)."""
    qc = q - params.centroid
    z = qc @ params.rotation
    if fp8 is not None:
        z, s_hat = fp8(z), fp8(s_hat)
    return (torch.sum(qc * qc, dim=1)[:, None] + (nrm * nrm)[None, :]
            - 2.0 * alpha[None, :] * (z @ s_hat.T))
