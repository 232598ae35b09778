"""Planted neighbourhoods at full rank, made on a device from a seed.

Frozen copy of ``fullrank`` in ``vq_tpu_torch/bench/corpora.py`` at commit
6e0cbc3 (itself ``bench.py:441-475`` of the JAX system): rows z·A with
z = centre + spread·N(0, I), A (rank, D) with column scale (1+i)^-0.5,
rows unit-normalized; ``csize``-row neighbourhoods (row i and i + n/csize
share a centre); queries are fresh variants of random centres.  The
benchmark keeps its own copy so that a later change to the program cannot
change the data it is measured on.  One change from the original: with
``basis_seed`` the mixing matrix A (the corpus's spectrum, which a
configuration fixes) comes from a generator of its own, and only the
centres, the rows and the queries from ``seed``.
"""

from __future__ import annotations

import torch


def make(n: int, d: int, nq: int, seed: int, device, rank=None, csize: int = 100,
         spread: float = 1.0, block: int = 65536, basis_seed=None):
    """→ (x (n, d), q (nq, d)) f32 unit rows on ``device``."""
    dev = torch.device(device)
    rank = rank or d
    g = torch.Generator(device=dev).manual_seed(int(seed))
    ga = g if basis_seed is None else torch.Generator(device=dev).manual_seed(int(basis_seed))
    kc = n // csize
    a = torch.randn((rank, d), generator=ga, device=dev)
    a = a * (1.0 + torch.arange(d, device=dev)) ** -0.5
    cents = torch.randn((kc, rank), generator=g, device=dev)
    x = torch.empty((n, d), device=dev)
    for i0 in range(0, n, block):
        rows = torch.arange(i0, min(n, i0 + block), device=dev)
        xb = (cents[rows % kc] + spread * torch.randn((rows.shape[0], rank), generator=g,
                                                      device=dev)) @ a
        x[i0:i0 + rows.shape[0]] = xb / torch.linalg.norm(xb, dim=1, keepdim=True)
    qdoc = torch.randint(0, kc, (nq,), generator=g, device=dev)
    qv = (cents[qdoc] + spread * torch.randn((nq, rank), generator=g, device=dev)) @ a
    return x, qv / torch.linalg.norm(qv, dim=1, keepdim=True)
