"""The seeded synthetic corpora of the JAX system's ``bench.py``, made on a
device with an explicit ``torch.Generator`` — one definition each, shared
by ``bench/headline.py``, ``bench/scan53m.py`` and ``chip_smoke.py``.

Each maker takes (n, d, nq, seed, device) and returns (x (n, d), q (nq, d))
f32 tensors on ``device`` (default: the card; ``device="cpu"`` must be asked
for), plus σ where a caller jitters more rows with it.  The numbers differ
from the JAX package's for the same seed (the PRNGs differ); the shapes,
spectra and neighbourhood structure are ``bench.py``'s:

    powerlaw       bench.py:79-100   σ_i = (1+i)^-0.75, queries = rows + 0.25σ·N(0, 1)
    planted        bench.py:196-215  rank-32 manifold, 10-row neighbourhoods, unit rows
    packed_corpus  bench.py:254-275  σ_i = (1+i)^-0.6, queries = rows + 0.1σ·N(0, 1);
                   (:316-341 with ``lognormal``: rows times exp(0.5·N(0, 1)))
    fullrank       bench.py:441-475  planted neighbourhoods at full rank, csize 100
"""

from __future__ import annotations

import torch

from vq_tpu_torch._device import make_generator, resolve_device
from vq_tpu_torch.data.datasets import planted_arrays


def powerlaw_sigma(d: int, power: float, device) -> torch.Tensor:
    """(d,) f32 column scales σ_i = (1+i)^-power."""
    return (1.0 + torch.arange(d, device=device, dtype=torch.float32)) ** -power


def powerlaw(n: int, d: int, nq: int, seed: int, device=None):
    """The headline corpus: rows N(0, diag σ²) with σ_i = (1+i)^-0.75;
    queries are corpus rows jittered by 0.25σ."""
    dev = resolve_device(device)
    g = make_generator(seed, dev)
    sigma = powerlaw_sigma(d, 0.75, dev)
    x = torch.randn((n, d), generator=g, device=dev).mul_(sigma)
    qidx = torch.randint(0, n, (nq,), generator=g, device=dev)
    q = x[qidx] + 0.25 * sigma * torch.randn((nq, d), generator=g, device=dev)
    return x, q


def planted(n: int, d: int, nq: int, seed: int, device=None, rank: int = 32, csize: int = 10,
            spread: float = 0.5):
    """The gate corpus: a rank-32 manifold in D with ``csize``-row
    near-duplicate neighbourhoods (row i and i + n/csize share a centre),
    unit-normalized rows; queries are fresh variants of random centres
    (the port's ``planted-NxD``, ``data/datasets.py::planted_arrays``)."""
    return planted_arrays(n, d, nq, rank, csize, spread, seed, resolve_device(device))


def packed_corpus(n: int, d: int, nq: int, seed: int, device=None, lognormal: bool = False):
    """The packed sections' corpus: rows N(0, diag σ²), σ_i = (1+i)^-0.6,
    optionally times a lognormal row scale exp(0.5·N(0, 1)) (the banded
    prune corpus); queries are corpus rows jittered by 0.1σ.  Returns
    (x, q, σ)."""
    dev = resolve_device(device)
    g = make_generator(seed, dev)
    sigma = powerlaw_sigma(d, 0.6, dev)
    x = torch.randn((n, d), generator=g, device=dev).mul_(sigma)
    if lognormal:
        x.mul_(torch.exp(0.5 * torch.randn((n, 1), generator=g, device=dev)))
    qidx = torch.randint(0, n, (nq,), generator=g, device=dev)
    q = x[qidx] + 0.1 * sigma * torch.randn((nq, d), generator=g, device=dev)
    return x, q, sigma


def fullrank(n: int, d: int, nq: int, seed: int, device=None, rank=None, csize: int = 100,
             spread: float = 1.0, block: int = 65536):
    """The IVF corpus: planted neighbourhoods at full rank, rows z·A with
    z = centre + spread·N(0, I), A (rank, D) with column scale (1+i)^-0.5,
    unit-normalized; made block by block so the latent z of the whole
    corpus never coexists with x."""
    dev = resolve_device(device)
    rank = rank or d
    g = make_generator(seed, dev)
    kc = n // csize
    a = torch.randn((rank, d), generator=g, device=dev)
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
