"""Row subsampling for fits — counterpart of ``vq_tpu/data/sampling.py``.

A fit trains on at most ``cap`` rows, so it never needs the whole corpus on
the device: a tensor is sampled where it lives (on the card, without a host
round trip), numpy / np.memmap / array-like corpora on the host with the
same sorted ``default_rng(seed)`` draw as the JAX package, so both packages
train on the same rows of a host corpus.  ``chunked_min_max`` is the
per-dimension range that SQ fits, streamed; ``chunked_mean`` the centroid
that RaBitQ fits on a row source.
"""

from __future__ import annotations

import numpy as np
import torch

from vq_tpu_torch._device import as_f32, make_generator


def host_sample_rows(x, cap: int, seed: int = 0):
    """Return ≤cap rows of x as float32: a tensor for tensor input (sampled
    on its device); for any other row source (numpy, np.memmap, an object
    whose ``x[ids]`` gives rows) the same sorted numpy draw, kept as a
    tensor where the source hands back tensors and numpy otherwise (sorted
    indices keep mmap reads sequential)."""
    n = x.shape[0]
    if isinstance(x, torch.Tensor):
        if n <= cap:
            return x.to(torch.float32)
        idx = torch.randperm(n, generator=make_generator(seed, x.device),
                             device=x.device)[:cap]
        return x[torch.sort(idx).values].to(torch.float32)
    if n <= cap:
        rows = x[:]
    else:
        rng = np.random.default_rng(seed)
        rows = x[np.sort(rng.choice(n, cap, replace=False))]
    if isinstance(rows, torch.Tensor):
        return rows.to(torch.float32)
    return np.asarray(rows, dtype=np.float32)


def chunk_rows_for_bytes(dim: int, itemsize: int = 4,
                         budget_bytes: int = 1 << 28) -> int:
    """Rows per chunk so one host→device transfer stays ≤ budget (256 MB)."""
    return max(1024, budget_bytes // max(1, dim * itemsize))


def chunked_min_max(x, device, chunk_rows: int = 0):
    """Per-dimension (min, max) f32 tensors on ``device`` over a corpus of any
    size: a tensor reduces where it lives, a host corpus (numpy, np.memmap)
    streams onto the device in chunks of ≤ 256 MB."""
    if isinstance(x, torch.Tensor):
        xf = as_f32(x, device)
        return torch.amin(xf, dim=0), torch.amax(xf, dim=0)
    n, d = x.shape
    chunk_rows = chunk_rows or chunk_rows_for_bytes(d)
    lo = torch.full((d,), np.inf, dtype=torch.float32, device=device)
    hi = torch.full((d,), -np.inf, dtype=torch.float32, device=device)
    for start in range(0, n, chunk_rows):
        xc = as_f32(np.asarray(x[start:start + chunk_rows], dtype=np.float32), device)
        lo = torch.minimum(lo, torch.amin(xc, dim=0))
        hi = torch.maximum(hi, torch.amax(xc, dim=0))
    return lo, hi


def chunked_mean(x, device, chunk_rows: int = 0) -> torch.Tensor:
    """The (D,) f32 mean of every row of a row source (anything whose
    ``x[i0:i1]`` gives numpy or tensor rows), in one pass of ``chunk_rows``
    rows (default: 256 MB of f32) with one chunk on ``device`` at a time:
    each chunk's column sums in f64, added in row order, divided by n and
    rounded to f32 once."""
    n, d = x.shape
    chunk_rows = chunk_rows or chunk_rows_for_bytes(d)
    acc = torch.zeros((d,), dtype=torch.float64, device=device)
    for start in range(0, n, chunk_rows):
        acc += torch.sum(as_f32(x[start:start + chunk_rows], device).to(torch.float64), dim=0)
    return (acc / n).to(torch.float32)
