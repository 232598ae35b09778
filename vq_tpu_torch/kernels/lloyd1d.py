"""1-D scalar codebook builders (Lloyd on sorted samples) — counterpart of
``vq_tpu/kernels/lloyd1d.py``.

With SORTED samples and sorted levels, Lloyd assignment boundaries are
midpoints, so per-bin sums and counts are differences of prefix sums at
``searchsorted`` cut points (in f64 on a card, where CUDA's f32 scan is
not reproducible).  Every column of a batch trains at once (the JAX
package's ``vmap``), as one batched ``torch.searchsorted``.  Cut points
use side ``left`` (``right=False``), as ``jnp.searchsorted`` does.
"""

from __future__ import annotations

import torch

from vq_tpu_torch._device import make_generator, resolve_device


def _lloyd_sorted_batched(s: torch.Tensor, num_levels: int, iters: int) -> torch.Tensor:
    """(C, n) rows of sorted samples → (C, L) sorted levels per row."""
    s = s.to(torch.float32).contiguous()
    c, n = s.shape
    zero = torch.zeros((c, 1), dtype=torch.float32, device=s.device)
    # on a card the prefix sums run in f64 and are rounded to f32 once:
    # CUDA's f32 scan of one long row adds its blocks in the order they
    # finish, so its last bits, and the levels', change from run to run
    csum = torch.cumsum(s.to(torch.float64), dim=1).to(torch.float32) if s.is_cuda else \
        torch.cumsum(s, dim=1)
    csum = torch.cat([zero, csum], dim=1)
    # quantile init: value at rank (j + .5)/L, computed in f32 as JAX does
    ranks = ((torch.arange(num_levels, dtype=torch.float32, device=s.device) + 0.5)
             / num_levels * n).to(torch.int64).clamp(0, n - 1)
    levels = s[:, ranks]
    first = torch.zeros((c, 1), dtype=torch.int64, device=s.device)
    last = torch.full((c, 1), n, dtype=torch.int64, device=s.device)
    for _ in range(iters):
        bounds = 0.5 * (levels[:, :-1] + levels[:, 1:])
        cut = torch.searchsorted(s, bounds.contiguous(), right=False)  # #samples < bound
        lo = torch.cat([first, cut], dim=1)
        hi = torch.cat([cut, last], dim=1)
        counts = (hi - lo).to(torch.float32)
        sums = torch.gather(csum, 1, hi) - torch.gather(csum, 1, lo)
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), levels)
        levels = torch.sort(new, dim=1).values
    return levels


def lloyd_1d_sorted(sorted_samples: torch.Tensor, num_levels: int,
                    iters: int = 60) -> torch.Tensor:
    """Lloyd-optimal scalar codebook for one column of SORTED samples →
    sorted (num_levels,) f32 levels (deterministic quantile init)."""
    return _lloyd_sorted_batched(sorted_samples.reshape(1, -1), num_levels, iters)[0]


def lloyd_1d(samples: torch.Tensor, num_levels: int, iters: int = 60) -> torch.Tensor:
    """Lloyd codebook for one unsorted sample column."""
    return lloyd_1d_sorted(torch.sort(samples.reshape(-1)).values, num_levels, iters)


def lloyd_1d_normal(num_levels: int, seed: int = 0, n_samples: int = 200_000,
                    iters: int = 100, device=None) -> torch.Tensor:
    """Gaussian-optimal scalar codebook: Lloyd on a seeded N(0,1) sample
    drawn from a ``torch.Generator`` (so its sample differs from JAX's), on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    g = make_generator(seed, dev)
    samples = torch.randn((n_samples,), generator=g, device=dev)
    return lloyd_1d(samples, num_levels, iters)


def lloyd_1d_columns(x: torch.Tensor, num_levels: int, iters: int = 60) -> torch.Tensor:
    """Per-dimension codebooks for all columns at once: (n, D) → (D, L)."""
    return _lloyd_sorted_batched(torch.sort(x, dim=0).values.T, num_levels, iters)


def quantize_to_levels(x: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Nearest-level index via midpoint boundaries (levels sorted):
    x (...,), levels (L,) → int32 indices (...,)."""
    bounds = (0.5 * (levels[:-1] + levels[1:])).contiguous()
    return torch.searchsorted(bounds, x.contiguous(), right=False).to(torch.int32)


def quantize_to_levels_per_dim(x: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Per-dimension codebooks: x (n, D), levels (D, L) → (n, D) int32."""
    bounds = (0.5 * (levels[:, :-1] + levels[:, 1:])).contiguous()  # (D, L-1)
    return torch.searchsorted(bounds, x.T.contiguous(), right=False).T.to(torch.int32)
