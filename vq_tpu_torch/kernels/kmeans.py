"""Batched Lloyd k-means — counterpart of ``vq_tpu/kernels/kmeans.py``.

Assignment is a matmul-argmin (‖x‖² − 2x·c + ‖c‖²); the update sums each
cluster's rows in a fixed order (a stable sort by assignment, then segment
sums), so a seed gives the same centroids bit for bit on every run, on the
card too (float atomics, as ``scatter_add_`` uses there, would not).
Every function takes a leading batch dimension written out (the JAX
package's ``vmap``): (B, n, d) data and (B, k, d) centroids, so all M PQ
subquantizers train in one set of batched ops.
k-means++ seeding samples the D² distribution with the Gumbel-max trick,
one Python loop step per centroid (the JAX package's ``lax.scan``).

Random numbers come from a ``torch.Generator`` on the data's device; they
differ from ``jax.random``'s, so the tests compare k-means quality, or feed
both packages the same start centroids through ``c0``.
"""

from __future__ import annotations

from typing import Optional

import torch

from vq_tpu_torch.core.config import KMeansConfig
from vq_tpu_torch._device import make_generator

_TILE_ELEMS = 1 << 27  # (rows × k × batch) above this, Lloyd tiles over rows


def pairwise_sqdist_xc(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances (…, n, d) × (…, k, d) → (…, n, k)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    return x2 - 2.0 * (x @ c.transpose(-1, -2)) + c2.unsqueeze(-2)


def _kmeanspp_init(gen: torch.Generator, x: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding, (B, n, d) → (B, k, d), via Gumbel-max sampling of
    the D² distribution."""
    b, n, _ = x.shape
    batch = torch.arange(b, device=x.device)
    first = torch.randint(0, n, (b,), generator=gen, device=x.device)
    cents = [x[batch, first]]
    min_d2 = torch.full((b, n), float("inf"), device=x.device)
    for _ in range(k - 1):
        d2 = torch.sum((x - cents[-1][:, None, :]) ** 2, dim=-1)
        min_d2 = torch.minimum(min_d2, d2)
        u = torch.rand((b, n), generator=gen, device=x.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        logits = torch.where(min_d2 > 0, torch.log(min_d2 + 1e-30),
                             torch.full_like(min_d2, -float("inf"))) + gumbel
        cents.append(x[batch, torch.argmax(logits, dim=-1)])
    return torch.stack(cents, dim=1)


def _random_init(gen: torch.Generator, x: torch.Tensor, k: int) -> torch.Tensor:
    """k distinct rows per problem: (B, n, d) → (B, k, d)."""
    b, n, _ = x.shape
    idx = torch.stack([torch.randperm(n, generator=gen, device=x.device)[:k]
                       for _ in range(b)])
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def lloyd_partials(x: torch.Tensor, centroids: torch.Tensor):
    """The sums of one Lloyd iteration, (B, n, d) × (B, k, d) → ((B·k, d)
    f32 per-cluster row sums, (B·k,) int64 counts), in a fixed order.

    Above B·n·k = 2²⁷ the rows are tiled, so the (B, n, k) distance matrix
    never exists whole; partial sums and counts accumulate across row
    tiles, in tile order.  Inside a tile the rows are stably sorted by
    (problem, cluster) and each cluster's run is summed by
    ``torch.segment_reduce``, whose order is fixed (one thread a sum on the
    card, no atomics): the sums are deterministic, where the JAX package's
    one-hot product is too.
    """
    b, n, d = x.shape
    k = centroids.shape[1]
    sums = torch.zeros((b * k, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros((b * k,), dtype=torch.int64, device=x.device)
    offset = (torch.arange(b, device=x.device) * k)[:, None]
    row_tile = n if b * n * k <= _TILE_ELEMS else max(1024, _TILE_ELEMS // (b * k))
    for start in range(0, n, row_tile):
        xt = x[:, start:start + row_tile]
        a = torch.argmin(pairwise_sqdist_xc(xt, centroids), dim=-1)  # (B, t)
        key = (a + offset).reshape(-1)
        order = torch.sort(key, stable=True).indices
        lengths = torch.bincount(key, minlength=b * k)
        sums += torch.segment_reduce(xt.reshape(-1, d)[order], "sum", lengths=lengths,
                                     axis=0, unsafe=True, initial=0.0)
        counts += lengths
    return sums, counts


def lloyd_update(sums: torch.Tensor, counts: torch.Tensor,
                 centroids: torch.Tensor) -> torch.Tensor:
    """New (B, k, d) centroids from ``lloyd_partials``' sums and counts; an
    empty cluster keeps its previous centroid."""
    b, k, d = centroids.shape
    counts = counts.reshape(b, k).to(torch.float32)
    new_c = sums.reshape(b, k, d) / torch.clamp(counts, min=1.0)[..., None]
    return torch.where((counts > 0)[..., None], new_c, centroids)


def _lloyd_iter(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration, (B, n, d) × (B, k, d) → (B, k, d); 2-D inputs
    are one problem.  Deterministic: the sums of ``lloyd_partials``."""
    if x.dim() == 2:
        return _lloyd_iter(x[None], centroids[None])[0]
    return lloyd_update(*lloyd_partials(x, centroids), centroids)


def _kmeans_impl(gen: torch.Generator, x: torch.Tensor, k: int, cfg: KMeansConfig,
                 c0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Seed (unless ``c0`` is given) and run ``cfg.iters`` Lloyd steps on
    (B, n, d) → (B, k, d)."""
    x = x.to(torch.float32)
    if c0 is None:
        # "auto": k-means++ reads the training set once per centroid, so
        # beyond 1024 centroids random-row init (faiss's default) is used
        init = cfg.init
        if init == "auto":
            init = "kmeanspp" if k <= 1024 else "random"
        c0 = _kmeanspp_init(gen, x, k) if init == "kmeanspp" else _random_init(gen, x, k)
    c = c0.to(device=x.device, dtype=torch.float32)
    for _ in range(cfg.iters):
        c = _lloyd_iter(x, c)
    return c


def _subsample(gen: torch.Generator, x: torch.Tensor, cap: int) -> torch.Tensor:
    """At most ``cap`` rows along dim −2, drawn without replacement."""
    n = x.shape[-2]
    if n <= cap:
        return x
    idx = torch.randperm(n, generator=gen, device=x.device)[:cap]
    return x[..., idx, :]


def kmeans(gen: Optional[torch.Generator], x: torch.Tensor, k: int,
           cfg: KMeansConfig = KMeansConfig(),
           c0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Train k centroids on (n, d) data → (k, d) f32.

    Training data is subsampled to ``max_points_per_centroid · k`` rows,
    faiss-style, so fit cost is independent of corpus size.
    """
    if gen is None:
        gen = make_generator(cfg.seed, x.device)
    xs = _subsample(gen, x, cfg.max_points_per_centroid * k)
    return _kmeans_impl(gen, xs[None], k, cfg, None if c0 is None else c0[None])[0]


def kmeans_batched(gen: torch.Generator, xs: torch.Tensor, k: int,
                   cfg: KMeansConfig = KMeansConfig(),
                   c0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Train M independent k-means problems at once: (M, n, d) → (M, k, d).

    All problems share one row subsample (as in the JAX package)."""
    xs = _subsample(gen, xs, cfg.max_points_per_centroid * k)
    return _kmeans_impl(gen, xs, k, cfg, c0)


def assign(x: torch.Tensor, centroids: torch.Tensor, tile: int = 16384) -> torch.Tensor:
    """Nearest-centroid ids, (n, d) × (k, d) → (n,) int32, tiled over rows so
    the distance matrix is at most (tile, k)."""
    return assign_batched(x[None], centroids[None], tile)[0]


def assign_batched(xs: torch.Tensor, centroids: torch.Tensor,
                   tile: int = 16384) -> torch.Tensor:
    """(M, n, d) × (M, k, d) → (M, n) int32 — all PQ subspaces at once."""
    out = torch.empty(xs.shape[:2], dtype=torch.int32, device=xs.device)
    c = centroids.to(torch.float32)
    for start in range(0, xs.shape[1], tile):
        xt = xs[:, start:start + tile].to(torch.float32)
        out[:, start:start + tile] = torch.argmin(pairwise_sqdist_xc(xt, c), dim=-1)
    return out
