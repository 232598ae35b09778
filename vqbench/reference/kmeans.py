"""Plain batched Lloyd k-means, the row sampler and nearest-centroid
assignment.

Frozen copies of ``vq_tpu_torch/kernels/kmeans.py`` and the tensor branch
of ``vq_tpu_torch/data/sampling.py::host_sample_rows`` at commit 6e0cbc3,
op for op, so that the same inputs and seeds give the program's fit again
(the program's update sums each cluster in a fixed order, so its fits are
bit-equal from run to run).  Nothing here imports the program.
"""

from __future__ import annotations

import torch

_TILE_ELEMS = 1 << 27


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def sample_rows(x: torch.Tensor, cap: int, seed: int) -> torch.Tensor:
    """≤ cap rows of a tensor, drawn on its device, in ascending order."""
    n = x.shape[0]
    if n <= cap:
        return x.to(torch.float32)
    idx = torch.randperm(n, generator=generator(seed, x.device), device=x.device)[:cap]
    return x[torch.sort(idx).values].to(torch.float32)


def sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(…, n, d) × (…, k, d) → (…, n, k) squared distances."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    return x2 - 2.0 * (x @ c.transpose(-1, -2)) + c2.unsqueeze(-2)


def _kmeanspp_init(gen, x, k):
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


def _random_init(gen, x, k):
    b, n, _ = x.shape
    idx = torch.stack([torch.randperm(n, generator=gen, device=x.device)[:k]
                       for _ in range(b)])
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def _lloyd_iter(x, centroids):
    b, n, d = x.shape
    k = centroids.shape[1]
    sums = torch.zeros((b * k, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros((b * k,), dtype=torch.int64, device=x.device)
    offset = (torch.arange(b, device=x.device) * k)[:, None]
    row_tile = n if b * n * k <= _TILE_ELEMS else max(1024, _TILE_ELEMS // (b * k))
    for start in range(0, n, row_tile):
        xt = x[:, start:start + row_tile]
        a = torch.argmin(sqdist(xt, centroids), dim=-1)
        key = (a + offset).reshape(-1)
        order = torch.sort(key, stable=True).indices
        lengths = torch.bincount(key, minlength=b * k)
        sums += torch.segment_reduce(xt.reshape(-1, d)[order], "sum", lengths=lengths,
                                     axis=0, unsafe=True, initial=0.0)
        counts += lengths
    cnt = counts.reshape(b, k).to(torch.float32)
    new_c = sums.reshape(b, k, d) / torch.clamp(cnt, min=1.0)[..., None]
    return torch.where((cnt > 0)[..., None], new_c, centroids)


def kmeans_batched(gen, xs: torch.Tensor, k: int, iters: int, max_points_per_centroid: int,
                   init: str = "auto") -> torch.Tensor:
    """(B, n, d) → (B, k, d): subsample to max_points_per_centroid·k rows,
    seed (k-means++ up to 1024 centroids, random rows beyond), Lloyd."""
    n = xs.shape[-2]
    cap = max_points_per_centroid * k
    if n > cap:
        idx = torch.randperm(n, generator=gen, device=xs.device)[:cap]
        xs = xs[..., idx, :]
    x = xs.to(torch.float32)
    if init == "auto":
        init = "kmeanspp" if k <= 1024 else "random"
    c = _kmeanspp_init(gen, x, k) if init == "kmeanspp" else _random_init(gen, x, k)
    c = c.to(torch.float32)
    for _ in range(iters):
        c = _lloyd_iter(x, c)
    return c


def assign(x: torch.Tensor, centroids: torch.Tensor, chunk: int = 65536,
           tile: int = 16384) -> torch.Tensor:
    """Nearest centroid of each row → (n,) int32, in chunks of ``chunk``
    rows cut into tiles of ``tile`` (the program's chunked_assign)."""
    out = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    c = centroids.to(torch.float32)[None]
    for i0 in range(0, x.shape[0], chunk):
        xc = x[i0:i0 + chunk].to(torch.float32)[None]
        for t0 in range(0, xc.shape[1], tile):
            xt = xc[:, t0:t0 + tile]
            out[i0 + t0:i0 + t0 + xt.shape[1]] = torch.argmin(sqdist(xt, c), dim=-1)[0]
    return out
