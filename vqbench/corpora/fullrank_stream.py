"""Planted neighbourhoods at full rank as a row source, for corpora larger
than the card.

The distribution of ``fullrank``: rows z·A with z = centre + spread·N(0, I),
A (rank, D) with column scale (1+i)^-0.5 (from ``basis_seed`` where given),
rows unit-normalized; row i lies on centre i mod n/csize; the queries are
fresh variants of random centres.  The corpus is never whole on the
device: ``make`` returns a ``Rows`` that makes the rows a request asks for.
Each block of ``block`` rows is drawn by a generator of its own, seeded
from (``seed``, block index), so any range can be made again alone; the
rows are therefore not ``fullrank``'s.  The mixing matrix, the centres and
the query pool stay resident.
"""

from __future__ import annotations

import numpy as np
import torch


def block_seed(seed: int, b: int) -> int:
    """The generator seed of block ``b`` of the corpus drawn from ``seed``."""
    return int(np.random.SeedSequence([int(seed) % 2**64, b]).generate_state(1, np.uint64)[0])


class Rows:
    """An (n, D) f32 corpus on ``device`` whose rows are made on request:
    ``rows[i0:i1]`` or ``rows[ids]`` (a list, array or tensor of row ids)
    gives a tensor on the device.  A request of more than ``max_rows``
    rows, ``np.asarray`` / ``torch.as_tensor`` of the whole, a single row
    and iteration raise."""

    dtype = torch.float32
    max_rows = 1 << 20  # 4 GiB of rows at D=1024

    def __init__(self, a, cents, n: int, seed: int, spread: float, block: int):
        self.a, self.cents, self.seed = a, cents, int(seed)
        self.spread, self.block = spread, block
        self.shape = torch.Size((n, a.shape[1]))
        self.device = a.device

    def __len__(self) -> int:
        return self.shape[0]

    def make_block(self, b: int) -> torch.Tensor:
        """Every row of block ``b``, (≤ block, D)."""
        dev, kc = self.device, self.cents.shape[0]
        i0, i1 = b * self.block, min(self.shape[0], (b + 1) * self.block)
        g = torch.Generator(device=dev).manual_seed(block_seed(self.seed, b))
        z = self.cents[torch.arange(i0, i1, device=dev) % kc] + self.spread * torch.randn(
            (i1 - i0, self.a.shape[0]), generator=g, device=dev)
        xb = z @ self.a
        return xb / torch.linalg.norm(xb, dim=1, keepdim=True)

    def _check(self, count: int) -> None:
        if count > self.max_rows:
            raise MemoryError(f"a request of {count} rows; a row source serves at most "
                              f"{self.max_rows} at a time")

    def _range(self, start: int, stop: int) -> torch.Tensor:
        stop = max(start, stop)
        self._check(stop - start)
        out = torch.empty((stop - start, self.shape[1]), device=self.device)
        for b in range(start // self.block, -(-stop // self.block)):
            b0 = b * self.block
            lo, hi = max(start, b0), min(stop, b0 + self.block)
            out[lo - start:hi - start] = self.make_block(b)[lo - b0:hi - b0]
        return out

    def _take(self, ids: torch.Tensor) -> torch.Tensor:
        self._check(ids.numel())
        if bool(((ids < 0) | (ids >= self.shape[0])).any()):
            raise IndexError(f"row ids outside [0, {self.shape[0]})")
        out = torch.empty((ids.shape[0], self.shape[1]), device=self.device)
        blocks = ids // self.block
        for b in torch.unique(blocks).tolist():
            sel = torch.nonzero(blocks == b).squeeze(1)
            out[sel] = self.make_block(b)[ids[sel] - b * self.block]
        return out

    def __getitem__(self, key) -> torch.Tensor:
        if isinstance(key, slice):
            start, stop, step = key.indices(self.shape[0])
            if step == 1:
                return self._range(start, stop)
            key = range(start, stop, step)
        ids = torch.as_tensor(np.asarray(key) if isinstance(key, (list, tuple, range)) else key)
        if ids.numel() == 0:
            ids = ids.reshape(0).long()
        if ids.dtype.is_floating_point or ids.dtype == torch.bool or ids.dim() != 1:
            raise TypeError(f"a row source serves slices and 1-d lists of row ids, not {key!r}")
        return self._take(ids.to(device=self.device, dtype=torch.int64))

    def __array__(self, *args, **kwargs):
        raise MemoryError("materializing the whole of a row source")


def make(n: int, d: int, nq: int, seed: int, device, rank=None, csize: int = 100,
         spread: float = 1.0, block: int = 65536, basis_seed=None):
    """→ (a ``Rows`` of n f32 unit rows of d dims, the query pool q (nq, d)
    f32 unit rows), both on ``device``."""
    dev = torch.device(device)
    rank = rank or d
    g = torch.Generator(device=dev).manual_seed(int(seed))
    ga = g if basis_seed is None else torch.Generator(device=dev).manual_seed(int(basis_seed))
    kc = n // csize
    a = torch.randn((rank, d), generator=ga, device=dev)
    a = a * (1.0 + torch.arange(d, device=dev)) ** -0.5
    cents = torch.randn((kc, rank), generator=g, device=dev)
    qdoc = torch.randint(0, kc, (nq,), generator=g, device=dev)
    qv = (cents[qdoc] + spread * torch.randn((nq, rank), generator=g, device=dev)) @ a
    return (Rows(a, cents, n, seed, spread, block),
            qv / torch.linalg.norm(qv, dim=1, keepdim=True))
