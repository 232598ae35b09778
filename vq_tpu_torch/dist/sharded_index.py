"""Sharded flat indexes — counterpart of ``vq_tpu/dist/sharded_index.py``.

The compressed corpus is row-sharded over the mesh, the quantizer's
parameters replicated once per distinct device, queries replicated; each
shard scans its rows and the candidates merge exactly at the root
(``dist/sharded.py``).  ``ShardedFlatPQIndex`` serves PQ through the fused
PQ kernel (the score kernel above k=128); ``ShardedFlatIndex`` serves any
quantizer through the generic decode→score scan.  On a one-shard mesh the
sharding is a no-op and results equal the flat index's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch._device import as_f32
from vq_tpu_torch.core.config import Metric, PQConfig, SearchConfig
from vq_tpu_torch.dist.mesh import (
    as_tensor,
    make_mesh,
    pad_rows_to_multiple,
    replicate,
    replicate_quantizer,
    shard_rows,
)
from vq_tpu_torch.dist.sharded import sharded_generic_scan_topk, sharded_scan_topk
from vq_tpu_torch.index.base import BaseSearchIndex, nbytes_of
from vq_tpu_torch.methods.base import BaseQuantizer, tree_leaves
from vq_tpu_torch.methods.pq import PQ


def bind_to_mesh(quantizer: BaseQuantizer, mesh) -> BaseQuantizer:
    """A quantizer built without a device lives on the mesh's root."""
    if quantizer.device is None:
        quantizer.device = mesh.root
    return quantizer


def _to_numpy(ids: torch.Tensor, scores: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    ids = ids.cpu().numpy()
    return np.where(ids < 0, 0, ids).astype(np.uint32), scores.cpu().numpy()


class _ShardedFlat(BaseSearchIndex):
    """Row-sharded codes and row norms over a mesh (the two flat indexes'
    shared state)."""

    def __init__(self, quantizer: BaseQuantizer, search_cfg: SearchConfig = SearchConfig(),
                 mesh=None):
        self.quantizer = quantizer
        self.search_cfg = search_cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.codes = None  # one (N_pad/P, ...) tensor per shard
        self.norms = None  # one (N_pad/P,) f32 tensor per shard (1.0 in the pad)
        self.num_rows = 0
        self._replicas = None  # the quantizer on each shard's device

    @property
    def num_shards(self) -> int:
        return self.mesh.size

    def fit(self, X):
        """Fit the quantizer (unless it has params), encode X on its device,
        keep the row norms, pad the rows to a multiple of the mesh size and
        shard them."""
        q = bind_to_mesh(self.quantizer, self.mesh)
        if q.params is None:
            q.fit(X)
        codes = q.compress(X)
        norms = torch.linalg.norm(as_f32(X, q.device), dim=-1)
        self._install(codes, norms, X.shape[0])
        return self

    def _install(self, codes, norms, num_rows: int) -> None:
        codes, norms = as_tensor(codes), as_tensor(norms).to(torch.float32)
        self.num_rows = int(num_rows)
        codes_p = pad_rows_to_multiple(codes, self.num_shards)
        pad = codes_p.shape[0] - norms.shape[0]
        norms_p = torch.cat([norms, torch.ones((pad,), dtype=torch.float32,
                                               device=norms.device)])
        self.codes = shard_rows(self.mesh, codes_p)
        self.norms = shard_rows(self.mesh, norms_p)
        self._replicas = replicate_quantizer(self.mesh, bind_to_mesh(self.quantizer, self.mesh))

    def _queries(self, queries):
        return replicate(self.mesh, as_f32(queries, self.mesh.root))

    def _norms_for_search(self):
        return self.norms if self.search_cfg.metric == Metric.NIP else None

    def memory_footprint(self) -> int:
        total = sum(nbytes_of(a) for a in (self.codes or ()) + (self.norms or ()))
        return total + sum(nbytes_of(p) for p in tree_leaves(self.quantizer.params))

    def reconstruction_mse(self, X, sample: Optional[int] = 10000) -> float:
        return self.quantizer.reconstruction_mse(X, sample)


class ShardedFlatPQIndex(_ShardedFlat):
    """PQ flat index with the code tensor row-sharded over a device mesh."""

    name = "sharded_flat_pq"

    def __init__(self, pq: Optional[PQ] = None, search_cfg: SearchConfig = SearchConfig(),
                 mesh=None):
        super().__init__(pq or PQ(PQConfig()), search_cfg, mesh)

    @property
    def pq(self) -> PQ:
        return self.quantizer

    def add_sharded(self, codes, norms, num_rows: int) -> None:
        """Install pre-encoded codes and row norms directly (the multi-host
        ingestion path: each host encodes its rows, then hands them here)."""
        self._install(codes, norms, num_rows)

    def search_with_scores(self, queries, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """(nq, D) → ((nq, k) uint32 ids, (nq, k) scores) as numpy."""
        codebooks = [r.params.codebooks for r in self._replicas]
        scores, ids = sharded_scan_topk(
            self.mesh, self._queries(queries), self.codes, codebooks, k=k,
            metric=self.search_cfg.metric, norms=self._norms_for_search(),
            true_n=self.num_rows, tile_rows=self.search_cfg.tile_rows,
            use_bf16=self.search_cfg.use_bf16)
        return _to_numpy(ids, scores)


class ShardedFlatIndex(_ShardedFlat):
    """Flat index for ANY quantizer, code rows sharded over the mesh: each
    shard runs the generic decode→score→top-k scan with its replica's
    ``decode_fn`` (``sharded_generic_scan_topk``)."""

    name = "sharded_flat"

    def search_with_scores(self, queries, k: int = 10,
                           overlap_chunks: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """(nq, D) → ((nq, k) uint32 ids, (nq, k) scores) as numpy."""
        fns = [r.decode_fn() for r in self._replicas]
        scores, ids = sharded_generic_scan_topk(
            self.mesh, self._queries(queries), self.codes, fns, k=k,
            metric=self.search_cfg.metric, norms=self._norms_for_search(),
            true_n=self.num_rows, tile_rows=self.search_cfg.tile_rows,
            use_bf16=self.search_cfg.use_bf16, overlap_chunks=overlap_chunks)
        return _to_numpy(ids, scores)
