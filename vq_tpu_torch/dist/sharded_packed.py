"""Sharded serving through the packed-code kernel — counterpart of
``vq_tpu/dist/sharded_packed.py``.

  fit    — rows are encoded (streamed, ``index/ivf.encode_rows_ordered``
           with a zero centroid), padded at the global tail to a multiple
           of P·512 and split into equal per-shard blocks; EACH SHARD
           builds its own packed cache from its rows on its device
           (``quantizer.prepare_shard_cache``).  SAQ norm-orders each shard
           locally, with the pad rows sorted to the local tail, so a
           prefix limit (``num_valid``) masks them exactly.
  search — each shard runs the packed kernel (``packed_scan_raw``) over its
           cache under its device; the per-shard (Q, k) candidates merge
           exactly at the root, optionally per chunk of each shard's rows
           (``overlap_chunks``: the chunk's words, its (F, N) factor
           columns and its tile stats), then ``_finalize`` turns the
           merged scores into the metric's.

A quantizer without a shard cache raises: nothing falls back to the generic
scan.  On a one-shard mesh the result equals the flat packed scan.
"""

from __future__ import annotations

import math
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vq_tpu_torch._device import as_f32, bf16_supported
from vq_tpu_torch.core.config import SearchConfig
from vq_tpu_torch.data.sampling import chunk_rows_for_bytes
from vq_tpu_torch.dist.mesh import (
    check_replicated,
    check_savable,
    gather_values,
    make_mesh,
    on,
    put,
    replicate,
    replicate_quantizer,
)
from vq_tpu_torch.dist.sharded import merge_chunks
from vq_tpu_torch.dist.sharded_index import _to_numpy, bind_to_mesh
from vq_tpu_torch.index.base import BaseSearchIndex, nbytes_of
from vq_tpu_torch.index.ivf import encode_rows_ordered
from vq_tpu_torch.kernels.adc import _finalize
from vq_tpu_torch.kernels.packed_scan import TILE, PackedCorpus
from vq_tpu_torch.methods.base import BaseQuantizer, tree_leaves


def chunk_of(cache: PackedCorpus, c: int, csz: int) -> PackedCorpus:
    """Rows [c·csz, (c+1)·csz) of a shard's cache (csz a 512 multiple): the
    rows' words or value planes, their factor columns and tile stats.  The
    kernel takes contiguous (F, N) factors, so the columns are copied: F ·
    csz f32 a chunk, a shard and a search (JAX's (N, F) rows slice for
    free).  ``chip_smoke.py`` phase 13 times these copies."""
    n = cache.factors.shape[1]
    r0, r1 = c * csz, (c + 1) * csz
    words = tuple(w[r0 * w.shape[0] // n:r1 * w.shape[0] // n] for w in cache.words)
    stats = None if cache.tile_stats is None else cache.tile_stats[r0 // TILE:r1 // TILE]
    return PackedCorpus(words=words, factors=cache.factors[:, r0:r1].contiguous(),
                        num_rows=csz, tile_stats=stats, has_norms=cache.has_norms,
                        perm=None, prune_hint=cache.prune_hint)


class ShardedPackedFlatIndex(BaseSearchIndex):
    """Flat index serving SAQ / RaBitQ / RankAware through the packed kernel
    with the corpus row-sharded over the mesh."""

    name = "sharded_packed_flat"

    def __init__(self, quantizer: BaseQuantizer, search_cfg: SearchConfig = SearchConfig(),
                 mesh=None):
        self.quantizer = quantizer
        self.search_cfg = search_cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.num_rows = 0
        self._n_loc = 0
        self.shards: List[Optional[PackedCorpus]] = []  # a cache per local shard, perm set
        self._replicas = None

    @property
    def num_shards(self) -> int:
        return self.mesh.size

    # ------------------------------------------------------------------ fit
    def fit(self, X, chunk_rows: int = 0) -> "ShardedPackedFlatIndex":
        n, d = X.shape
        q = bind_to_mesh(self.quantizer, self.mesh)
        if q.params is None:
            q.fit(X)
        check_replicated(self.mesh, q.params, f"{q.name}'s params")
        dev = q.device
        # the chunked flat encode: the IVF streamed-encode core with a zero
        # centroid (residual == row); norms ride along for Metric.NIP
        codes, norms = encode_rows_ordered(
            X, torch.arange(n, device=dev), torch.zeros((n,), dtype=torch.int32, device=dev),
            torch.zeros((1, d), dtype=torch.float32, device=dev), q,
            chunk_rows or chunk_rows_for_bytes(d))
        self._install(codes, norms, n)
        return self

    def _install(self, codes: torch.Tensor, norms: torch.Tensor, n: int) -> None:
        """Pad to a multiple of P·512 rows and build each local shard's cache
        from its block, on its device."""
        p_cnt = self.num_shards
        blk = p_cnt * TILE
        n_pad = -(-n // blk) * blk
        n_loc = n_pad // p_cnt
        codes = torch.cat([codes, codes.new_zeros((n_pad - n,) + tuple(codes.shape[1:]))])
        norms = torch.cat([norms, norms.new_ones((n_pad - n,))])
        self._replicas = replicate_quantizer(self.mesh, self.quantizer)

        def build(p):
            dev, sl = self.mesh.devices[p], slice(p * n_loc, (p + 1) * n_loc)
            with on(dev):
                cache = self._replicas[p].prepare_shard_cache(
                    put(codes[sl], dev), norms=put(norms[sl], dev),
                    num_valid_rows=min(max(n - p * n_loc, 0), n_loc))
            if cache is None:
                raise RuntimeError(f"{self.quantizer.name} has no packed shard cache: serve it "
                                   "with dist.sharded_index.ShardedFlatIndex")
            if cache.perm is None:  # one search program for both layouts
                cache.perm = torch.arange(n_loc, dtype=torch.int32, device=dev)
            return cache

        self._set_shards(list(self.mesh.each(build)), n, n_loc)

    def _set_shards(self, shards: List[Optional[PackedCorpus]], num_rows: int,
                    n_loc: int) -> None:
        # one rule for all shards: prune iff ANY shard's tile bounds can fire
        hint = shared_prune_hint(self.mesh, shards)
        for c in shards:
            if c is not None:
                c.prune_hint = hint
        self.shards = shards
        self.num_rows = int(num_rows)
        self._n_loc = int(n_loc)

    # --------------------------------------------------------------- search
    def _search(self, q: torch.Tensor, k: int, overlap_chunks: int = 1):
        """One search → (scores (Q, k) in the metric's form, ids (Q, k)) on
        the root, no host sync."""
        metric = self.search_cfg.metric
        n_loc, true_n = self._n_loc, self.num_rows
        nb = n_loc // TILE
        chunks = max(1, min(overlap_chunks, nb))
        while nb % chunks:
            chunks -= 1
        csz = n_loc // chunks
        qs = replicate(self.mesh, q)

        def scan_chunk(p, c):
            dev = self.mesh.devices[p]
            cache = self.shards[p]
            with on(dev):
                sub = cache if chunks == 1 else chunk_of(cache, c, csz)
                valid = min(max(true_n - p * n_loc, 0), n_loc)
                s, pos = self._replicas[p].packed_scan_raw(
                    qs[p], sub, k, metric, num_valid=min(max(valid - c * csz, 0), csz),
                    use_bf16=self.search_cfg.use_bf16 and bf16_supported(dev))
                gid = cache.perm[pos.long() + c * csz] + p * n_loc
                return torch.where(gid >= true_n, torch.full_like(s, -math.inf), s), gid

        s, gid = merge_chunks(self.mesh, chunks, scan_chunk, k)
        with on(self.mesh.root):
            return _finalize(s, gid, metric, torch.sum(q * q, dim=-1))

    def search_with_scores(self, queries, k: int = 10,
                           overlap_chunks: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """(nq, D) → ((nq, k) uint32 ids, (nq, k) scores) as numpy."""
        scores, ids = self._search(as_f32(queries, self.mesh.root), k, overlap_chunks)
        return _to_numpy(ids, scores)

    # ---------------------------------------------------------------- misc
    def memory_footprint(self) -> int:
        """Bytes of every shard's cache (the whole mesh's, on every rank) and
        of the params once."""
        total = 0
        if self.shards:
            total = sum(gather_values(self.mesh, self.mesh.each(lambda p: sum(
                nbytes_of(a) for a in list(self.shards[p].words) + [
                    self.shards[p].factors, self.shards[p].tile_stats, self.shards[p].perm]))))
        return total + sum(nbytes_of(p) for p in tree_leaves(self.quantizer.params))

    def reconstruction_mse(self, X, sample: Optional[int] = 10000) -> float:
        return self.quantizer.reconstruction_mse(X, sample)

    # ------------------------------------------------------------ save/load
    def _state(self) -> dict:
        """The per-shard caches stacked as (P, …) numpy arrays, factors
        (P, F, n_loc).  Each shard's layout (its local norm order and pad
        tail) is baked into them, so a load needs a mesh of the same size:
        P shards do not re-split over another count (refit instead).  A mesh
        over several ranks cannot be saved (``check_savable``)."""
        check_savable(self.mesh)

        def stack(get):
            leaves = [get(c) for c in self.shards]
            return None if leaves[0] is None else np.stack([a.cpu().numpy() for a in leaves])

        return {
            "quantizer": pickle.dumps(self.quantizer),
            "search_cfg": self.search_cfg,
            "num_rows": self.num_rows,
            "n_loc": self._n_loc,
            "num_shards": self.num_shards,
            "words": [stack(lambda c, s=s: c.words[s]) for s in range(len(self.shards[0].words))],
            "factors": stack(lambda c: c.factors),
            "stats": stack(lambda c: c.tile_stats),
            "perm": stack(lambda c: c.perm),
            "has_norms": self.shards[0].has_norms,
            "prune_hint": self.shards[0].prune_hint,
        }

    def _restore(self, state: dict) -> None:
        check_num_shards(state, self.mesh)
        self.quantizer = pickle.loads(state["quantizer"])
        self.search_cfg = state["search_cfg"]
        self._load_stacked(state)

    def _load_stacked(self, state: dict) -> None:
        """The caches of ``_state``'s stacked leaves, onto each shard's device."""
        self._replicas = replicate_quantizer(self.mesh, self.quantizer)
        self._set_shards(stacked_shards(self.mesh, state), state["num_rows"], state["n_loc"])


def check_num_shards(state: dict, mesh) -> None:
    if state["num_shards"] != mesh.size:
        raise ValueError(f"index was saved with {state['num_shards']} shards but the mesh has "
                         f"{mesh.size}: per-shard packed layouts do not re-split; refit on "
                         "this mesh")


def shared_prune_hint(mesh, shards: Sequence[Optional[PackedCorpus]]) -> bool:
    """Whether any shard's tile bounds can fire, over every rank's shards."""
    return any(gather_values(mesh, [None if c is None else c.prune_hint for c in shards]))


def stacked_shards(mesh, state: dict) -> List[Optional[PackedCorpus]]:
    """(P, …) stacked cache leaves (``_state``'s layout: factors (P, F, n))
    → one PackedCorpus per local shard on its device (None at the others)."""
    def load(p):
        dev, stats = mesh.devices[p], state["stats"]
        return PackedCorpus(
            words=tuple(put(w[p], dev) for w in state["words"]),
            factors=put(state["factors"][p], dev), num_rows=state["factors"].shape[2],
            tile_stats=None if stats is None else put(stats[p], dev),
            has_norms=state["has_norms"],
            perm=None if state["perm"] is None else put(state["perm"][p], dev),
            prune_hint=state["prune_hint"])

    return list(mesh.each(load))
