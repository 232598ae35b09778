"""Sharded probed-tile IVF: per-shard tile masks over the packed kernel's
gather mode — counterpart of ``vq_tpu/dist/sharded_ivf_packed.py``.

  fit    — coarse k-means (or a shared ``coarse=``), rows cluster-sorted
           GLOBALLY (a cluster's rows are contiguous, almost always on one
           shard), flat-encoded in that order (zero centroid, as
           ``IvfPackedFlatIndex`` does), padded at the global tail to a
           multiple of P·512 and split into equal per-shard blocks; each
           shard builds an ORDER-PRESERVING packed cache
           (``prepare_tile_cache``) and its tiles' cluster ranges.
  search — every shard routes the batch (one replicated product), turns the
           probed set into a mask over its LOCAL tiles
           (``ivf_packed.tile_mask_from_probes``) and runs the gather mode
           with a ``num_valid`` prefix limit for the pad tail; the
           candidates merge exactly at the root, ties by global scan
           position as the single-device index breaks them.

Shard blocks are multiples of 512 rows, so every shard tile is a global
tile: the masks, hence the results, equal ``IvfPackedFlatIndex``'s.
"""

from __future__ import annotations

import math
import pickle
from typing import List, Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch._device import as_f32, bf16_supported, to_device
from vq_tpu_torch.core.config import IVFConfig, SearchConfig
from vq_tpu_torch.data.sampling import chunk_rows_for_bytes, host_sample_rows
from vq_tpu_torch.dist.mesh import (
    all_gather,
    check_replicated,
    check_savable,
    gather_values,
    make_mesh,
    on,
    put,
    replicate,
    replicate_quantizer,
    unzip,
)
from vq_tpu_torch.dist.sharded import merge_topk
from vq_tpu_torch.dist.sharded_index import _to_numpy, bind_to_mesh
from vq_tpu_torch.dist.sharded_packed import (
    check_num_shards,
    shared_prune_hint,
    stacked_shards,
)
from vq_tpu_torch.index.base import BaseSearchIndex, nbytes_of
from vq_tpu_torch.index.ivf import chunked_assign, coarse_pass, encode_rows_ordered
from vq_tpu_torch.index.ivf_packed import tile_mask_from_probes
from vq_tpu_torch.kernels.adc import _finalize
from vq_tpu_torch.kernels.kmeans import pairwise_sqdist_xc
from vq_tpu_torch.kernels.packed_scan import TILE, PackedCorpus
from vq_tpu_torch.kernels.topk import ordered_topk
from vq_tpu_torch.methods.base import BaseQuantizer, tree_leaves


class ShardedIvfPackedIndex(BaseSearchIndex):
    """Probed-tile packed IVF with the corpus row-sharded over the mesh."""

    name = "sharded_ivf_packed"

    def __init__(self, quantizer: BaseQuantizer, ivf_cfg: IVFConfig = IVFConfig(),
                 search_cfg: SearchConfig = SearchConfig(), mesh=None):
        self.quantizer = quantizer
        self.ivf_cfg = ivf_cfg
        self.search_cfg = search_cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.centroids: Optional[torch.Tensor] = None  # (K, D) on the root
        self.num_rows = 0
        self._n_loc = 0
        self.shards: List[Optional[PackedCorpus]] = []  # order-preserving, a local shard's
        self._ids = None  # per local shard (n_loc,) i32: local position → global id (−1: pad)
        self._cl_first = self._cl_last = None  # per local shard (n_loc/512,) i32
        self._replicas = None

    @property
    def num_shards(self) -> int:
        return self.mesh.size

    # ------------------------------------------------------------------ fit
    def fit(self, X, chunk_rows: int = 0, coarse=None) -> "ShardedIvfPackedIndex":
        n, d = X.shape
        chunk = chunk_rows or chunk_rows_for_bytes(d)
        dev = bind_to_mesh(self.quantizer, self.mesh).device
        kcfg = self.ivf_cfg.kmeans
        if coarse is not None:
            centroids = as_f32(coarse[0], dev).contiguous()
            assignment = to_device(torch.as_tensor(coarse[1]), dev).to(torch.int32)
        else:
            centroids = coarse_pass(X, self.ivf_cfg, dev)
            assignment = chunked_assign(X, centroids, chunk)
        order = torch.argsort(assignment, stable=True)
        if self.quantizer.params is None:
            self.quantizer.fit(host_sample_rows(X, 200_000, kcfg.seed))
        check_replicated(self.mesh, (centroids, assignment, self.quantizer.params),
                         "the coarse pass or the quantizer's params")
        codes, norms = encode_rows_ordered(
            X, order, torch.zeros((n,), dtype=torch.int32, device=dev),
            torch.zeros((1, d), dtype=torch.float32, device=dev), self.quantizer, chunk)

        p_cnt = self.num_shards
        blk = p_cnt * TILE
        n_pad = -(-n // blk) * blk
        n_loc = n_pad // p_cnt
        pad = n_pad - n
        codes = torch.cat([codes, codes.new_zeros((pad,) + tuple(codes.shape[1:]))])
        norms = torch.cat([norms, norms.new_ones((pad,))])
        ids = torch.cat([order.to(torch.int32), order.new_full((pad,), -1, dtype=torch.int32)])
        # pad rows take the last real row's cluster so per-tile ranges stay
        # monotone; the num_valid prefix limit excludes them
        asn = assignment[order]
        asn = torch.cat([asn, asn[-1:].expand(pad)])
        tiles = torch.arange(n_pad // TILE, device=dev) * TILE
        firsts, lasts = asn[tiles], asn[tiles + TILE - 1]

        self._replicas = replicate_quantizer(self.mesh, self.quantizer)
        nb_loc = n_loc // TILE

        def build(p):
            p_dev, sl = self.mesh.devices[p], slice(p * n_loc, (p + 1) * n_loc)
            with on(p_dev):
                cache = self._replicas[p].prepare_tile_cache(put(codes[sl], p_dev),
                                                             norms=put(norms[sl], p_dev))
            if cache is None:
                raise RuntimeError(f"{self.quantizer.name} has no packed tile cache: use "
                                   "dist.sharded_ivf.ShardedIVFIndex")
            if cache.perm is not None:
                raise RuntimeError("prepare_tile_cache must keep the rows' order (perm None)")
            return cache

        self._install(centroids, self.mesh.each(build),
                      self.mesh.each(lambda p: ids[p * n_loc:(p + 1) * n_loc]),
                      self.mesh.each(lambda p: firsts[p * nb_loc:(p + 1) * nb_loc]),
                      self.mesh.each(lambda p: lasts[p * nb_loc:(p + 1) * nb_loc]), n, n_loc)
        return self

    def _install(self, centroids, shards, ids, cl_first, cl_last, num_rows: int,
                 n_loc: int) -> None:
        """Per-shard state onto each local shard's device (the lists in shard
        order, None at the shards of other ranks); the centroids on the
        root."""
        mesh = self.mesh
        self.centroids = put(centroids, mesh.root).to(torch.float32).contiguous()
        hint = shared_prune_hint(mesh, shards)
        for c in shards:
            if c is not None:
                c.prune_hint = hint
        self.shards = list(shards)
        self._ids, self._cl_first, self._cl_last = (
            list(mesh.each(lambda p, a=a: put(a[p], mesh.devices[p]).to(torch.int32)))
            for a in (ids, cl_first, cl_last))
        self.num_rows = int(num_rows)
        self._n_loc = int(n_loc)

    # --------------------------------------------------------------- search
    def _search(self, q: torch.Tensor, k: int, nprobe: int):
        """One search → (scores (Q, k) in the metric's form, ids (Q, k)) on
        the root, no host sync."""
        metric = self.search_cfg.metric
        k_cl = int(self.centroids.shape[0])
        n_loc, true_n = self._n_loc, self.num_rows
        qs, cs = replicate(self.mesh, q), replicate(self.mesh, self.centroids)

        def scan(p):
            dev = self.mesh.devices[p]
            with on(dev):
                _, probe = ordered_topk(-pairwise_sqdist_xc(qs[p], cs[p]), nprobe)
                mask = tile_mask_from_probes(probe, self._cl_first[p], self._cl_last[p], k_cl)
                s, pos = self._replicas[p].packed_scan_raw(
                    qs[p], self.shards[p], k, metric,
                    num_valid=min(max(true_n - p * n_loc, 0), n_loc),
                    use_bf16=self.search_cfg.use_bf16 and bf16_supported(dev),
                    tile_mask=mask)
                gid = self._ids[p][torch.clamp(pos.long(), 0, n_loc - 1)]
            return torch.where(gid < 0, torch.full_like(s, -math.inf), s), gid

        scores, gids = unzip(self.mesh.each(scan))
        # each shard's candidates come in (score, local position) order and
        # the shards in global position order, so the positional merge of the
        # kernel's scores keeps IvfPackedFlatIndex's order, ties included
        with on(self.mesh.root):
            s, gid = merge_topk(all_gather(self.mesh, scores), all_gather(self.mesh, gids), k,
                                by_position=True)
            return _finalize(s, gid, metric, torch.sum(q * q, dim=-1))

    def search_with_scores(self, queries, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """(nq, D) → ((nq, k) uint32 ids, (nq, k) scores) as numpy."""
        nprobe = min(self.ivf_cfg.nprobe, int(self.centroids.shape[0]))
        scores, ids = self._search(as_f32(queries, self.mesh.root), k, nprobe)
        return _to_numpy(ids, scores)

    # ---------------------------------------------------------------- misc
    def memory_footprint(self) -> int:
        """Bytes of every shard's state (the whole mesh's, on every rank), of
        the centroids and of the params once."""
        def shard_bytes(p):
            c = self.shards[p]
            return sum(nbytes_of(a) for a in list(c.words) + [
                c.factors, c.tile_stats, self._ids[p], self._cl_first[p], self._cl_last[p]])

        return (sum(gather_values(self.mesh, self.mesh.each(shard_bytes)))
                + nbytes_of(self.centroids)
                + sum(nbytes_of(p) for p in tree_leaves(self.quantizer.params)))

    def reconstruction_mse(self, X, sample: Optional[int] = 10000) -> float:
        return self.quantizer.reconstruction_mse(X, sample)

    # ------------------------------------------------------------ save/load
    def _state(self) -> dict:
        """Per-shard leaves stacked as (P, …) numpy arrays (factors (P, F,
        n_loc)); a load needs a mesh of the same size.  A mesh over several
        ranks cannot be saved (``check_savable``)."""
        check_savable(self.mesh)

        def stack(leaves):
            return None if leaves[0] is None else np.stack([a.cpu().numpy() for a in leaves])

        c0 = self.shards[0]
        return {
            "quantizer": pickle.dumps(self.quantizer),
            "ivf_cfg": self.ivf_cfg,
            "search_cfg": self.search_cfg,
            "num_rows": self.num_rows,
            "n_loc": self._n_loc,
            "num_shards": self.num_shards,
            "centroids": self.centroids.cpu().numpy(),
            "words": [stack([c.words[s] for c in self.shards]) for s in range(len(c0.words))],
            "factors": stack([c.factors for c in self.shards]),
            "stats": stack([c.tile_stats for c in self.shards]),
            "ids": stack(self._ids),
            "cl_first": stack(self._cl_first),
            "cl_last": stack(self._cl_last),
            "has_norms": c0.has_norms,
            "prune_hint": c0.prune_hint,
        }

    def _restore(self, state: dict) -> None:
        check_num_shards(state, self.mesh)
        self.quantizer = pickle.loads(state["quantizer"])
        self.ivf_cfg = state["ivf_cfg"]
        self.search_cfg = state["search_cfg"]
        self._load_stacked(state)

    def _load_stacked(self, state: dict) -> None:
        """The per-shard state of ``_state``'s stacked leaves, onto each
        shard's device."""
        self._replicas = replicate_quantizer(self.mesh, self.quantizer)
        shards = stacked_shards(self.mesh, {**state, "perm": None})
        self._install(state["centroids"], shards, list(state["ids"]), list(state["cl_first"]),
                      list(state["cl_last"]), state["num_rows"], state["n_loc"])
