"""Sharded IVF: inverted lists distributed over the mesh — counterpart of
``vq_tpu/dist/sharded_ivf.py``.

  fit    — a global coarse k-means on the root (the same recipe as
           ``IvfQuantizedIndex.fit``, so one seed gives the same centroids),
           then the CLUSTERS are assigned to shards by greedy size balancing
           (largest list → least-loaded shard).  Rows are encoded in
           (shard, cluster) order; each shard holds only its own lists'
           rows, padded to the largest shard's row count plus
           ``_PAD_SLACK``.  The (K,) routing tables (``shard_of``, the local
           offset of each list in its shard, ``sizes``), the centroids and
           the quantizer are replicated.
  search — every shard computes the SAME top-nprobe routing (one
           replicated product) and scans only the probed lists IT holds
           (``probe_mask``), with the single-device index's list scans
           (``index/ivf.scan_union_lists`` by default, or
           ``scan_probed_lists``) and the quantizer's code-space
           ``residual_scorer`` where it has one.  The per-shard top-k
           candidates merge exactly at the root.

No save/load, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch._device import as_f32
from vq_tpu_torch.core.config import IVFConfig, Metric, SearchConfig
from vq_tpu_torch.data.sampling import chunk_rows_for_bytes
from vq_tpu_torch.dist.mesh import (
    check_replicated,
    gather_values,
    make_mesh,
    on,
    put,
    replicate,
    replicate_quantizer,
    unzip,
)
from vq_tpu_torch.dist.sharded import _merge_local_topk
from vq_tpu_torch.dist.sharded_index import _to_numpy, bind_to_mesh
from vq_tpu_torch.index.base import BaseSearchIndex, nbytes_of
from vq_tpu_torch.index.ivf import (
    _PAD_SLACK,
    chunked_assign,
    coarse_pass,
    encode_rows_ordered,
    fit_quantizer_on_residuals,
    scan_probed_lists,
    scan_union_lists,
)
from vq_tpu_torch.kernels.kmeans import assign, pairwise_sqdist_xc
from vq_tpu_torch.kernels.topk import ordered_topk
from vq_tpu_torch.methods.base import BaseQuantizer, tree_leaves


def balance_clusters(sizes: np.ndarray, num_shards: int) -> np.ndarray:
    """Greedy LPT assignment: largest list → least-loaded shard → (K,) int32."""
    order = np.argsort(-np.asarray(sizes), kind="stable")
    load = np.zeros(num_shards, dtype=np.int64)
    shard_of = np.zeros(len(sizes), dtype=np.int32)
    for c in order:
        p = int(np.argmin(load))
        shard_of[c] = p
        load[p] += int(sizes[c])
    return shard_of


class ShardedIVFIndex(BaseSearchIndex):
    name = "sharded_ivf"

    def __init__(self, quantizer: BaseQuantizer, ivf_cfg: IVFConfig = IVFConfig(),
                 search_cfg: SearchConfig = SearchConfig(), mesh=None):
        self.quantizer = quantizer
        self.ivf_cfg = ivf_cfg
        self.search_cfg = search_cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.centroids: Optional[torch.Tensor] = None  # (K, D) on the root
        self.codes_sh = self.ids_sh = self.norms_sh = None  # one block per shard
        self.shard_of = self.local_off = self.sizes = None  # (K,) on the root
        self.num_rows = 0
        self._replicas = None

    @property
    def num_shards(self) -> int:
        return self.mesh.size

    def fit(self, X, chunk_rows: int = 0) -> "ShardedIVFIndex":
        """The chunked build: the streamed-encode core of
        ``IvfQuantizedIndex.fit`` with rows ordered by (shard, cluster), so
        the corpus never comes whole onto a card."""
        n, d = X.shape
        dev = bind_to_mesh(self.quantizer, self.mesh).device
        kcfg = self.ivf_cfg.kmeans
        self.centroids = coarse_pass(X, self.ivf_cfg, dev)
        k = self.centroids.shape[0]
        chunk = chunk_rows or chunk_rows_for_bytes(d)
        assignment = chunked_assign(X, self.centroids, chunk)
        sizes = torch.bincount(assignment.long(), minlength=k).cpu().numpy()
        shard_of = balance_clusters(sizes, self.num_shards)

        # rows ordered by (shard, cluster); per-shard CSR with LOCAL offsets
        shard_of_t = torch.as_tensor(shard_of, device=dev).long()
        order = torch.argsort(shard_of_t[assignment.long()] * (k + 1) + assignment, stable=True)
        if self.quantizer.params is None:
            fit_quantizer_on_residuals(X, assignment, self.centroids, self.quantizer,
                                       seed=kcfg.seed)
        check_replicated(self.mesh, (self.centroids, assignment, self.quantizer.params),
                         "the coarse pass or the quantizer's params")
        codes, norms = encode_rows_ordered(X, order, assignment, self.centroids,
                                           self.quantizer, chunk)
        ids = order.to(torch.int32)

        # per-shard row blocks, padded to the largest shard's load plus the
        # window slack (a window reads ≤ chunk ≤ _PAD_SLACK rows past a list)
        loads = np.bincount(shard_of, weights=sizes, minlength=self.num_shards).astype(np.int64)
        pad_to = int(loads.max()) + _PAD_SLACK
        starts = np.concatenate([[0], np.cumsum(loads)[:-1]])

        def block(a, fill):
            def take(p):
                sl = slice(int(starts[p]), int(starts[p] + loads[p]))
                pad = a.new_full((pad_to - int(loads[p]),) + tuple(a.shape[1:]), fill)
                return put(torch.cat([a[sl], pad]), self.mesh.devices[p])
            return self.mesh.each(take)

        codes_sh, ids_sh, norms_sh = block(codes, 0), block(ids, -1), block(norms, 1)
        # the local offset of each list inside its shard's block (rows are
        # grouped by shard, then by cluster id)
        local_off = np.zeros(k, dtype=np.int32)
        for p in range(self.num_shards):
            cl = np.nonzero(shard_of == p)[0]
            if len(cl):
                local_off[cl] = np.concatenate([[0], np.cumsum(sizes[cl])[:-1]])
        self._install(codes_sh, ids_sh, norms_sh, shard_of, local_off, sizes, n)
        return self

    def _install(self, codes_sh, ids_sh, norms_sh, shard_of, local_off, sizes,
                 num_rows: int) -> None:
        root = self.mesh.root
        self.codes_sh, self.ids_sh, self.norms_sh = tuple(codes_sh), tuple(ids_sh), tuple(norms_sh)
        self.shard_of = put(np.asarray(shard_of, np.int32), root)
        self.local_off = put(np.asarray(local_off, np.int32), root)
        self.sizes = put(np.asarray(sizes, np.int32), root)
        self.num_rows = int(num_rows)
        self._replicas = replicate_quantizer(self.mesh, self.quantizer)

    # --------------------------------------------------------------- search
    def _search_device(self, queries, k: int, nprobe: int, chunk: Optional[int] = None,
                       strategy: str = "union") -> Tuple[torch.Tensor, torch.Tensor]:
        """One search → (scores in the metric's form, ids) on the root.  Each
        shard routes the whole batch and scans the probed lists it holds."""
        if strategy not in ("union", "windows"):
            raise ValueError(f"strategy {strategy!r}")
        if chunk is None:
            chunk = 4096 if strategy == "union" else 512
        if strategy == "windows" and chunk > _PAD_SLACK:
            raise ValueError(f"windows chunk {chunk} > {_PAD_SLACK}")
        metric = self.search_cfg.metric
        q_root = as_f32(queries, self.mesh.root)
        reps = [replicate(self.mesh, a) for a in (q_root, self.centroids, self.shard_of,
                                                   self.local_off, self.sizes)]

        def scan(p):
            q, cents, shard_of, local_off, sizes = (r[p] for r in reps)
            quant = self._replicas[p]
            with on(self.mesh.devices[p]):
                cd = pairwise_sqdist_xc(q, cents)  # (Q, K): the same on every shard
                _, probe = ordered_topk(-cd, nprobe)
                own = shard_of[probe.long()] == p  # (Q, nprobe) lists this shard holds
                kw = dict(probe_mask=own)
                scorer = quant.residual_scorer()
                if scorer is not None:
                    q_map, window_fn = scorer
                    kw.update(scorer_window=window_fn, q_side=q_map(q), c_side=q_map(cents))
                args = (cents, self.codes_sh[p], self.ids_sh[p], self.norms_sh[p], local_off,
                        sizes, quant.decode_fn(), k, metric)
                if strategy == "union":
                    s, gid = scan_union_lists(q, probe, cd, *args, chunk=chunk, **kw)
                else:
                    s, gid = scan_probed_lists(q, probe, *args, chunk=chunk, **kw)
            # masked probes and pad slots carry −inf (maximize form): the
            # exact merge never surfaces them
            return (-s if metric == Metric.L2 else s), gid

        return _merge_local_topk(self.mesh, *unzip(self.mesh.each(scan)), k, metric)

    def search_with_scores(self, queries, k: int = 10,
                           strategy: str = "union") -> Tuple[np.ndarray, np.ndarray]:
        """(nq, D) → ((nq, k) uint32 ids, (nq, k) scores) as numpy."""
        nprobe = min(self.ivf_cfg.nprobe, int(self.centroids.shape[0]))
        scores, ids = self._search_device(queries, k, nprobe, strategy=strategy)
        return _to_numpy(ids, scores)

    # ---------------------------------------------------------------- misc
    def memory_footprint(self) -> int:
        """Bytes of every shard's lists (the whole mesh's, on every rank), of
        the centroids and of the params once."""
        total = 0
        if self.codes_sh is not None:
            total = sum(gather_values(self.mesh, self.mesh.each(lambda p: sum(
                nbytes_of(a[p]) for a in (self.codes_sh, self.ids_sh, self.norms_sh)))))
        return (total + nbytes_of(self.centroids)
                + sum(nbytes_of(p) for p in tree_leaves(self.quantizer.params)))

    def reconstruction_mse(self, X, sample: Optional[int] = 10000) -> float:
        xs = as_f32(X[: sample or len(X)], self.centroids.device)
        res = xs - self.centroids[assign(xs, self.centroids).long()]
        rec = self.quantizer.decompress(self.quantizer.compress(res))
        return float(torch.mean((res - rec) ** 2))
