"""IVF routing as a TILE MASK over the packed-code scan — counterpart of
``vq_tpu/index/ivf_packed.py``.

  fit    — coarse k-means (or a shared ``coarse=``), rows sorted by cluster
           (a stable sort), FLAT-encoded (original rows, not residuals),
           packed with the order-preserving tile cache
           (``prepare_tile_cache``, ``methods/packed.py``).  Per-tile cluster ranges
           (first/last cluster in each 512-row tile) are precomputed.
  search — one matrix product routes each query to its top-nprobe clusters
           (``ordered_topk``: ``lax.top_k``'s order, so the probes equal the
           JAX package's); a (K,) probed flag and its prefix sums turn the
           batch's probed set into an (nb,) tile mask; the packed kernel's
           gather mode (``kernels/packed_scan.py``, ``csrc/packed_scan.cu``)
           scans only the masked-in tiles, in one launch, with no host sync.

Semantics: candidates are all rows in tiles OVERLAPPING a probed cluster of
the whole batch — a superset of each query's probed lists — scored with the
flat packed scores; a full probe equals the flat scan of the same cache.

Probe-coherent query groups (``query_groups`` = G > 1, the JAX package's
option, off by default): the batch, padded to a multiple of G by repeating
its last query, is sorted by nearest coarse cell (a stable sort) and cut
into G groups; each group gets its own tile mask and gather-kernel launch,
in order (JAX's ``lax.map``), and the results are put back in the batch's
order.  A group's mask is the union of coherent queries' probes, so it can
be far smaller than the batch's; ``last_tiles_scanned`` is the sum over the
groups, which can exceed one dense pass when the groups do not cohere.
"""

from __future__ import annotations

import math
import pickle
import time
from typing import Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch._device import as_f32, bf16_supported, to_device
from vq_tpu_torch.core.config import IVFConfig, SearchConfig
from vq_tpu_torch.data.sampling import chunk_rows_for_bytes, host_sample_rows
from vq_tpu_torch.index.base import BaseSearchIndex, nbytes_of
from vq_tpu_torch.index.ivf import chunked_assign, coarse_pass, encode_rows_ordered
from vq_tpu_torch.kernels.adc import _finalize
from vq_tpu_torch.kernels.kmeans import pairwise_sqdist_xc
from vq_tpu_torch.kernels.packed_scan import TILE, PackedCorpus
from vq_tpu_torch.kernels.topk import ordered_topk
from vq_tpu_torch.methods.base import BaseQuantizer, tree_leaves
from vq_tpu_torch.utils.trace import span


def tile_mask_from_probes(probes: torch.Tensor, cl_first: torch.Tensor,
                          cl_last: torch.Tensor, k_cl: int) -> torch.Tensor:
    """Probed cluster ids (any shape) → (nb,) i32 tile mask in O(K + tiles):
    a tile is scanned iff any cluster in its [first, last] range is probed —
    the inclusive prefix sum of the probed flag makes the range test a
    difference of two gathers."""
    # index_fill_ takes its value as a scalar argument; ``probed[idx] = 1``
    # copies a host tensor to the card and synchronizes the stream
    probed = torch.zeros((k_cl,), dtype=torch.int32, device=probes.device)
    probed.index_fill_(0, probes.reshape(-1).long(), 1)
    pref = torch.cumsum(probed, 0, dtype=torch.int32)
    hi = pref[cl_last.long()]
    lo = torch.where(cl_first > 0, pref[(cl_first - 1).clamp(min=0).long()],
                     torch.zeros_like(hi))
    return (hi - lo > 0).to(torch.int32)


def default_mask_cap(nb: int, nprobe: int, num_rows: int, k_cl: int) -> Optional[int]:
    """The JAX package's static short-grid cap (~4× the perfectly coherent
    nprobe span); None when it would not shorten the grid.  Kept for
    parity: the card's gather kernel sizes nothing by it, so no search of
    the port computes it."""
    tiles_per_cl = num_rows // (k_cl * TILE) + 1
    cap = int(min(nb, 4 * nprobe * tiles_per_cl + 64))
    return cap if cap < nb else None


class IvfPackedFlatIndex(BaseSearchIndex):
    """Probed-tile packed scan for quantizers with ``prepare_tile_cache`` +
    ``packed_scan_raw`` (``methods/packed.py``: SAQ, RaBitQ, RankAware)."""

    name = "ivf_packed"

    def __init__(self, quantizer: BaseQuantizer, ivf_cfg: IVFConfig = IVFConfig(),
                 search_cfg: SearchConfig = SearchConfig(), query_groups: int = 1):
        self.quantizer = quantizer
        self.ivf_cfg = ivf_cfg
        self.search_cfg = search_cfg
        self.query_groups = query_groups
        self.centroids: Optional[torch.Tensor] = None  # (K, D)
        self.cache: Optional[PackedCorpus] = None  # order-preserving
        self.ids_sorted: Optional[torch.Tensor] = None  # (N,) i32 position → row id
        self.cl_first: Optional[torch.Tensor] = None  # (nb,) i32 first cluster per tile
        self.cl_last: Optional[torch.Tensor] = None  # (nb,) i32
        self.num_rows = 0
        self._last_tiles = None  # device scalar; synced when read

    @property
    def device(self) -> torch.device:
        return self.quantizer.device

    # ------------------------------------------------------------------ fit
    def fit(self, X, chunk_rows: int = 0, coarse=None) -> "IvfPackedFlatIndex":
        """Coarse cells (trained here, or ``coarse=(centroids, assignment)``),
        rows in cluster order, flat encode and the order-preserving packed
        cache.  X: numpy / np.memmap (streamed onto the device a chunk at a
        time) or a tensor; the index lives on the quantizer's device (X's,
        or the card for host data, when the quantizer has none)."""
        n, d = X.shape
        chunk = chunk_rows or chunk_rows_for_bytes(d)
        dev = self.quantizer._bind_device(X)
        kcfg = self.ivf_cfg.kmeans
        if coarse is not None:
            self.centroids = as_f32(coarse[0], dev).contiguous()
            assignment = to_device(torch.as_tensor(coarse[1]), dev).to(torch.int32)
        else:
            self.centroids = coarse_pass(X, self.ivf_cfg, dev)
            assignment = chunked_assign(X, self.centroids, chunk)
        order = torch.argsort(assignment, stable=True)
        if self.quantizer.params is None:
            self.quantizer.fit(host_sample_rows(X, 200_000, kcfg.seed))
        # FLAT encode in cluster order (zero centroid: row == "residual")
        codes, norms = encode_rows_ordered(
            X, order, torch.zeros((n,), dtype=torch.int32, device=dev),
            torch.zeros((1, d), dtype=torch.float32, device=dev), self.quantizer, chunk)
        cache = self.quantizer.prepare_tile_cache(codes, norms=norms)
        if cache is None:
            raise RuntimeError(f"{self.quantizer.name} has no packed tile cache")
        if cache.perm is not None:
            raise RuntimeError("prepare_tile_cache must keep the rows' order (perm None)")
        del codes
        self.cache = cache
        self.ids_sorted = order.to(torch.int32)
        # rows are cluster-sorted, so tile t spans clusters
        # [asn_sorted[t·512], asn_sorted[min(end, n) − 1]]
        asn_sorted = assignment[order]
        starts = torch.arange(-(-n // TILE), device=dev) * TILE
        self.cl_first = asn_sorted[starts].to(torch.int32)
        self.cl_last = asn_sorted[torch.clamp(starts + TILE, max=n) - 1].to(torch.int32)
        self.num_rows = n
        self._last_tiles = None  # stale count from a previous corpus
        return self

    # --------------------------------------------------------------- search
    def _nprobe(self) -> int:
        return min(self.ivf_cfg.nprobe, int(self.centroids.shape[0]))

    def _grouped(self, queries, query_groups: Optional[int]):
        """→ (queries on the device, padded to a multiple of the group count
        by repeating the last query, the group count, the real count)."""
        q = as_f32(queries, self.device)
        nq = q.shape[0]
        ng = self.query_groups if query_groups is None else query_groups
        ng = max(1, min(int(ng), nq))
        pad = (-nq) % ng
        if pad:  # not zeros: a zero row would probe the origin's cells
            q = torch.cat([q, q[-1:].expand(pad, -1)])
        return q, ng, nq

    def _scan_group(self, q: torch.Tensor, probe: torch.Tensor, k: int):
        """One tile mask from the probes of ``q`` and one gather-kernel pass
        → maximize-form (scores, scan positions, masked-in tiles as a device
        scalar)."""
        with span("ivf.mask"):
            k_cl = int(self.centroids.shape[0])
            mask = tile_mask_from_probes(probe, self.cl_first, self.cl_last, k_cl)
        s, pos = self.quantizer.packed_scan_raw(
            q, self.cache, k, self.search_cfg.metric,
            use_bf16=self.search_cfg.use_bf16 and bf16_supported(q.device), tile_mask=mask)
        return s, pos, mask.sum()

    def _search(self, q: torch.Tensor, k: int, nprobe: int, groups: int = 1):
        """One search on the device, no host sync → (scores (Q, k) in the
        metric's form, row ids (Q, k), masked-in tiles summed over the
        ``groups`` probe-coherent groups as a device scalar).  Q must be a
        multiple of ``groups``."""
        with span("ivf.route"):
            _, probe = ordered_topk(-pairwise_sqdist_xc(q, self.centroids), nprobe)
        if groups > 1:
            # sort the batch by nearest cell, so each group's probes cohere;
            # a stable sort, as jnp.argsort: ties decide a query's group
            order = torch.argsort(probe[:, 0], stable=True)
            parts = [self._scan_group(q[g], probe[g], k)
                     for g in order.reshape(groups, -1)]
            inv = torch.argsort(order)
            s = torch.cat([p[0] for p in parts])[inv]
            pos = torch.cat([p[1] for p in parts])[inv]
            tiles = torch.stack([p[2] for p in parts]).sum()
        else:
            s, pos, tiles = self._scan_group(q, probe, k)
        with span("ivf.finalize"):
            gid = self.ids_sorted[torch.clamp(pos.long(), 0, self.ids_sorted.shape[0] - 1)]
            scores, ids = _finalize(s, gid, self.search_cfg.metric, torch.sum(q * q, dim=-1))
        return scores, ids, tiles

    def search_with_scores(self, queries, k: int = 10, query_groups: Optional[int] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """(nq, D) → ((nq, k) uint32 ids, (nq, k) scores) as numpy.
        ``query_groups`` = G > 1 runs G probe-coherent groups (module
        docstring); None takes the index's default."""
        with span("search"):
            q, ng, nq = self._grouped(queries, query_groups)
            scores, ids, tiles = self._search(q, k, self._nprobe(), ng)
            self._last_tiles = tiles  # synced only when last_tiles_scanned is read
            with span("search.fetch"):
                ids = ids[:nq].cpu().numpy()
                return np.where(ids < 0, 0, ids).astype(np.uint32), scores[:nq].cpu().numpy()

    def sustained_search_s(self, queries, k: int = 10, query_groups: Optional[int] = None,
                           reps: int = 5, outer: int = 3) -> float:
        """Best seconds per search over ``reps`` back-to-back searches that
        stay on the device, best of ``outer``, after one warm-up.  On the
        card the window is timed with CUDA events (the searches enqueue
        without a host sync, so the window holds the device's time and any
        gap the host leaves); on the CPU with the host clock."""
        q, ng, _ = self._grouped(queries, query_groups)
        nprobe = self._nprobe()
        cuda = q.device.type == "cuda"
        self._search(q, k, nprobe, ng)
        best = math.inf
        for _ in range(outer):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    self._search(q, k, nprobe, ng)
                end.record()
                end.synchronize()
                t = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                for _ in range(reps):
                    self._search(q, k, nprobe, ng)
                t = time.perf_counter() - t0
            best = min(best, t / reps)
        return best

    @property
    def last_tiles_scanned(self) -> int:
        """Tiles the last search's masks let through, summed over its query
        groups (the variance prune may skip further tiles inside the
        kernel).  Reading it syncs the device scalar."""
        return int(self._last_tiles) if self._last_tiles is not None else 0

    last_tiles_masked_in = last_tiles_scanned

    # ---------------------------------------------------------------- misc
    def memory_footprint(self) -> int:
        c = self.cache
        leaves = list(c.words) + [c.factors, c.tile_stats, self.ids_sorted, self.centroids,
                                  self.cl_first, self.cl_last]
        return (sum(nbytes_of(a) for a in leaves)
                + sum(nbytes_of(p) for p in tree_leaves(self.quantizer.params)))

    def reconstruction_mse(self, X, sample: Optional[int] = 10000) -> float:
        return self.quantizer.reconstruction_mse(X, sample)

    # ------------------------------------------------------------ save/load
    def _state(self) -> dict:
        """The packed cache is saved as it is: it is order-preserving (perm
        None), so a load needs no re-encode or re-sort."""
        c = self.cache
        return {
            "quantizer": pickle.dumps(self.quantizer),
            "ivf_cfg": self.ivf_cfg,
            "search_cfg": self.search_cfg,
            "query_groups": self.query_groups,
            "centroids": self.centroids.cpu().numpy(),
            "ids_sorted": self.ids_sorted.cpu().numpy(),
            "cl_first": self.cl_first.cpu().numpy(),
            "cl_last": self.cl_last.cpu().numpy(),
            "num_rows": self.num_rows,
            "cache": {
                "words": [w.cpu().numpy() for w in c.words],
                "factors": c.factors.cpu().numpy(),
                "tile_stats": None if c.tile_stats is None else c.tile_stats.cpu().numpy(),
                "num_rows": c.num_rows,
                "has_norms": c.has_norms,
                "prune_hint": c.prune_hint,
            },
        }

    def _restore(self, state: dict) -> None:
        self.quantizer = pickle.loads(state["quantizer"])
        self.ivf_cfg = state["ivf_cfg"]
        self.search_cfg = state["search_cfg"]
        self.query_groups = state.get("query_groups", 1)
        dev = self.device

        def t(a):
            return torch.as_tensor(a, device=dev)

        self.centroids = t(state["centroids"])
        self.ids_sorted = t(state["ids_sorted"])
        self.cl_first = t(state["cl_first"])
        self.cl_last = t(state["cl_last"])
        self.num_rows = state["num_rows"]
        cs = state["cache"]
        self.cache = PackedCorpus(
            words=tuple(t(w) for w in cs["words"]), factors=t(cs["factors"]),
            num_rows=cs["num_rows"],
            tile_stats=None if cs["tile_stats"] is None else t(cs["tile_stats"]),
            has_norms=cs["has_norms"], perm=None, prune_hint=cs["prune_hint"])
        self._last_tiles = None
