"""The packed search route of SAQ, RaBitQ and RankAware, written once.

A quantizer gives its ``PackedRoute``: its layout and its code-space query
side.  Everything else is decided here: ``packed_scan_args`` builds
``packed_scan_topk``'s keywords (the metric's kind and ``qa``, the limit,
the prune's ``qprune = [qa, ‖q_cat − centre‖]``); ``search_corpus`` and
``dense_topk`` are the dense route of each module-level ``scan_topk`` (the
use rule, the NIP norm checks, a layout built on the fly, whether the prune
fires, ``PackedCorpus.last_scan``, the ``perm`` mapping, ``_finalize``);
``PackedQuantizer`` gives the three their ``prepare_*`` methods and
``packed_scan_raw``.  ``PackedFill`` writes a layout in place chunk by
chunk (SAQ's and RaBitQ's ``prepare_packed``), with the prune's tile
stats (``tile_stats``) and hint (``prune_hint_from_stats``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from vq_tpu_torch._device import as_f32
from vq_tpu_torch.core.config import Metric
from vq_tpu_torch.kernels.adc import _finalize
from vq_tpu_torch.kernels.packed_scan import (
    MAX_K,
    TILE,
    PackedCorpus,
    SegSpec,
    packed_scan_topk,
    prune_units,
)
from vq_tpu_torch.methods.base import BaseQuantizer


class PackedRoute(NamedTuple):
    """What the packed route needs of a quantizer.  Per segment: ``segs``,
    ``lv_tables`` (None where the kernel reads no table) and ``r2_cols``
    (the factor row of its L2 shift).  ``query(queries, seg_ids)`` →
    (q_cat (Q, Σ ln) the queries in code space over those segments, q·mean
    (Q,)); ``mean_sq()`` → ‖mean‖², read by L2 only; ``centre(seg_ids)``
    → the mean in code space, read by L2's prune bound only."""

    segs: Tuple[SegSpec, ...]
    lv_tables: Tuple[Optional[torch.Tensor], ...]
    family: str  # "seg" | "rabitq": the prune bound's shape
    r2_cols: Tuple[int, ...]
    norm_col: int  # the factor row of the NIP row norm
    query: Callable[[torch.Tensor, Sequence[int]], Tuple[torch.Tensor, torch.Tensor]]
    mean_sq: Callable[[], torch.Tensor]
    centre: Callable[[Sequence[int]], torch.Tensor]


def packed_scan_args(route: PackedRoute, queries, packed: PackedCorpus, k, metric,
                     seg_ids=None, num_valid=None, use_bf16=True, prune=False) -> dict:
    """The keyword arguments of ``packed_scan_topk`` (or its plain twin) for
    a search of (a segment subset of) the corpus."""
    if seg_ids is None:
        seg_ids = tuple(range(len(route.segs)))
    q_cat, q_mean = route.query(queries, seg_ids)
    if metric == Metric.L2:
        kind, qa = "l2", 2.0 * q_mean - route.mean_sq()
    else:
        kind, qa = ("ip" if metric == Metric.IP else "nip"), q_mean
    limit = packed.num_rows if num_valid is None else min(packed.num_rows, int(num_valid))
    qprune = None
    if prune:
        # the tile stats bound the FULL reconstruction: no segment subsets
        if len(seg_ids) != len(route.segs) or packed.tile_stats is None:
            raise ValueError("prune needs every segment and a corpus with tile stats")
        b = torch.linalg.norm(q_cat - route.centre(seg_ids)[None, :] if metric == Metric.L2
                              else q_cat, dim=1)
        qprune = torch.stack([qa, b], dim=1).contiguous()
    return dict(
        q_cat=q_cat.contiguous(), qa=qa.contiguous(),
        words=tuple(packed.words[s] for s in seg_ids), factors=packed.factors,
        lv_tables=tuple(route.lv_tables[s] for s in seg_ids if route.lv_tables[s] is not None),
        segs=tuple(route.segs[s] for s in seg_ids), k=k, family=route.family,
        metric_kind=kind, norm_col=route.norm_col,
        r2_cols=tuple(route.r2_cols[s] for s in seg_ids), limit=limit, use_bf16=use_bf16,
        prune=prune, tile_stats=packed.tile_stats if prune else None, qprune=qprune)


def packed_scan(route: PackedRoute, queries, packed: PackedCorpus, k, metric, seg_ids=None,
                num_valid=None, use_bf16=True, prune=False, tile_mask=None):
    """The packed kernel over (a segment subset of) the corpus → maximize-form
    (scores, scan-position ids) [+ scanned count when prune]."""
    return packed_scan_topk(**packed_scan_args(route, queries, packed, k, metric, seg_ids,
                                               num_valid, use_bf16, prune),
                            tile_mask=tile_mask)


def _prune_on(packed: PackedCorpus, prune_tiles: Optional[bool] = None) -> bool:
    """The variance prune runs where the layout's hint says it can fire."""
    if prune_tiles is not None:
        return prune_tiles
    return packed.tile_stats is not None and packed.prune_hint


def search_corpus(packed_cache: Optional[PackedCorpus], build, n: int, k: int, metric,
                  norms=None, num_valid=None, use_packed: Optional[bool] = None
                  ) -> Optional[PackedCorpus]:
    """The layout a ``scan_topk`` call scans on the packed route, or None
    where the plain route runs (n < 512 or k > 128, unless ``use_packed``
    says).  Clears ``packed_cache.last_scan``; without a cache the layout is
    ``build(norms or None)``, with the norms only for Metric.NIP."""
    if packed_cache is not None:
        packed_cache.last_scan = {}
    if use_packed is None:
        use_packed = n >= TILE and k <= MAX_K
    if not use_packed:
        return None
    if metric == Metric.NIP:
        # a cache built without real norms would return un-normalized scores
        if packed_cache is not None and not packed_cache.has_norms:
            raise ValueError("Metric.NIP needs a packed cache built with norms")
        if packed_cache is None and norms is None:
            raise ValueError("Metric.NIP requires original row norms")
    packed = packed_cache if packed_cache is not None else build(
        norms if metric == Metric.NIP else None)
    if packed.perm is not None and num_valid is not None:
        raise ValueError("num_valid prefix masking is incompatible with a norm-ordered "
                         "(sort_rows) packed cache")
    return packed


def dense_topk(route: PackedRoute, queries: torch.Tensor, packed: PackedCorpus, k: int,
               metric, q_sq: torch.Tensor, num_valid=None, use_bf16: bool = True,
               prune_tiles: Optional[bool] = None):
    """The dense packed scan of ``search_corpus``'s layout → (Q, k) scores in
    the metric's form, (Q, k) row ids.

    ``packed.last_scan`` records its work, without a device sync:
    ``scan_units``, what a scan without the prune covers (``prune_units``:
    (query block, tile) pairs on the card, tiles in the plain twin), and
    ``tiles_scanned``, the part of it scanned (a device scalar where the
    prune ran)."""
    prune = _prune_on(packed, prune_tiles)
    out = packed_scan(route, queries, packed, k, metric, num_valid=num_valid,
                      use_bf16=use_bf16, prune=prune)
    units = prune_units(queries.shape[0], packed.factors.shape[1], queries.device,
                        use_bf16=use_bf16)
    packed.last_scan = {"scan_units": units, "tiles_scanned": out[2] if prune else units}
    ids = out[1] if packed.perm is None else packed.perm[out[1].long()]
    return _finalize(out[0], ids, metric, q_sq)


def tile_min_max(v: torch.Tensor, valid: torch.Tensor, empty_min: float, empty_max):
    """Per-512-row-tile (min, max) of v over valid rows."""
    vmin = torch.where(valid, v, torch.full_like(v, np.inf)).reshape(-1, TILE).amin(dim=1)
    vmin = torch.where(torch.isfinite(vmin), vmin, torch.full_like(vmin, empty_min))
    vmax = torch.where(valid, v, torch.zeros_like(v)).reshape(-1, TILE).amax(dim=1)
    if empty_max is not None:
        vmax = torch.where(vmax > 0, vmax, torch.full_like(vmax, empty_max))
    return vmin, vmax


def tile_stats(lo: torch.Tensor, hi: torch.Tensor, margin: torch.Tensor, n: int,
               norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(rows/512, 5) per tile of whole tiles: min of ``lo``, max of ``hi``
    (the prune's radius bounds), max ``margin``, min and max original row
    norm (1.0 without norms).  Rows ≥ n are excluded."""
    valid = torch.arange(lo.shape[0], device=lo.device) < n
    min_r = tile_min_max(lo, valid, 0.0, None)[0]
    max_r = torch.where(valid, hi, torch.zeros_like(hi)).reshape(-1, TILE).amax(dim=1)
    max_me = torch.where(valid, margin, torch.zeros_like(margin)).reshape(-1, TILE).amax(dim=1)
    if norms is None:
        min_n, max_n = torch.ones_like(min_r), torch.ones_like(max_r)
    else:
        min_n, max_n = tile_min_max(norms.to(torch.float32), valid, 1.0, 1.0)
    return torch.stack([min_r, max_r, max_me, min_n, max_n], dim=1).to(torch.float32)


def prune_hint_from_stats(stats) -> bool:
    """Can the prune bound ever fire?  Off when the across-tile spread of
    max ‖r̂‖ is under 5% of its median (host side, once per corpus)."""
    mr = np.asarray(stats[:, 1].cpu() if isinstance(stats, torch.Tensor) else stats[:, 1])
    mr = mr[mr > 0]
    if mr.size < 2:
        return False
    med = float(np.median(mr))
    if med <= 0:
        return False
    return bool((mr.max() - mr.min()) / med > 0.05)


class PackedFill:
    """The packed layout of an n-row corpus, allocated once and written in
    place chunk by chunk (``write``), so no chunk list and no second copy
    of a word plane exists.  ``convert(rows)`` turns byte rows of whole
    tiles into (per-segment words or value planes, the (F, rows) factor
    rows, and per row the prune stats' lower radius, upper radius and
    margin); factor row F is the original row norm.  At 53.2M rows and
    D=1024 a plane holds up to 6.81e9 int32 words: torch indexes it with
    64-bit offsets, the kernel with ``size_t`` ones."""

    def __init__(self, segs: Sequence[SegSpec], num_factors: int, n: int, device, nv: int,
                 convert: Callable):
        self.segs, self.n, self.nv, self.convert = tuple(segs), n, nv, convert
        n_pad = n + (-n) % TILE
        self.words = tuple(
            torch.empty((n_pad, s.ln), dtype=torch.float32, device=device)
            if s.dequant == "values" else
            torch.empty((n_pad // s.u, s.ln), dtype=torch.int32, device=device)
            for s in self.segs)
        self.factors = torch.empty((num_factors + 1, n_pad), dtype=torch.float32, device=device)
        self.stats = torch.empty((n_pad // TILE, 5), dtype=torch.float32, device=device)

    def write(self, i0: int, rows: torch.Tensor, norms: Optional[torch.Tensor] = None) -> None:
        """Byte rows for scan positions [i0, i0 + len(rows)), i0 on a tile,
        padded to whole tiles with zero rows (``limit`` masks them), and
        their original norms (None: 1.0); rows ≥ ``nv`` stay out of the
        tile stats."""
        pad = (-rows.shape[0]) % TILE
        if pad:
            rows = torch.nn.functional.pad(rows, (0, 0, 0, pad))
        i1 = i0 + rows.shape[0]
        w, f, lo, hi, margin = self.convert(rows)
        for dst, part, s in zip(self.words, w, self.segs):
            u = 1 if s.dequant == "values" else s.u
            dst[i0 // u:i1 // u] = part
        nf = f.shape[0]
        self.factors[:nf, i0:i1] = f
        nrm = self.factors[nf, i0:i1]
        nrm.fill_(1.0)
        if norms is not None:
            nrm[:norms.shape[0]] = norms.to(torch.float32)
        self.stats[i0 // TILE:i1 // TILE] = tile_stats(
            lo, hi, margin, self.nv - i0, norms=nrm if norms is not None else None)

    def corpus(self, has_norms: bool, perm=None) -> PackedCorpus:
        return PackedCorpus(words=self.words, factors=self.factors, num_rows=self.n,
                            tile_stats=self.stats, has_norms=has_norms, perm=perm,
                            prune_hint=prune_hint_from_stats(self.stats))


class PackedQuantizer(BaseQuantizer):
    """A quantizer with a packed scan layout.  A subclass gives
    ``packed_route`` and ``_pack``, and says by ``norm_order`` whether
    ``prepare_scan`` norm-orders the rows (so that tiles span narrow norm
    bands and the variance prune can fire)."""

    norm_order = False

    def packed_route(self) -> PackedRoute:
        raise NotImplementedError

    def _pack(self, codes, norms=None, sort_rows: bool = False,
              num_valid_rows: Optional[int] = None) -> Optional[PackedCorpus]:
        """Byte rows → the packed layout (None: this fit has nothing to
        scan); ``sort_rows`` and ``num_valid_rows`` as ``saq.prepare_packed``
        takes them."""
        raise NotImplementedError

    def prepare_scan(self, codes, norms=None):
        """The scan cache, built once at index fit."""
        return self._pack(codes, norms, sort_rows=self.norm_order)

    def prepare_shard_cache(self, codes, norms=None, num_valid_rows=None):
        """The per-shard cache (base contract): norm-ordered within the shard
        where ``prepare_scan`` is, with the pad rows sorted to the tail, so
        the ``num_valid`` prefix limit stays exact."""
        return self._pack(codes, norms, sort_rows=self.norm_order,
                          num_valid_rows=num_valid_rows)

    def prepare_tile_cache(self, codes, norms=None):
        """The order-preserving layout (base contract): no norm order, no
        perm; tile stats and the prune hint as for ``prepare_scan``."""
        return self._pack(codes, norms)

    def packed_scan_raw(self, queries, packed, k, metric, num_valid=None, use_bf16=True,
                        tile_mask=None):
        out = packed_scan(self.packed_route(), as_f32(queries, self.device), packed, k,
                          metric, num_valid=num_valid, use_bf16=use_bf16,
                          prune=_prune_on(packed), tile_mask=tile_mask)
        return out[0], out[1]
