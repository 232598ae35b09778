"""Packed-code scan: layout helpers, the CUDA kernel's wrapper and its plain
PyTorch twin — counterpart of ``vq_tpu/kernels/pallas_packed.py``.

The scan of every non-PQ quantizer with a packed layout (SAQ, RaBitQ,
RankAware; their one search route is ``methods/packed.py``):
per-dimension B-bit codes plus per-row float factors.  A segment's (N, ln)
indices are stored as "tile-ordered bitplane words" (``pack_words``): within
each 512-row tile, int32 word r, shift slot j holds tile-local row
j·(512/u) + r, u = 32 // b_eff.  Word rows compare byte for byte with the
JAX package's.  Dequant kinds per segment: "uniform" (the CAQ mid-rise
grid), "perdim" ((ln, 2^B) level tables), "shared" (one (1, 2^B) table) and
"values" (an (N, ln) f32 value plane, stored as it is).

Layout decisions against the JAX package:

* ``PackedCorpus.factors`` is feature-major, (F, N): one factor column of
  consecutive rows is one contiguous run on the card.  JAX's is (N, F).
* ``choose_beff``, the 512-row tile and the value-plane threshold are the
  JAX package's, so words compare byte for byte.
* ``PRUNE_MAX_TILES`` (a TPU scalar-memory cap) is dropped: the tile stats
  live in device memory.

``packed_scan_topk`` keeps JAX's arguments and return contract.  On a CUDA
tensor it launches ``csrc/packed_scan.cu`` or raises; on a CPU tensor it
runs ``packed_scan_topk_plain``.  With ``prune=True`` the third return value
counts scanned work: the plain twin counts tiles in JAX's sequence (a tile
is scanned when any query's bound reaches that query's running k-th score
over all earlier tiles), the kernel counts (query block, tile) pairs,
because its blocks run in parallel over chunks of tiles, each with its own
running top-k and the k-th scores the other blocks have published so far
(``prune_units`` gives the total of either).

Gather mode (``tile_mask``, the IVF probed-tile path): only tiles whose
mask entry is non-zero are scanned, in ascending tile order, so the result
equals a scan of the masked-in rows alone.  On the card the wrapper
compacts the mask into an ascending tile-id list and its count with torch
ops that stay on the card (no host sync), and the kernel's blocks split
that list.  With prune, a tile counts when it is masked in and its bound
survives.  ``mask_cap`` (the TPU kernel's static short-grid cap) is taken
for API parity and never changes a result; the card's grid splits the
device-side count, so it sizes nothing there.

bf16 launches take the query-tile width ``scan_width(Q)`` (64 or 128
queries a block of the wgmma kernel); f32 launches blocks of 64.
``packed_scan_topk.launches`` counts launches of the dense kernel,
``packed_scan_topk.gather_launches`` those of the gather mode,
``packed_scan_topk.launches_by_width`` the bf16 launches of either by width,
and ``packed_scan_topk.register_table_launches`` the bf16 launches in which
a segment took the register-table dequant (``register_table``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from vq_tpu_torch._device import round_bf16
from vq_tpu_torch.kernels._build import grid_chunks, merge_groups
from vq_tpu_torch.kernels.topk import ordered_topk
from vq_tpu_torch.utils.trace import span

TILE = 512  # rows per word-layout / prune tile
MAX_K = 128
_KINDS = {"uniform": 0, "perdim": 1, "shared": 2, "values": 3}
_METRICS = {"l2": 0, "ip": 1, "nip": 2}
_FAMILIES = {"seg": 0, "rabitq": 1}
_PLAIN_ELEMS = 1 << 26  # plain twin: cap on one (Q, rows) score block
SCAN_WIDTHS = (64, 128)  # query-tile widths of the bf16 kernel (csrc/packed_scan.cu)
REGISTER_TABLE_WIDTH = 64  # csrc/packed_scan.cu's kRegTableWidth


def scan_width(num_q: int) -> int:
    """The bf16 kernel's query-tile width for Q queries: the narrowest of
    ``SCAN_WIDTHS`` that covers min(Q, widest); past the widest, Q splits
    into tiles of the widest.  A block dequantizes each row once for its
    width of queries (a batch: N·D·⌈Q/width⌉ values) and holds 256 rows ×
    width queries of f32 sums (a 512-row tile in two passes).  Measured
    (H100, 1,048,576 rows of the 53M cell's segment plan, Q=1024; PERF.md):
    a 128-query tile took 8.37 ms through a 98.5% tile mask and 10.67 ms
    dense at k=100, a 256-query one (128 sums a thread) 9.76 and 13.53.
    At Q ≤ 64 (8,388,608 rows of the same plan, H100 700 W) the 64-query
    tile took 5.53-5.80 ms at Q=64 k=10 with the prune on, the 128-query
    one 7.09-7.27; at Q=8 5.12-5.16 against 6.73-6.85; at Q=64 k=100
    7.31-7.46 against 8.95-9.08.  k takes no shared memory (the top-k lists live in a global scratch), so
    the rule reads Q alone."""
    need = min(max(num_q, 1), SCAN_WIDTHS[-1])
    return next(w for w in SCAN_WIDTHS if w >= need)


def register_table(seg: "SegSpec", width: int) -> bool:
    """Whether the bf16 kernel at query-tile width ``width`` dequantizes
    ``seg`` from register tables: the "shared" kind at b_eff ≤ 4, each
    row's pre-scaled bf16 levels in registers, looked up by byte permutes
    (csrc/packed_scan.cu's ``register_table``)."""
    return seg.dequant == "shared" and seg.beff <= 4 and width <= REGISTER_TABLE_WIDTH


def _b_eff(bits: int) -> int:
    """Storage width: bits rounded up to a power of two ≤ 16."""
    for p in (1, 2, 4, 8, 16):
        if bits <= p:
            return p
    raise ValueError(f"bits={bits} too large")


def choose_beff(bits: int, ln: int) -> int:
    """Storage width for a segment: the JAX package's choice (1-bit skinny
    segments widen to 2 bits), kept so that words compare byte for byte."""
    beff = _b_eff(bits)
    while ln % 128 != 0 and TILE // (32 // beff) < 32 and beff < 16:
        beff *= 2
    return beff


class SegSpec(NamedTuple):
    """Static per-segment layout.

    bits      true code width B
    beff      storage width (power of two); u = 32 // beff rows per word
    ln        segment length in dims
    dequant   "uniform" | "perdim" | "shared" | "values"
    scale_col factor row holding the per-row scale (−1 = no scale)
    """

    bits: int
    beff: int
    ln: int
    dequant: str
    scale_col: int

    @property
    def u(self) -> int:
        return 32 // self.beff


def make_segspec(bits: int, ln: int, dequant: str, scale_col: int) -> SegSpec:
    if dequant == "values":  # (N, ln) f32 plane, no bit packing
        return SegSpec(bits, 32, ln, "values", scale_col)
    return SegSpec(bits, choose_beff(bits, ln), ln, dequant, scale_col)


class PackedCorpus:
    """Scan layout of a corpus: per-segment words (or value planes) and
    factors, rows padded to a 512 multiple (``num_rows`` is the real count).

    words       per segment: (N_pad/u, ln) int32, or (N_pad, ln) f32 values
    factors     (F, N_pad) f32, feature-major
    tile_stats  (N_pad/512, 5) f32 per tile: min ‖r̂‖, max ‖r̂‖, max CAQ
                error margin, min and max original row norm; or None
    has_norms   real row norms are in the NIP norm factor
    perm        (num_rows,) int32 scan position → corpus row id when the
                builder norm-ordered the rows; else None
    prune_hint  the tile bounds differ enough for the prune stage to fire
    last_scan   the work of the last dense scan over this layout through a
                quantizer's ``scan_topk`` (``methods/packed.py::dense_topk``;
                {} before one): ``scan_units`` and ``tiles_scanned``, as
                ``prune_units`` counts them
    """

    def __init__(self, words, factors, num_rows, tile_stats=None, has_norms=False,
                 perm=None, prune_hint=False):
        self.words = tuple(words)
        self.factors = factors
        self.num_rows = int(num_rows)
        self.tile_stats = tile_stats
        self.has_norms = bool(has_norms)
        self.perm = perm
        self.prune_hint = bool(prune_hint)
        self.last_scan: dict = {}


def pack_words(idx: torch.Tensor, bits: int, beff: Optional[int] = None) -> torch.Tensor:
    """(N, ln) indices in [0, 2^bits) → (N/u, ln) int32 tile-ordered words
    (N a multiple of 512): within each 512-row tile, word r shift slot j
    holds tile-local row j·(512/u) + r."""
    n, ln = idx.shape
    beff = _b_eff(bits) if beff is None else beff
    u = 32 // beff
    if n % TILE:
        raise ValueError(f"pack_words: N={n} must be a multiple of tile={TILE}")
    rt = TILE // u
    # tile-local transpose of the (u, rt) row grid: rows'[r·u + j] = rows[j·rt + r]
    idx = idx.to(torch.int64).reshape(n // TILE, u, rt, ln).transpose(1, 2)
    idx = idx.reshape(n // u, u, ln)
    shifts = beff * torch.arange(u, dtype=torch.int64, device=idx.device)
    acc = torch.sum(idx << shifts[None, :, None], dim=1)  # < 2^32: the bit fields are disjoint
    return torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(torch.int32)


def unpack_words(words: torch.Tensor, seg: SegSpec) -> torch.Tensor:
    """(T/u, ln) int32 tile-ordered words of whole tiles → (T, ln) int64
    indices in natural row order."""
    u, rt = seg.u, TILE // seg.u
    w = (words.to(torch.int64) & 0xFFFFFFFF).reshape(-1, 1, rt, seg.ln)
    shifts = seg.beff * torch.arange(u, dtype=torch.int64, device=words.device)
    planes = (w >> shifts[None, :, None, None]) & ((1 << seg.bits) - 1)
    return planes.reshape(-1, seg.ln)


def dequant_seg(words: torch.Tensor, seg: SegSpec, lv: Optional[torch.Tensor],
                scale: Optional[torch.Tensor]) -> torch.Tensor:
    """One segment's words (or value plane) for whole tiles → (T, ln) f32
    values, times the per-row ``scale`` (T,) when given."""
    if seg.dequant == "values":
        val = words.to(torch.float32)
    else:
        idx = unpack_words(words, seg)
        if seg.dequant == "uniform":
            val = (idx.to(torch.float32) + 0.5) * (2.0 / (1 << seg.bits)) - 1.0
        elif seg.dequant == "shared":
            val = lv.reshape(-1)[idx]
        else:  # perdim
            val = lv[torch.arange(seg.ln, device=idx.device)[None, :], idx]
    return val if scale is None else val * scale[:, None]


def _tile_bound(stats_t, qprune, family: str, metric_kind: str) -> torch.Tensor:
    """(Q,) upper bound on every maximize-form score in one tile."""
    rmin, rmax, me = stats_t[0], stats_t[1], stats_t[2]
    a, b = qprune[:, 0], qprune[:, 1]
    if metric_kind == "l2" and family == "seg":
        c = torch.minimum(torch.maximum(b, rmin), rmax)
        return a + b * b - (b - c) * (b - c) + 2.0 * b * me
    if metric_kind == "l2":
        return a - rmin * rmin + 2.0 * b * (rmax + me)
    u = a + b * (rmax + me)
    if metric_kind == "nip":
        return torch.maximum(u / torch.clamp(stats_t[3], min=1e-30),
                             u / torch.clamp(stats_t[4], min=1e-30))
    return u


def _score_rows(q, qa, words, factors, lv_tables, segs, r0, r1, metric_kind, norm_col,
                r2_cols, limit, use_bf16) -> torch.Tensor:
    """(Q, r1 − r0) maximize-form scores of rows [r0, r1) (whole tiles)."""
    parts, li = [], 0
    for w, seg in zip(words, segs):
        lv = None
        if seg.dequant in ("perdim", "shared"):
            lv, li = lv_tables[li], li + 1
        rows = w[r0:r1] if seg.dequant == "values" else w[r0 // seg.u:r1 // seg.u]
        scale = factors[seg.scale_col, r0:r1] if seg.scale_col >= 0 else None
        parts.append(dequant_seg(rows, seg, lv, scale))
    ohat = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    ip = q @ (round_bf16(ohat) if use_bf16 else ohat).T
    qa = qa[:, None]
    if metric_kind == "l2":
        shift = factors[r2_cols[0], r0:r1]
        for c in r2_cols[1:]:
            shift = shift + factors[c, r0:r1]
        s = 2.0 * ip + qa - shift[None, :]
    elif metric_kind == "ip":
        s = ip + qa
    else:
        s = (ip + qa) / torch.clamp(factors[norm_col, r0:r1], min=1e-30)[None, :]
    col = torch.arange(r0, r1, device=s.device)
    return torch.where(col[None, :] < limit, s, torch.full_like(s, -math.inf))


def _tile_runs(tiles: Sequence[int]):
    """Ascending tile ids → [(first, last + 1)] runs of consecutive tiles."""
    runs = []
    for t in tiles:
        if runs and runs[-1][1] == t:
            runs[-1][1] = t + 1
        else:
            runs.append([t, t + 1])
    return runs


def _fold(best, s, r0, k):
    ids = torch.arange(r0, r0 + s.shape[1], device=s.device)
    if best is not None:
        s = torch.cat([best[0], s], dim=1)
        ids = torch.cat([best[1].to(torch.int64), ids.expand(s.shape[0], -1)], dim=1)
    return ordered_topk(s, min(k, s.shape[1]), ids)


def packed_scan_topk_plain(q_cat, qa, words, factors, lv_tables, segs, k: int,
                           family: str = "seg", metric_kind: str = "l2",
                           norm_col: int = -1, r2_cols: Sequence[int] = (),
                           limit: Optional[int] = None, use_bf16: bool = True,
                           prune: bool = False, tile_stats=None, qprune=None,
                           tile_mask=None, mask_cap=None):
    """Plain PyTorch version of ``packed_scan_topk`` (same arguments and
    results).  Dense: the corpus in blocks of whole tiles, each block's
    top-k folded into a running one.  Prune: tile by tile in order, a tile
    scanned when any query's bound reaches its running k-th score (JAX's
    sequence), and the count of tiles scanned returned third.  With
    ``tile_mask`` only the masked-in tiles, in ascending order, take part
    (in the prune sequence too); ``mask_cap`` is ignored."""
    del mask_cap  # a TPU grid-length cap: never changes the result
    n = factors.shape[1]
    num_q = q_cat.shape[0]
    lim = n if limit is None else int(limit)
    q = q_cat.to(torch.float32)
    q = round_bf16(q) if use_bf16 else q
    qa = qa.to(torch.float32)
    args = (q, qa, words, factors, lv_tables, segs)
    best, scanned = None, 0
    tiles = list(range(n // TILE))
    if tile_mask is not None:
        tiles = torch.nonzero(tile_mask.reshape(-1) != 0).reshape(-1).tolist()
    if prune:
        for t in tiles:
            kth = (best[0][:, k - 1] if best is not None and best[0].shape[1] >= k
                   else torch.full((num_q,), -math.inf, device=q.device))
            if not bool((_tile_bound(tile_stats[t], qprune, family, metric_kind) >= kth).any()):
                continue
            scanned += 1
            s = _score_rows(*args, t * TILE, (t + 1) * TILE, metric_kind, norm_col, r2_cols,
                            lim, use_bf16)
            best = _fold(best, s, t * TILE, k)
    else:
        step = max(TILE, _PLAIN_ELEMS // max(num_q, 1) // TILE * TILE)
        for t0, t1 in _tile_runs(tiles):
            for r0 in range(t0 * TILE, t1 * TILE, step):
                r1 = min(t1 * TILE, r0 + step)
                s = _score_rows(*args, r0, r1, metric_kind, norm_col, r2_cols, lim, use_bf16)
                best = _fold(best, s, r0, k)
    if best is None or best[0].shape[1] < k:  # nothing scanned / fewer rows than k
        have = 0 if best is None else best[0].shape[1]
        pad_s = torch.full((num_q, k - have), -math.inf, device=q.device)
        pad_i = torch.zeros((num_q, k - have), dtype=torch.int32, device=q.device)
        best = ((pad_s, pad_i) if best is None else
                (torch.cat([best[0], pad_s], 1), torch.cat([best[1], pad_i], 1)))
    ts, ti = best
    ti = torch.where(ts > -math.inf, ti, torch.zeros_like(ti))
    if prune:
        return ts, ti, torch.tensor(scanned, dtype=torch.int32, device=q.device)
    return ts, ti


# ------------------------------------------------------------------- wrapper
def prune_units(num_q: int, n_pad: int, device, tiles: Optional[int] = None,
                use_bf16: bool = True) -> int:
    """The total the prune count is a part of: tiles (plain twin), or
    (query block, tile) pairs (the CUDA kernels: blocks of ``scan_width(Q)``
    queries in bf16, of 64 in f32); ``tiles`` = the masked-in count of a
    gather-mode scan (default: every tile)."""
    nb = n_pad // TILE if tiles is None else int(tiles)
    if torch.device(device).type != "cuda":
        return nb
    if use_bf16:
        return -(-num_q // scan_width(num_q)) * nb
    from vq_tpu_torch.kernels._build import load_library

    return -(-num_q // load_library().vq_packed_queries_per_block()) * nb


def _check(name, t, dev, dtype, shape):
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, factors on {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def _check_inputs(q_cat, qa, words, factors, lv_tables, segs, k, metric_kind, family,
                  norm_col, r2_cols, prune, tile_stats, qprune, tile_mask=None):
    dev = factors.device
    num_q, d = q_cat.shape
    nf, n = factors.shape
    if n % TILE:
        raise ValueError(f"factors has {n} rows, not a multiple of {TILE}")
    if not 0 < k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    if metric_kind not in _METRICS or family not in _FAMILIES:
        raise ValueError(f"metric_kind={metric_kind!r}, family={family!r}")
    if len(words) != len(segs) or sum(s.ln for s in segs) != d:
        raise ValueError("segments disagree with the words or the query width")
    _check("q_cat", q_cat, dev, torch.float32, (num_q, d))
    _check("qa", qa, dev, torch.float32, (num_q,))
    _check("factors", factors, dev, torch.float32, (nf, n))
    li = 0
    for w, seg in zip(words, segs):
        if seg.dequant not in _KINDS:
            raise ValueError(f"dequant {seg.dequant!r}")
        if seg.dequant == "values":
            _check("value plane", w, dev, torch.float32, (n, seg.ln))
        else:
            _check("words", w, dev, torch.int32, (n // seg.u, seg.ln))
        if seg.dequant in ("perdim", "shared"):
            if li >= len(lv_tables):
                raise ValueError("fewer level tables than table segments")
            rows = seg.ln if seg.dequant == "perdim" else 1
            _check("level table", lv_tables[li], dev, torch.float32, (rows, 1 << seg.bits))
            li += 1
        if seg.scale_col >= nf:
            raise ValueError(f"scale_col {seg.scale_col} ≥ {nf} factor rows")
    if li != len(lv_tables):
        raise ValueError("more level tables than table segments")
    if metric_kind == "l2" and not (r2_cols and all(0 <= c < nf for c in r2_cols)):
        raise ValueError(f"r2_cols {r2_cols} invalid for {nf} factor rows")
    if metric_kind == "nip" and not 0 <= norm_col < nf:
        raise ValueError(f"norm_col {norm_col} invalid for {nf} factor rows")
    if prune:
        if tile_stats is None or qprune is None:
            raise ValueError("prune=True needs tile_stats and qprune")
        _check("tile_stats", tile_stats, dev, torch.float32, (n // TILE, 5))
        _check("qprune", qprune, dev, torch.float32, (num_q, 2))
    if tile_mask is not None:
        if tuple(tile_mask.shape) != (n // TILE,) or tile_mask.is_floating_point():
            raise ValueError(f"tile_mask must be an integer or bool tensor of shape "
                             f"({n // TILE},), got {tile_mask.dtype} {tuple(tile_mask.shape)}")


def _chunks(lib, device, desc: np.ndarray, use_bf16: bool, num_q: int, nb: int, k: int,
            width: int, metric_kind: str, n_r2: int) -> int:
    """``grid_chunks`` at the resident blocks per SM that the library
    reports for this launch (its shared memory depends on the mode, the
    width, the segments, the factor columns and the level tables)."""
    per_sm = lib.vq_packed_blocks_per_sm(desc.ctypes.data, desc.shape[0], int(use_bf16), width,
                                         _METRICS[metric_kind], n_r2)
    if per_sm < 1:
        raise RuntimeError("packed_scan_topk: no block fits on an SM at this launch's "
                           "shared memory")
    slots = torch.cuda.get_device_properties(device).multi_processor_count * per_sm
    return grid_chunks(slots, -(-num_q // width), nb, lib.vq_merge_cap(), k)


def compact_tile_mask(tile_mask: torch.Tensor):
    """(nb,) mask → ((nb,) i32 tile ids, masked-in ones first in ascending
    order; (1,) i32 their count), by a stable sort on the mask's device --
    JAX's ``argsort(~mask)`` -- with no host sync."""
    m = tile_mask != 0
    cnt = m.sum(dtype=torch.int32).reshape(1)
    ids = torch.sort((~m).to(torch.uint8), stable=True).indices.to(torch.int32)
    return ids, cnt


def packed_scan_topk(q_cat, qa, words, factors, lv_tables, segs, k: int,
                     family: str = "seg", metric_kind: str = "l2", norm_col: int = -1,
                     r2_cols: Sequence[int] = (), limit: Optional[int] = None,
                     use_bf16: bool = True, prune: bool = False, tile_stats=None,
                     qprune=None, tile_mask=None, mask_cap=None):
    """Fused unpack+dequant+score+top-k → ((Q, k) f32 maximize-form,
    (Q, k) i32) [+ scanned count when ``prune``].

    q_cat   (Q, D) f32 queries pre-rotated into code space (D = Σ ln_s)
    qa      (Q,) f32 per-query additive term
    words   per segment: (N/u, ln) int32 tile-ordered words, or (N, ln) f32
            for "values"; N % 512 == 0, pad rows masked by ``limit``
    factors (F, N) f32 per-row factors, feature-major: per-segment scales
            (scale_col), L2 row shifts (r2_cols, summed), the NIP row norm
            (norm_col)
    lv_tables one per "perdim" ((ln, 2^B)) or "shared" ((1, 2^B)) segment
    family  "seg" | "rabitq": the prune bound's shape
    prune   skip tiles whose score bound (tile_stats (N/512, 5), qprune
            (Q, 2) = per-query (A, B)) is below every query's running k-th
    tile_mask (N/512,) integer or bool: scan only the tiles with a non-zero
            entry (the gather mode); mask_cap is accepted and ignored
    """
    with span("packed.scan"):
        r2_cols = tuple(int(c) for c in r2_cols)
        dev = factors.device
        if tile_mask is not None and tile_mask.device != dev:
            raise ValueError(f"tile_mask on {tile_mask.device}, factors on {dev}")
        if dev.type == "cpu":
            return packed_scan_topk_plain(q_cat, qa, words, factors, lv_tables, segs, k, family,
                                          metric_kind, norm_col, r2_cols, limit, use_bf16, prune,
                                          tile_stats, qprune, tile_mask, mask_cap)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        _check_inputs(q_cat, qa, words, factors, lv_tables, segs, k, metric_kind, family,
                      norm_col, r2_cols, prune, tile_stats, qprune, tile_mask)
        # the CUDA runtime launches (and answers occupancy queries) on the
        # current device: the mask compaction, the scan and the merge run under
        # the tensors' own
        with torch.cuda.device(dev):
            return _launch(q_cat, qa, words, factors, lv_tables, segs, k, family, metric_kind,
                           norm_col, r2_cols, limit, use_bf16, prune, tile_stats, qprune,
                           tile_mask)


def _launch(q_cat, qa, words, factors, lv_tables, segs, k, family, metric_kind, norm_col,
            r2_cols, limit, use_bf16, prune, tile_stats, qprune, tile_mask):
    """``packed_scan_topk`` on checked CUDA inputs, under their device."""
    from vq_tpu_torch.kernels._build import check, load_library

    dev = factors.device
    lib = load_library()
    if len(segs) > lib.vq_packed_max_segments():
        raise ValueError(f"{len(segs)} segments > {lib.vq_packed_max_segments()}")
    num_q = q_cat.shape[0]
    n = factors.shape[1]
    lim = n if limit is None else max(0, min(n, int(limit)))
    out_s = torch.empty((num_q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((num_q, k), dtype=torch.int32, device=dev)
    scanned = torch.zeros((1,), dtype=torch.int32, device=dev)
    if num_q == 0:  # an empty grid is not a launch
        return (out_s, out_i, scanned[0]) if prune else (out_s, out_i)
    desc = np.zeros((len(segs), 8), dtype=np.int64)
    li = 0
    for s, (w, seg) in enumerate(zip(words, segs)):
        lv_ptr = 0
        if seg.dequant in ("perdim", "shared"):
            lv_ptr, li = lv_tables[li].data_ptr(), li + 1
        desc[s] = (w.data_ptr(), lv_ptr, seg.bits, seg.beff, seg.ln, _KINDS[seg.dequant],
                   seg.scale_col, 0)
    r2 = np.asarray(r2_cols or (0,), dtype=np.int32)
    width = scan_width(num_q) if use_bf16 else lib.vq_packed_queries_per_block()
    chunks = _chunks(lib, dev, desc, use_bf16, num_q, n // TILE, k, width, metric_kind,
                     len(r2_cols))
    ncand = num_q * (chunks + merge_groups(chunks, lib.vq_merge_cap(), k)) * k
    cand_s = torch.empty((ncand,), dtype=torch.float32, device=dev)
    cand_i = torch.empty((ncand,), dtype=torch.int32, device=dev)
    kth_g = torch.full((num_q,), lib.vq_ordered_neg_inf(), dtype=torch.int32, device=dev)
    stats_ptr = tile_stats.data_ptr() if prune else 0
    qprune_ptr = qprune.data_ptr() if prune else 0
    tiles_ptr = cnt_ptr = 0
    if tile_mask is not None:
        tile_ids, cnt = compact_tile_mask(tile_mask)
        tiles_ptr, cnt_ptr = tile_ids.data_ptr(), cnt.data_ptr()
    q16_ptr = fold_s_ptr = fold_i_ptr = 0
    if use_bf16:
        # scratch: the bf16-rounded, zero-padded query tiles; each block's
        # top-k lists and candidates
        qblocks, kd = -(-num_q // width), lib.vq_packed_stage_dims()
        q16 = torch.empty((qblocks * width, sum(-(-s.ln // kd) * kd for s in segs)),
                          dtype=torch.bfloat16, device=dev)
        nfold = qblocks * chunks * width * (k + lib.vq_packed_fold_slots())
        fold_s = torch.empty((nfold,), dtype=torch.float32, device=dev)
        fold_i = torch.empty((nfold,), dtype=torch.int32, device=dev)
        q16_ptr, fold_s_ptr, fold_i_ptr = q16.data_ptr(), fold_s.data_ptr(), fold_i.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.vq_packed_scan_topk(
        q_cat.data_ptr(), q16_ptr, qa.data_ptr(), factors.data_ptr(), stats_ptr, qprune_ptr,
        desc.ctypes.data, len(segs), r2.ctypes.data, len(r2_cols), cand_s.data_ptr(),
        cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), scanned.data_ptr(),
        kth_g.data_ptr(), tiles_ptr, cnt_ptr, fold_s_ptr, fold_i_ptr, num_q,
        q_cat.shape[1], n, k, lim, _METRICS[metric_kind], _FAMILIES[family], norm_col,
        int(prune), int(use_bf16), width, chunks, stream), "vq_packed_scan_topk")
    if tile_mask is None:
        packed_scan_topk.launches += 1
    else:
        packed_scan_topk.gather_launches += 1
    if use_bf16:
        by_width = packed_scan_topk.launches_by_width
        by_width[width] = by_width.get(width, 0) + 1
        packed_scan_topk.register_table_launches += any(register_table(seg, width)
                                                        for seg in segs)
    if prune:
        return out_s, out_i, scanned[0]
    return out_s, out_i


packed_scan_topk.launches = 0
packed_scan_topk.gather_launches = 0
packed_scan_topk.launches_by_width = {}
packed_scan_topk.register_table_launches = 0


def reset_launch_counts() -> None:
    packed_scan_topk.launches = 0
    packed_scan_topk.gather_launches = 0
    packed_scan_topk.launches_by_width = {}
    packed_scan_topk.register_table_launches = 0
