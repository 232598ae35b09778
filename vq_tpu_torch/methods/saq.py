"""SAQ — variance-aware segmented CAQ quantization — counterpart of
``vq_tpu/methods/saq.py``.

  fit:    (optional) PCA → per-dim variance → empirical per-block MSE table
          of the uniform CAQ encoder → greedy or DP bit allocation over
          64-dim blocks (the port's native allocators first, ``native/``)
          → equal-bit blocks merged into segments → per-segment seeded
          random rotations (numpy QR, so they equal the JAX package's).
  encode: per segment: slice + rotate + CAQ encode + bit-pack; row layout
          [seg codes...][rescale f32 × S][o_l2norm f32 × S], byte-identical
          to the JAX package's.
  search: queries are PCA-projected and segment-rotated once; the packed
          route (``methods/packed.py`` over ``prepare_packed``'s layout and
          ``kernels/packed_scan.py``) scans tile-ordered words with the
          hand-written CUDA kernel on a card; ``use_packed=False`` or
          k > 128 takes the plain streaming scan.
          ``prune_segments`` > 0 runs the head-segment cascade
          (``scan_topk``, ``_saq_rerank``; off by default, as in the JAX
          package, where it lost every TPU measurement).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch.core.config import Metric, SAQConfig
from vq_tpu_torch import native
from vq_tpu_torch._device import as_f32, bf16_supported, device_of, round_bf16, to_device
from vq_tpu_torch.core.packing import (
    bytes_to_f32,
    f32_to_bytes,
    pack_bits,
    packed_bytes,
    unpack_bits,
)
from vq_tpu_torch.data.sampling import host_sample_rows
from vq_tpu_torch.kernels.adc import _col_mask, _finalize, _nip_norms, _streaming_topk
from vq_tpu_torch.kernels.adc import maximize_scores
from vq_tpu_torch.kernels.caq import (
    _CONST_EPSILON,
    caq_decode,
    caq_decode_levels,
    caq_encode,
    caq_encode_levels,
)
from vq_tpu_torch.kernels.lloyd1d import lloyd_1d_columns, lloyd_1d_sorted
from vq_tpu_torch.kernels.packed_scan import MAX_K, TILE, PackedCorpus, make_segspec, pack_words
from vq_tpu_torch.kernels.topk import ordered_topk
from vq_tpu_torch.methods.packed import (
    PackedFill,
    PackedQuantizer,
    PackedRoute,
    dense_topk,
    packed_scan,
    search_corpus,
    tile_stats,
)

_ENCODE_CHUNK = 65536  # rows per encode step (bounds the CAQ temporaries)


@dataclass(frozen=True)
class SAQPlan:
    """Static quantization plan: per-segment (start, length, bits) over the
    PCA-rotated, variance-descending dimension order."""

    dim: int
    seg_starts: Tuple[int, ...]
    seg_lens: Tuple[int, ...]
    seg_bits: Tuple[int, ...]

    @property
    def num_segments(self) -> int:
        return len(self.seg_starts)

    @property
    def code_bytes(self) -> int:
        return sum(packed_bytes(l, b) for l, b in zip(self.seg_lens, self.seg_bits)) + \
            8 * self.num_segments


class SAQParams(NamedTuple):
    pca_mean: torch.Tensor  # (D,)
    pca_rot: torch.Tensor  # (D, D) orthogonal (identity when use_pca=False)
    seg_rots: Tuple[torch.Tensor, ...]  # per-segment (len, len) rotations
    # per-segment (len, 2^bits) sorted level tables for codebook "lloyd" /
    # "exact"; empty for the uniform CAQ grid
    seg_levels: Tuple[torch.Tensor, ...] = ()


# ---------------------------------------------------------------------------
# fit: PCA, MSE table, allocation
# ---------------------------------------------------------------------------


def _pca(x: torch.Tensor):
    """mean, rotation (descending eigenvalue order), variances."""
    mean = torch.mean(x, dim=0)
    xc = x - mean
    w, v = torch.linalg.eigh(xc.T @ xc / x.shape[0])  # ascending
    order = torch.argsort(-w, stable=True)
    return mean, v[:, order].contiguous(), w[order]


def _blocks_table(xb: torch.Tensor, rots: torch.Tensor, mb: int) -> torch.Tensor:
    """(nb, n, L) × (nb, L, L) → (nb, L, mb+1): per-dim MSE of the uniform
    CAQ encoder (rotation, per-vector range, mid-rise codes, rescale) at
    each width 0..mb, all blocks at once."""
    o = torch.bmm(xb, rots)
    v_mx = torch.clamp(torch.amax(torch.abs(o), dim=2, keepdim=True), min=1e-20)
    ou = o / v_mx
    out = [torch.mean(o * o, dim=1)]  # b = 0: MSE = E[x²]
    for b in range(1, mb + 1):
        delta = 2.0 / (1 << b)
        codes = torch.clamp(torch.floor((ou + 1.0) / delta), 0, (1 << b) - 1)
        oau = (codes + 0.5) * delta - 1.0
        ip = torch.sum(ou * oau, dim=2)
        ousq = torch.sum(ou * ou, dim=2)
        rescale = torch.where(torch.abs(ip) > 1e-20, ousq / ip, torch.zeros_like(ip))
        oa = oau * rescale[..., None] * v_mx
        out.append(torch.mean((o - oa) ** 2, dim=1))
    return torch.stack(out, dim=2)


def _uniform_caq_mse_table(x_rot: torch.Tensor, max_bits: int, block_dims: int,
                           seed: int = 0) -> np.ndarray:
    """Empirical per-dim MSE at each bit width 0..max_bits under the CAQ
    encoder the segments use, with the JAX package's numpy-seeded block
    rotations → (D, max_bits+1) numpy; only block sums feed the allocators."""
    d = x_rot.shape[1]
    rng = np.random.default_rng(seed)
    nfull, rem = d // block_dims, d % block_dims
    dev = x_rot.device
    cols = []
    if nfull:
        rots = np.stack([np.linalg.qr(rng.standard_normal((block_dims, block_dims)))[0]
                         for _ in range(nfull)]).astype(np.float32)
        xb = x_rot[:, : nfull * block_dims].reshape(-1, nfull, block_dims).transpose(0, 1)
        t = _blocks_table(xb.contiguous(), torch.from_numpy(rots).to(dev), max_bits)
        cols.append(t.reshape(nfull * block_dims, max_bits + 1).cpu().numpy())
    if rem:
        r = np.linalg.qr(rng.standard_normal((rem, rem)))[0].astype(np.float32)
        xb = x_rot[:, nfull * block_dims:][None].contiguous()
        t = _blocks_table(xb, torch.from_numpy(r)[None].to(dev), max_bits)
        cols.append(t.reshape(rem, max_bits + 1).cpu().numpy())
    return np.concatenate(cols, axis=0)


def _allocate_greedy(block_mse: np.ndarray, block_lens: np.ndarray, budget_bits: int,
                     max_bits: int) -> np.ndarray:
    """Greedy marginal-gain allocation: repeatedly grant +1 bit/dim to the
    block with the best ΔMSE per bit."""
    nb = len(block_lens)
    bits = np.zeros(nb, dtype=np.int64)
    spent = 0
    while True:
        gains = np.full(nb, -np.inf)
        for i in range(nb):
            b = bits[i]
            if b < max_bits and spent + block_lens[i] <= budget_bits:
                gains[i] = (block_mse[i, b] - block_mse[i, b + 1]) / block_lens[i]
        best = int(np.argmax(gains))
        if not np.isfinite(gains[best]) or gains[best] <= 0:
            break
        bits[best] += 1
        spent += int(block_lens[best])
    return bits


def _allocate_dp(block_mse: np.ndarray, block_lens: np.ndarray, budget_bits: int,
                 max_bits: int) -> np.ndarray:
    """Exact DP over (block, spent bits) minimizing the total MSE."""
    nb = len(block_lens)
    dp = np.full(budget_bits + 1, np.inf)
    dp[0] = 0.0
    choice = np.zeros((nb, budget_bits + 1), dtype=np.int64)
    for i in range(nb):
        ndp = np.full(budget_bits + 1, np.inf)
        nch = np.zeros(budget_bits + 1, dtype=np.int64)
        for b in range(0, max_bits + 1):
            cost_bits = b * int(block_lens[i])
            if cost_bits > budget_bits:
                break
            cand = dp[: budget_bits + 1 - cost_bits] + block_mse[i, b]
            sl = np.s_[cost_bits: budget_bits + 1]
            upd = cand < ndp[sl]
            ndp[sl] = np.where(upd, cand, ndp[sl])
            nch[sl] = np.where(upd, b, nch[sl])
        dp = ndp
        choice[i] = nch
    j = int(np.argmin(dp))
    bits = np.zeros(nb, dtype=np.int64)
    for i in range(nb - 1, -1, -1):
        b = int(choice[i, j])
        bits[i] = b
        j -= b * int(block_lens[i])
    return bits


def make_plan(variances: np.ndarray, mse_table: np.ndarray, cfg: SAQConfig) -> SAQPlan:
    """Build the segment plan from per-dim stats (host-side scalar work)."""
    d = len(variances)
    block = cfg.block_dims
    nb = (d + block - 1) // block
    block_lens = np.array([min(block, d - i * block) for i in range(nb)], dtype=np.int64)
    block_mse = np.stack([mse_table[i * block: i * block + block_lens[i]].sum(axis=0)
                          for i in range(nb)])
    total_budget = int(round(cfg.bits_per_dim * d))
    if cfg.allocator == "uniform":
        b = max(1, min(cfg.max_bits, int(round(cfg.bits_per_dim))))
        bits = np.full(nb, b, dtype=np.int64)
    elif cfg.allocator == "dp":
        bits = native.allocate_dp_native(block_mse, block_lens, total_budget, cfg.max_bits)
        if bits is None:
            bits = _allocate_dp(block_mse, block_lens, total_budget, cfg.max_bits)
    else:
        bits = native.allocate_greedy_native(block_mse, block_lens, total_budget, cfg.max_bits)
        if bits is None:
            bits = _allocate_greedy(block_mse, block_lens, total_budget, cfg.max_bits)

    # merge adjacent equal-bit blocks into segments; drop 0-bit blocks
    seg_starts: List[int] = []
    seg_lens: List[int] = []
    seg_bits: List[int] = []
    pos = 0
    for i in range(nb):
        ln, b = int(block_lens[i]), int(bits[i])
        if b > 0:
            if seg_bits and seg_bits[-1] == b and seg_starts[-1] + seg_lens[-1] == pos:
                seg_lens[-1] += ln
            else:
                seg_starts.append(pos)
                seg_lens.append(ln)
                seg_bits.append(b)
        pos += ln
    if not seg_starts:  # degenerate budget → at least one 1-bit segment
        seg_starts, seg_lens, seg_bits = [0], [min(block, d)], [1]
    return SAQPlan(dim=d, seg_starts=tuple(seg_starts), seg_lens=tuple(seg_lens),
                   seg_bits=tuple(seg_bits))


def _codebook_exact(col: np.ndarray, num_levels: int, sample_cap: int, seed: int) -> np.ndarray:
    """Optimal 1-D levels by the port's native DP (``native/``); without the
    native library, the port's own Lloyd on the same sorted sample."""
    x = np.asarray(col, dtype=np.float32).ravel()
    levels = native.codebook_exact(x, num_levels, sample_cap=sample_cap, seed=seed) \
        if len(x) > 0 else None
    if levels is not None:
        return levels
    if len(x) > sample_cap:
        x = np.random.default_rng(seed).choice(x, sample_cap, replace=False)
    return lloyd_1d_sorted(torch.from_numpy(np.sort(x)), num_levels, iters=100).numpy()


def fit(x, cfg: SAQConfig, sample_cap: int = 200_000, device=None) -> Tuple[SAQPlan, SAQParams]:
    """Plan and params from ≤ sample_cap rows of x, sampled before anything
    moves to ``device`` (default: x's device, or the card for host data)."""
    device = device_of(x, device)
    xs = as_f32(host_sample_rows(x, sample_cap, cfg.seed), device)
    d = xs.shape[1]
    if cfg.use_pca:
        mean, rot, variances = _pca(xs)
    else:
        mean = torch.zeros((d,), dtype=torch.float32, device=device)
        rot = torch.eye(d, dtype=torch.float32, device=device)
        variances = torch.var(xs, dim=0, unbiased=False)
    x_rot = (xs - mean) @ rot
    mse_table = _uniform_caq_mse_table(x_rot, cfg.max_bits, cfg.block_dims, cfg.seed)
    plan = make_plan(variances.cpu().numpy(), mse_table, cfg)

    rng = np.random.default_rng(cfg.seed)
    seg_rots = tuple(
        torch.from_numpy(np.linalg.qr(rng.standard_normal((l, l)))[0].astype(np.float32))
        .to(device) for l in plan.seg_lens)

    seg_levels: Tuple[torch.Tensor, ...] = ()
    if cfg.codebook != "uniform":
        # data-fit levels at the allocated widths, on the rotated sample
        levels = []
        for s in range(plan.num_segments):
            st, ln, b = plan.seg_starts[s], plan.seg_lens[s], plan.seg_bits[s]
            o = x_rot[:, st: st + ln] @ seg_rots[s]
            if cfg.codebook == "exact":
                on = o.cpu().numpy()
                lv = np.stack([_codebook_exact(on[:, dd], 1 << b, 16384, cfg.seed)
                               for dd in range(ln)])
                levels.append(torch.from_numpy(lv.astype(np.float32)).to(device))
            else:  # lloyd
                levels.append(lloyd_1d_columns(o, 1 << b).contiguous())
        seg_levels = tuple(levels)
    return plan, SAQParams(pca_mean=mean, pca_rot=rot, seg_rots=seg_rots,
                           seg_levels=seg_levels)


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------


def _seg_dequant(params: SAQParams, plan: SAQPlan, s: int, idx: torch.Tensor,
                 rescale: torch.Tensor) -> torch.Tensor:
    """One segment's code indices → values (uniform grid or derived levels),
    per-vector rescale applied."""
    if params.seg_levels:
        return caq_decode_levels(idx, rescale, params.seg_levels[s])
    return caq_decode(idx, rescale, plan.seg_bits[s])


def encode(plan: SAQPlan, params: SAQParams, x, caq_rounds: int = 6,
           chunk: int = _ENCODE_CHUNK) -> torch.Tensor:
    """(N, D) → (N, code_bytes) uint8 rows on the params' device, encoded
    chunk by chunk (rows are independent)."""
    dev = params.pca_mean.device
    n = x.shape[0]
    out = torch.empty((n, plan.code_bytes), dtype=torch.uint8, device=dev)
    for st0 in range(0, n, chunk):
        xp = (as_f32(x[st0: st0 + chunk], dev) - params.pca_mean) @ params.pca_rot
        packed, rescales, norms = [], [], []
        for s in range(plan.num_segments):
            st, ln, b = plan.seg_starts[s], plan.seg_lens[s], plan.seg_bits[s]
            o = xp[:, st: st + ln] @ params.seg_rots[s]
            caq = (caq_encode_levels(o, params.seg_levels[s], rounds=caq_rounds)
                   if params.seg_levels else caq_encode(o, b, rounds=caq_rounds))
            packed.append(pack_bits(caq.codes, b))
            rescales.append(f32_to_bytes(caq.rescale))
            norms.append(f32_to_bytes(caq.o_l2norm))
        out[st0: st0 + xp.shape[0]] = torch.cat(packed + rescales + norms, dim=1)
    return out


def _split_row(plan: SAQPlan, codes: torch.Tensor):
    """Slice a code-row batch into per-segment (packed, rescale, norm)."""
    offs, pos = [], 0
    for s in range(plan.num_segments):
        nb = packed_bytes(plan.seg_lens[s], plan.seg_bits[s])
        offs.append((pos, nb))
        pos += nb
    npos = pos + 4 * plan.num_segments
    return [(codes[:, p: p + nb], bytes_to_f32(codes[:, pos + 4 * s: pos + 4 * s + 4]),
             bytes_to_f32(codes[:, npos + 4 * s: npos + 4 * s + 4]))
            for s, (p, nb) in enumerate(offs)]


def decode(plan: SAQPlan, params: SAQParams, codes: torch.Tensor) -> torch.Tensor:
    xp = torch.zeros((codes.shape[0], plan.dim), dtype=torch.float32, device=codes.device)
    for s, (packed, rescale, _nrm) in enumerate(_split_row(plan, codes)):
        st, ln, b = plan.seg_starts[s], plan.seg_lens[s], plan.seg_bits[s]
        o_hat = _seg_dequant(params, plan, s, unpack_bits(packed, b, ln), rescale)
        xp[:, st: st + ln] = o_hat @ params.seg_rots[s].T
    return xp @ params.pca_rot.T + params.pca_mean


# ---------------------------------------------------------------------------
# packed-word scan layout (kernels/packed_scan.py)
# ---------------------------------------------------------------------------


# Derived-codebook segments at B ≥ this width store the f32 value plane (the
# JAX package's threshold, kept so that layouts compare byte for byte)
_VALUES_MIN_BITS = 5


def packed_segspecs(plan: SAQPlan, params: SAQParams):
    """→ (segspecs, per-SEGMENT level tables, None where the kernel needs
    none).  Factor row s carries segment s's rescale (scale_col=s)."""
    segs, lv_list = [], []
    for s in range(plan.num_segments):
        ln, b = plan.seg_lens[s], plan.seg_bits[s]
        if params.seg_levels and b >= _VALUES_MIN_BITS:
            segs.append(make_segspec(b, ln, "values", s))
            lv_list.append(None)
        elif params.seg_levels:
            segs.append(make_segspec(b, ln, "perdim", s))
            lv_list.append(params.seg_levels[s])
        else:
            segs.append(make_segspec(b, ln, "uniform", s))
            lv_list.append(None)
    return tuple(segs), tuple(lv_list)


def _tile_stats(rhat_sq: torch.Tensor, me: torch.Tensor, n: int,
                norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N_pad/512, 5) per tile: min ‖r̂‖, max ‖r̂‖, max error margin, min and
    max original row norm (1.0 without norms).  Rows ≥ n are excluded."""
    r = torch.sqrt(torch.clamp(rhat_sq, min=0.0))
    return tile_stats(r, r, me, n, norms)


def _row_norm_key(plan: SAQPlan, codes: torch.Tensor) -> torch.Tensor:
    """Σ_s o_l2norm_s² per row, from the byte rows' float columns only —
    the norm-ordering sort key."""
    npos = sum(packed_bytes(l, b) for l, b in zip(plan.seg_lens, plan.seg_bits)) + \
        4 * plan.num_segments
    acc = torch.zeros((codes.shape[0],), dtype=torch.float32, device=codes.device)
    for s in range(plan.num_segments):
        nrm = bytes_to_f32(codes[:, npos + 4 * s: npos + 4 * s + 4])
        acc = acc + nrm * nrm
    return acc


def _mean_segs(plan: SAQPlan, params: SAQParams):
    """The PCA mean in each segment's rotated code space."""
    mean_p = params.pca_mean @ params.pca_rot
    return [mean_p[st: st + ln] @ params.seg_rots[s]
            for s, (st, ln) in enumerate(zip(plan.seg_starts, plan.seg_lens))]


def _convert_rows(plan: SAQPlan, params: SAQParams, rows: torch.Tensor):
    """One chunk of byte rows (a 512 multiple) → (per-segment words / value
    planes, factors (2S, rows) [rescales; L2 shifts r2_s = 2·mean_s·r̂_s +
    ‖r̂_s‖²], per-row ‖r̂‖², CAQ error margin)."""
    segspecs = packed_segspecs(plan, params)[0]
    mean_segs = _mean_segs(plan, params)
    n = rows.shape[0]
    words, fac_rows, r2_rows = [], [], []
    rhat_sq = torch.zeros((n,), dtype=torch.float32, device=rows.device)
    me = torch.zeros((n,), dtype=torch.float32, device=rows.device)
    for s, (packed, rescale, nrm) in enumerate(_split_row(plan, rows)):
        ln, b = plan.seg_lens[s], plan.seg_bits[s]
        idx = unpack_bits(packed, b, ln)
        if segspecs[s].dequant == "values":  # unscaled: the kernel applies the rescale
            words.append(caq_decode_levels(idx, torch.ones_like(rescale), params.seg_levels[s]))
        else:
            words.append(pack_words(idx, b, segspecs[s].beff))
        fac_rows.append(rescale)
        val = _seg_dequant(params, plan, s, idx, rescale)
        rsq_s = torch.sum(val * val, dim=1)
        r2_rows.append(2.0 * (val @ mean_segs[s]) + rsq_s)
        rhat_sq = rhat_sq + rsq_s
        cos_term = torch.clamp(rsq_s / torch.clamp(nrm * nrm, min=1e-30) - 1.0, min=0.0)
        me = me + nrm * _CONST_EPSILON * torch.sqrt(cos_term / max(ln - 1, 1))
    return tuple(words), torch.stack(fac_rows + r2_rows), rhat_sq, me


def _fill_rows(plan: SAQPlan, params: SAQParams, rows: torch.Tensor):
    """``_convert_rows`` in ``PackedFill``'s terms: the radius bounds both
    ‖r̂‖."""
    w, f, rhat_sq, me = _convert_rows(plan, params, rows)
    r = torch.sqrt(torch.clamp(rhat_sq, min=0.0))
    return w, f, r, r, me


def _packed_fill(plan: SAQPlan, params: SAQParams, n: int, device, nv: int) -> PackedFill:
    return PackedFill(packed_segspecs(plan, params)[0], 2 * plan.num_segments, n, device, nv,
                      partial(_fill_rows, plan, params))


def prepare_packed(plan: SAQPlan, params: SAQParams, codes: torch.Tensor,
                   norms: Optional[torch.Tensor] = None, row_chunk: int = 131072,
                   sort_rows: bool = False,
                   num_valid_rows: Optional[int] = None) -> PackedCorpus:
    """Byte rows → PackedCorpus: factors (2S+1, N_pad) feature-major — row s
    the segment-s rescale, row S+s its L2 shift r2_s, row 2S the original
    row norm for Metric.NIP (1.0 when absent) — and the prune tile stats
    (min/max ‖r̂‖, the CAQ error margin Σ_s fac_error_s/‖o_s‖ rebuilt from
    the stored factors, the norm envelope), written in place ``row_chunk``
    rows at a time (``methods/packed.py::PackedFill``).

    sort_rows=True NORM-ORDERS the rows (a stable sort by the stored
    o_l2norm key) so that tiles span narrow norm bands and the prune bound
    can fire; ``perm`` maps scan positions back to row ids.
    num_valid_rows=v declares rows ≥ v pad rows: they sort to the tail and
    are left out of the tile stats."""
    dev = codes.device
    n = codes.shape[0]
    nv = n if num_valid_rows is None else int(num_valid_rows)
    perm = order = None
    if sort_rows and n > TILE:
        key = _row_norm_key(plan, codes)
        if nv < n:  # pad rows sort to the tail
            key = torch.where(torch.arange(n, device=dev) < nv, key,
                              torch.full_like(key, np.inf))
        order = torch.argsort(key, stable=True)
        del key
        if norms is not None:
            norms = norms[order]
        perm = order.to(torch.int32)
    row_chunk = max(TILE, row_chunk - row_chunk % TILE)
    fill = _packed_fill(plan, params, n, dev, nv)
    for i0 in range(0, n, row_chunk):
        i1 = min(i0 + row_chunk, n)
        fill.write(i0, codes[i0:i1] if order is None else codes[order[i0:i1]],
                   None if norms is None else norms[i0:i1])
    return fill.corpus(norms is not None, perm)


def fill_packed(plan: SAQPlan, params: SAQParams, n: int,
                code_chunks: Iterable[Tuple[int, torch.Tensor]], device,
                row_chunk: int = 131072) -> PackedCorpus:
    """The packed cache of an n-row corpus given as ``code_chunks`` —
    (first row, byte rows) in row order, every chunk but the last a
    multiple of the 512-row tile — each written in place as it comes
    (``row_chunk`` rows at a time), so a caller can free its byte rows
    chunk by chunk.  Equals ``prepare_packed`` over all n rows (no norms,
    no norm order) bit for bit."""
    row_chunk = max(TILE, row_chunk - row_chunk % TILE)
    fill = _packed_fill(plan, params, n, torch.device(device), n)
    filled = 0
    for i0, codes in code_chunks:
        if i0 != filled or i0 % TILE or i0 + codes.shape[0] > n:
            raise ValueError(f"chunk of {codes.shape[0]} rows at row {i0}: chunks must follow "
                             f"each other, start on a {TILE}-row tile and end by row {n} "
                             f"(filled {filled} rows)")
        for j0 in range(0, codes.shape[0], row_chunk):
            fill.write(i0 + j0, codes[j0:j0 + row_chunk])
        filled = i0 + codes.shape[0]
    if filled != n:
        raise ValueError(f"the chunks hold {filled} rows, not {n}")
    return fill.corpus(False)


def _packed_query_side(plan: SAQPlan, params: SAQParams, queries: torch.Tensor, seg_ids):
    """Queries in the kernel's concatenated code space over the segments
    ``seg_ids`` → (q_cat (Q, Σ ln), q·pca_mean (Q,))."""
    qp = queries @ params.pca_rot
    q_cat = torch.cat([qp[:, plan.seg_starts[s]: plan.seg_starts[s] + plan.seg_lens[s]]
                       @ params.seg_rots[s] for s in seg_ids], dim=1)
    return q_cat, queries @ params.pca_mean


def _mean_cat(plan: SAQPlan, params: SAQParams, seg_ids) -> torch.Tensor:
    mean_segs = _mean_segs(plan, params)
    return torch.cat([mean_segs[s] for s in seg_ids])


def packed_route(plan: SAQPlan, params: SAQParams) -> PackedRoute:
    """Segment s's L2 shift is factor row S+s, the NIP norm row 2S."""
    segs, lv_list = packed_segspecs(plan, params)
    s_cnt = plan.num_segments
    return PackedRoute(segs, lv_list, "seg", tuple(range(s_cnt, 2 * s_cnt)), 2 * s_cnt,
                       partial(_packed_query_side, plan, params),
                       lambda: torch.sum(params.pca_mean ** 2), partial(_mean_cat, plan, params))


def _dequant_cat(plan: SAQPlan, params: SAQParams, rows: torch.Tensor, seg_ids) -> torch.Tensor:
    """Byte rows → (T, Σ ln) f32 dequantized values of the segments
    ``seg_ids``, concatenated in code space."""
    parts = _split_row(plan, rows)
    return torch.cat([_seg_dequant(params, plan, s, unpack_bits(parts[s][0], plan.seg_bits[s],
                                                                plan.seg_lens[s]), parts[s][1])
                      for s in seg_ids], dim=1)


def scan_topk(plan: SAQPlan, params: SAQParams, queries, codes: torch.Tensor, k: int,
              metric: Metric, norms=None, tile_rows: int = 16384, use_bf16: bool = True,
              num_valid: Optional[int] = None, approx: bool = False, prune_segments: int = 0,
              rerank_factor: int = 10, packed_cache: Optional[PackedCorpus] = None,
              use_packed: Optional[bool] = None, prune_tiles: Optional[bool] = None):
    """SAQ search → (Q, k) scores in the metric's form, (Q, k) ids.

    The dense packed route of ``methods/packed.py`` (n ≥ 512 and k ≤ 128
    unless ``use_packed`` says: ``search_corpus``, ``dense_topk``) over
    ``packed_cache`` or a layout built here; otherwise the plain streaming
    scan.

    ``prune_segments`` = p > 0 (with p < the segment count and n > 2·
    ``rerank_factor``·k) is the head-segment cascade: stage 1 scores every
    row on the first p segments alone (the packed kernel over that segment
    subset, when rerank_factor·k ≤ 128, else the dense packed scan runs;
    the plain streaming scan on the plain route) and keeps k1 =
    rerank_factor·k candidates, which ``_saq_rerank`` rescores exactly over
    all segments.  It lost every measurement on the TPU and stays off by
    default."""
    dev = codes.device
    n = codes.shape[0]
    num_q = queries.shape[0]
    use_bf16 = use_bf16 and bf16_supported(dev)
    queries = as_f32(queries, dev)
    q_sq = torch.sum(queries * queries, dim=-1)
    cascade = 0 < prune_segments < plan.num_segments and n > 2 * rerank_factor * k
    k1 = min(n, rerank_factor * k)
    head = tuple(range(prune_segments))
    packed = search_corpus(packed_cache, partial(prepare_packed, plan, params, codes), n, k,
                           metric, norms, num_valid, use_packed)
    if packed is not None:
        route = packed_route(plan, params)
        if cascade and rerank_factor * k <= MAX_K:
            # stage 1 in the kernel over the head segments, prune off: the
            # tile stats bound the full reconstruction, not a subset's
            s1, cand = packed_scan(route, queries, packed, k1, metric, seg_ids=head,
                                   num_valid=num_valid, use_bf16=use_bf16)
            if packed.perm is not None:
                cand = packed.perm[cand.long()]
            return _saq_rerank(plan, params, queries, codes, cand, torch.isfinite(s1), k,
                               metric, norms=norms, q_sq=q_sq)
        return dense_topk(route, queries, packed, k, metric, q_sq, num_valid=num_valid,
                          use_bf16=use_bf16, prune_tiles=prune_tiles)

    tile = min(tile_rows, max(8, n))
    limit = n if num_valid is None else min(n, int(num_valid))
    norms_t = _nip_norms(norms, n, dev) if metric == Metric.NIP else None

    def make_score_tile(seg_ids):
        q_cat, q_mean = _packed_query_side(plan, params, queries, seg_ids)
        q_cat = round_bf16(q_cat) if use_bf16 else q_cat
        mean_cat, mean_sq = _mean_cat(plan, params, seg_ids), torch.sum(params.pca_mean ** 2)

        def score_tile(start):
            ct = codes[start: start + tile]
            o_cat = _dequant_cat(plan, params, ct, seg_ids)
            ip = q_cat @ (round_bf16(o_cat) if use_bf16 else o_cat).T + q_mean[:, None]
            # ‖x̂‖² = ‖mean‖² + 2·mean·r̂ + ‖r̂‖² (rotations orthogonal)
            s_val = maximize_scores(
                ip, lambda: mean_sq + 2.0 * (o_cat @ mean_cat) + torch.sum(o_cat * o_cat, dim=1),
                metric, lambda: norms_t[start: start + ct.shape[0]])
            return _col_mask(s_val, start, limit)

        return score_tile

    if not cascade:
        scores, idx = _streaming_topk(make_score_tile(tuple(range(plan.num_segments))), n,
                                      num_q, k, tile, approx=approx)
        return _finalize(scores, idx, metric, q_sq)
    s1, cand = _streaming_topk(make_score_tile(head), n, num_q, k1, tile, approx=True)
    return _saq_rerank(plan, params, queries, codes, cand, torch.isfinite(s1), k, metric,
                       norms=norms, q_sq=q_sq)


def _saq_rerank(plan: SAQPlan, params: SAQParams, queries: torch.Tensor, codes: torch.Tensor,
                cand: torch.Tensor, alive: torch.Tensor, k: int, metric: Metric, norms=None,
                q_sq=None):
    """Stage 2 of the head-segment cascade: gather the (Q, k1) candidate
    rows ``cand`` (corpus row ids), rescore them exactly over all segments
    in f32 (whatever ``use_bf16`` said for stage 1), set the rows ``alive``
    masks out (stage 1's −inf) to −inf and keep the top-k.  Ties rank by
    candidate position, as the JAX package's ``lax.top_k`` over the
    candidates does."""
    num_q, k1 = cand.shape
    seg_ids = tuple(range(plan.num_segments))
    q_cat, q_mean = _packed_query_side(plan, params, queries, seg_ids)
    o_cat = _dequant_cat(plan, params, codes[cand.reshape(-1).long()],
                         seg_ids).reshape(num_q, k1, -1)
    ip = torch.einsum("ql,qkl->qk", q_cat, o_cat) + q_mean[:, None]
    mean_cat, mean_sq = _mean_cat(plan, params, seg_ids), torch.sum(params.pca_mean ** 2)
    s_val = maximize_scores(
        ip, lambda: mean_sq + 2.0 * (o_cat @ mean_cat) + torch.sum(o_cat * o_cat, dim=-1),
        metric, lambda: _nip_norms(norms, codes.shape[0], codes.device)[cand.long()])
    s_val = torch.where(alive, s_val, torch.full_like(s_val, -np.inf))
    ts, ti = ordered_topk(s_val, min(k, k1))  # ids = candidate positions
    return _finalize(ts, torch.gather(cand, 1, ti.long()), metric, q_sq)


class SAQ(PackedQuantizer):
    name = "saq"
    norm_order = True

    def __init__(self, cfg: SAQConfig = SAQConfig(), device=None):
        super().__init__(device)
        self.cfg = cfg
        self.plan: Optional[SAQPlan] = None

    def fit(self, X) -> "SAQ":
        self._dim = X.shape[1]
        self.plan, self.params = fit(X, self.cfg, device=self._bind_device(X))
        return self

    def compress(self, X) -> torch.Tensor:
        return encode(self.plan, self.params, X, self.cfg.caq_rounds)

    def decompress(self, codes) -> torch.Tensor:
        if isinstance(codes, np.ndarray):
            codes = torch.from_numpy(np.array(codes))
        return decode(self.plan, self.params, to_device(codes, self.device))

    def decode_fn(self):
        plan, params = self.plan, self.params
        return lambda ct: decode(plan, params, ct)

    def encode_fn(self):
        plan, params, rounds = self.plan, self.params, self.cfg.caq_rounds
        return lambda x: encode(plan, params, x, rounds)

    def scan_topk(self, queries, codes, k, metric, norms=None, tile_rows=16384,
                  use_bf16=True, approx=False, prune_segments=0, rerank_factor=10, cache=None,
                  num_valid=None, prune_tiles=None):
        return scan_topk(self.plan, self.params, queries, codes, k, metric, norms=norms,
                         tile_rows=tile_rows, use_bf16=use_bf16, num_valid=num_valid,
                         approx=approx, prune_segments=prune_segments,
                         rerank_factor=rerank_factor, packed_cache=cache,
                         prune_tiles=prune_tiles)

    def packed_route(self) -> PackedRoute:
        return packed_route(self.plan, self.params)

    def _pack(self, codes, norms=None, sort_rows=False, num_valid_rows=None):
        return prepare_packed(self.plan, self.params, codes, norms=norms, sort_rows=sort_rows,
                              num_valid_rows=num_valid_rows)

    def residual_scorer(self):
        """Code-space window scorer for the IVF list scans (base contract):
        v·decode(ct) = q_map(v)_cat·ô + v·pca_mean and ‖decode(ct)‖² =
        ‖mean‖² + 2·mean_cat·ô + ‖ô‖² (orthogonal rotations): windows need
        only the per-segment dequant, not the segment and PCA un-rotations
        that ``decode_fn`` pays a window."""
        plan, params = self.plan, self.params
        seg_ids = tuple(range(plan.num_segments))
        mean_cat, mean_sq = _mean_cat(plan, params, seg_ids), torch.sum(params.pca_mean ** 2)

        def q_map(v):
            return _packed_query_side(plan, params, as_f32(v, params.pca_mean.device), seg_ids)

        def window(ct):
            o = _dequant_cat(plan, params, ct, seg_ids)
            return o, mean_sq + 2.0 * (o @ mean_cat) + torch.sum(o * o, dim=1)

        return q_map, window

    def code_bytes_per_vector(self) -> float:
        return float(self.plan.code_bytes)

    def config_dict(self):
        return {
            "bpd": self.cfg.bits_per_dim,
            "allocator": self.cfg.allocator,
            "use_pca": self.cfg.use_pca,
            "codebook": self.cfg.codebook,
            "segments": [{"start": s, "len": l, "bits": b} for s, l, b in zip(
                self.plan.seg_starts, self.plan.seg_lens, self.plan.seg_bits)]
            if self.plan else None,
        }

    def _payload(self):
        return {**super()._payload(), "plan": self.plan}

    def _restore_payload(self, payload) -> None:
        super()._restore_payload(payload)
        self.plan = payload["plan"]
