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
          route (``prepare_packed`` → ``kernels/packed_scan.py``) scans
          tile-ordered words with the hand-written CUDA kernel on a card;
          ``use_packed=False`` or k > 128 takes the plain streaming scan.

Not ported yet: the head-segment prune cascade (``prune_segments > 0``
raises; it lost every measurement on the TPU and stays off).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

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
from vq_tpu_torch.kernels.adc import _finalize, _streaming_topk
from vq_tpu_torch.kernels.caq import (
    _CONST_EPSILON,
    caq_decode,
    caq_decode_levels,
    caq_encode,
    caq_encode_levels,
)
from vq_tpu_torch.kernels.lloyd1d import lloyd_1d_columns, lloyd_1d_sorted
from vq_tpu_torch.kernels.packed_scan import (
    TILE,
    PackedCorpus,
    make_segspec,
    pack_words,
    packed_scan_topk,
)
from vq_tpu_torch.methods.base import BaseQuantizer

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


def _tile_min_max(v: torch.Tensor, valid: torch.Tensor, empty_min: float, empty_max):
    """Per-512-row-tile (min, max) of v over valid rows."""
    vmin = torch.where(valid, v, torch.full_like(v, np.inf)).reshape(-1, TILE).amin(dim=1)
    vmin = torch.where(torch.isfinite(vmin), vmin, torch.full_like(vmin, empty_min))
    vmax = torch.where(valid, v, torch.zeros_like(v)).reshape(-1, TILE).amax(dim=1)
    if empty_max is not None:
        vmax = torch.where(vmax > 0, vmax, torch.full_like(vmax, empty_max))
    return vmin, vmax


def _tile_stats(rhat_sq: torch.Tensor, me: torch.Tensor, n: int,
                norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N_pad/512, 5) per tile: min ‖r̂‖, max ‖r̂‖, max error margin, min and
    max original row norm (1.0 without norms).  Rows ≥ n are excluded."""
    valid = torch.arange(rhat_sq.shape[0], device=rhat_sq.device) < n
    min_r, max_r = _tile_min_max(torch.sqrt(torch.clamp(rhat_sq, min=0.0)), valid, 0.0, None)
    max_me = torch.where(valid, me, torch.zeros_like(me)).reshape(-1, TILE).amax(dim=1)
    if norms is None:
        min_n, max_n = torch.ones_like(min_r), torch.ones_like(max_r)
    else:
        min_n, max_n = _tile_min_max(norms.to(torch.float32), valid, 1.0, 1.0)
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


def prepare_packed(plan: SAQPlan, params: SAQParams, codes: torch.Tensor,
                   norms: Optional[torch.Tensor] = None, row_chunk: int = 131072,
                   sort_rows: bool = False,
                   num_valid_rows: Optional[int] = None) -> PackedCorpus:
    """Byte rows → PackedCorpus: factors (2S+1, N_pad) feature-major — row s
    the segment-s rescale, row S+s its L2 shift r2_s, row 2S the original
    row norm for Metric.NIP (1.0 when absent) — and the prune tile stats
    (min/max ‖r̂‖, the CAQ error margin Σ_s fac_error_s/‖o_s‖ rebuilt from
    the stored factors, the norm envelope), chunk by chunk.

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
        if norms is not None:
            norms = norms[order]
        perm = order.to(torch.int32)
    row_chunk = max(TILE, row_chunk - row_chunk % TILE)
    n_pad = n + (-n) % TILE

    w_chunks, f_chunks, r_chunks, m_chunks = [], [], [], []
    for i0 in range(0, n_pad, row_chunk):
        i1 = min(i0 + row_chunk, n_pad)
        rows = codes[i0: min(i1, n)] if order is None else codes[order[i0: min(i1, n)]]
        if i1 > n:  # zero byte rows parse to idx 0 / rescale 0; `limit` masks them
            rows = torch.nn.functional.pad(rows, (0, 0, 0, i1 - max(i0, n)))
        w, f, r, m = _convert_rows(plan, params, rows)
        w_chunks.append(w)
        f_chunks.append(f)
        r_chunks.append(r)
        m_chunks.append(m)

    words = tuple(torch.cat([c[s] for c in w_chunks]) for s in range(plan.num_segments))
    nrm_row = torch.ones((n_pad,), dtype=torch.float32, device=dev)
    if norms is not None:
        nrm_row[:n] = norms.to(torch.float32)
    stats = _tile_stats(torch.cat(r_chunks), torch.cat(m_chunks), nv,
                        norms=nrm_row if norms is not None else None)
    fac = torch.cat([torch.cat(f_chunks, dim=1), nrm_row[None]], dim=0).contiguous()
    return PackedCorpus(words=words, factors=fac, num_rows=n, tile_stats=stats,
                        has_norms=norms is not None, perm=perm,
                        prune_hint=prune_hint_from_stats(stats))


def _packed_query_side(plan: SAQPlan, params: SAQParams, queries: torch.Tensor, seg_ids):
    """Queries and mean in the kernel's concatenated code space →
    (q_cat (Q, Σln), mean_cat (Σln,), q_mean (Q,), mean_sq)."""
    qp = queries @ params.pca_rot
    mean_segs = _mean_segs(plan, params)
    q_cat = torch.cat([qp[:, plan.seg_starts[s]: plan.seg_starts[s] + plan.seg_lens[s]]
                       @ params.seg_rots[s] for s in seg_ids], dim=1)
    mean_cat = torch.cat([mean_segs[s] for s in seg_ids])
    return q_cat, mean_cat, queries @ params.pca_mean, torch.sum(params.pca_mean ** 2)


def packed_scan_args(plan, params, queries, packed: PackedCorpus, k, metric, seg_ids=None,
                     num_valid=None, use_bf16=True, prune=False) -> dict:
    """The keyword arguments of ``packed_scan_topk`` (or its plain twin) for
    a search of (a segment subset of) the corpus."""
    segs, lv_list = packed_segspecs(plan, params)
    if seg_ids is None:
        seg_ids = tuple(range(plan.num_segments))
    q_cat, mean_cat, q_mean, mean_sq = _packed_query_side(plan, params, queries, seg_ids)
    if metric == Metric.L2:
        kind, qa = "l2", 2.0 * q_mean - mean_sq
    else:
        kind, qa = ("ip" if metric == Metric.IP else "nip"), q_mean
    limit = packed.num_rows if num_valid is None else min(packed.num_rows, int(num_valid))
    qprune = None
    if prune:
        # the tile stats bound the FULL reconstruction: no segment subsets
        if len(seg_ids) != plan.num_segments or packed.tile_stats is None:
            raise ValueError("prune needs every segment and a corpus with tile stats")
        b = torch.linalg.norm(q_cat - mean_cat[None, :] if metric == Metric.L2 else q_cat,
                              dim=1)
        qprune = torch.stack([qa, b], dim=1).contiguous()
    s_cnt = plan.num_segments
    return dict(
        q_cat=q_cat.contiguous(), qa=qa.contiguous(),
        words=tuple(packed.words[s] for s in seg_ids), factors=packed.factors,
        lv_tables=tuple(lv_list[s] for s in seg_ids if lv_list[s] is not None),
        segs=tuple(segs[s] for s in seg_ids), k=k, family="seg", metric_kind=kind,
        norm_col=2 * s_cnt, r2_cols=tuple(s_cnt + s for s in seg_ids), limit=limit,
        use_bf16=use_bf16, prune=prune, tile_stats=packed.tile_stats if prune else None,
        qprune=qprune)


def _packed_scan(plan, params, queries, packed: PackedCorpus, k, metric, seg_ids=None,
                 num_valid=None, use_bf16=True, prune=False, tile_mask=None, mask_cap=None):
    """The packed kernel over (a segment subset of) the corpus → maximize-form
    (scores, scan-position ids) [+ scanned count when prune]."""
    return packed_scan_topk(**packed_scan_args(plan, params, queries, packed, k, metric,
                                               seg_ids, num_valid, use_bf16, prune),
                            tile_mask=tile_mask, mask_cap=mask_cap)


def scan_topk(plan: SAQPlan, params: SAQParams, queries, codes: torch.Tensor, k: int,
              metric: Metric, norms=None, tile_rows: int = 16384, use_bf16: bool = True,
              num_valid: Optional[int] = None, prune_segments: int = 0,
              packed_cache: Optional[PackedCorpus] = None, use_packed: Optional[bool] = None,
              prune_tiles: Optional[bool] = None):
    """SAQ search → (Q, k) scores in the metric's form, (Q, k) ids.

    Packed route (n ≥ 512 and k ≤ 128 unless ``use_packed`` says): the
    packed kernel over ``packed_cache`` (or a layout built here), with the
    variance prune on when the cache's ``prune_hint`` says it can fire
    (``prune_tiles`` overrides); ids of a norm-ordered cache are mapped
    back through ``perm``.  Otherwise the plain streaming scan."""
    if prune_segments > 0:
        raise ValueError("the head-segment prune cascade (prune_segments > 0) is not ported")
    dev = codes.device
    n = codes.shape[0]
    num_q = queries.shape[0]
    use_bf16 = use_bf16 and bf16_supported(dev)
    queries = as_f32(queries, dev)
    q_sq = torch.sum(queries * queries, dim=-1)
    if use_packed is None:
        use_packed = n >= TILE and k <= 128
    if use_packed:
        if metric == Metric.NIP:
            # a cache built without real norms would return un-normalized scores
            if packed_cache is not None and not packed_cache.has_norms:
                raise ValueError("Metric.NIP needs a packed cache built with norms")
            if packed_cache is None and norms is None:
                raise ValueError("Metric.NIP requires original row norms")
        packed = packed_cache if packed_cache is not None else prepare_packed(
            plan, params, codes, norms if metric == Metric.NIP else None)
        if packed.perm is not None and num_valid is not None:
            raise ValueError("num_valid prefix masking is incompatible with a norm-ordered "
                             "(sort_rows) packed cache")
        prune = (prune_tiles if prune_tiles is not None
                 else packed.tile_stats is not None and packed.prune_hint)
        out = _packed_scan(plan, params, queries, packed, k, metric, num_valid=num_valid,
                           use_bf16=use_bf16, prune=prune)
        outs, outi = out[0], out[1]
        if packed.perm is not None:
            outi = packed.perm[outi.long()]
        return _finalize(outs, outi, metric, q_sq)

    tile = min(tile_rows, max(8, n))
    q_cat, mean_cat, q_mean, mean_sq = _packed_query_side(
        plan, params, queries, tuple(range(plan.num_segments)))
    if use_bf16:
        q_cat = round_bf16(q_cat)
    limit = n if num_valid is None else min(n, int(num_valid))
    norms_t = None
    if metric == Metric.NIP:
        if norms is None:
            raise ValueError("Metric.NIP requires original row norms")
        norms_t = as_f32(norms, dev)

    def score_tile(start):
        ct = codes[start: start + tile]
        o_cat = torch.cat([
            _seg_dequant(params, plan, s, unpack_bits(packed, plan.seg_bits[s],
                                                      plan.seg_lens[s]), rescale)
            for s, (packed, rescale, _nrm) in enumerate(_split_row(plan, ct))], dim=1)
        ip = q_cat @ (round_bf16(o_cat) if use_bf16 else o_cat).T + q_mean[:, None]
        if metric == Metric.L2:
            # ‖x̂‖² = ‖mean‖² + 2·mean·r̂ + ‖r̂‖² (rotations orthogonal)
            md = o_cat @ mean_cat
            s_val = 2.0 * ip - (mean_sq + 2.0 * md[None, :]
                                + torch.sum(o_cat * o_cat, dim=1)[None, :])
        elif metric == Metric.IP:
            s_val = ip
        else:
            nt = norms_t[start: start + ct.shape[0]]
            s_val = ip / torch.clamp(nt, min=1e-30)[None, :]
        col = start + torch.arange(ct.shape[0], device=dev)
        return torch.where(col[None, :] < limit, s_val, torch.full_like(s_val, -np.inf))

    scores, idx = _streaming_topk(score_tile, n, num_q, k, tile)
    return _finalize(scores, idx, metric, q_sq)


class SAQ(BaseQuantizer):
    name = "saq"

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
                  use_bf16=True, cache=None, num_valid=None, prune_segments=0,
                  prune_tiles=None):
        return scan_topk(self.plan, self.params, queries, codes, k, metric, norms=norms,
                         tile_rows=tile_rows, use_bf16=use_bf16, num_valid=num_valid,
                         prune_segments=prune_segments, packed_cache=cache,
                         prune_tiles=prune_tiles)

    def prepare_scan(self, codes, norms=None, num_queries=8):
        """The norm-ordered PackedCorpus scan cache (built once at index
        fit), so the variance prune can fire.  ``num_queries`` sized the
        TPU's VMEM gate; the card's kernel takes any batch."""
        return prepare_packed(self.plan, self.params, codes, norms=norms, sort_rows=True)

    def prepare_shard_cache(self, codes, norms=None, num_queries=8, num_valid_rows=None):
        """The per-shard cache (base contract): norm-ordered within the shard,
        so the variance prune composes with sharding, with the pad rows
        sorted to the tail so the ``num_valid`` prefix limit stays exact."""
        return prepare_packed(self.plan, self.params, codes, norms=norms, sort_rows=True,
                              num_valid_rows=num_valid_rows)

    def prepare_tile_cache(self, codes, norms=None, num_queries=8):
        """The order-preserving layout (base contract): no norm-ordering, no
        perm; tile stats and the prune hint as for ``prepare_scan``."""
        return prepare_packed(self.plan, self.params, codes, norms=norms, sort_rows=False)

    def packed_scan_raw(self, queries, packed, k, metric, num_valid=None, use_bf16=True,
                        tile_mask=None, mask_cap=None):
        prune = packed.tile_stats is not None and packed.prune_hint
        out = _packed_scan(self.plan, self.params, as_f32(queries, self.device), packed, k,
                           metric, num_valid=num_valid, use_bf16=use_bf16, prune=prune,
                           tile_mask=tile_mask, mask_cap=mask_cap)
        return out[0], out[1]

    def residual_scorer(self):
        """Code-space window scorer for the IVF list scans (base contract):
        v·decode(ct) = q_map(v)_cat·ô + v·pca_mean and ‖decode(ct)‖² =
        ‖mean‖² + 2·mean_cat·ô + ‖ô‖² (orthogonal rotations): windows need
        only the per-segment dequant, not the segment and PCA un-rotations
        that ``decode_fn`` pays a window."""
        plan, params = self.plan, self.params
        seg_ids = tuple(range(plan.num_segments))
        mean_cat = torch.cat(_mean_segs(plan, params))
        mean_sq = torch.sum(params.pca_mean ** 2)

        def q_map(v):
            q_cat, _, q_mean, _ = _packed_query_side(plan, params,
                                                     as_f32(v, params.pca_mean.device), seg_ids)
            return q_cat, q_mean

        def window(ct):
            o = torch.cat([
                _seg_dequant(params, plan, s, unpack_bits(packed, plan.seg_bits[s],
                                                          plan.seg_lens[s]), rescale)
                for s, (packed, rescale, _nrm) in enumerate(_split_row(plan, ct))], dim=1)
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
