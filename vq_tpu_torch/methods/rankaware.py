"""Rank-aware per-dimension bit allocation — counterpart of
``vq_tpu/methods/rankaware.py``.

center → PCA rotate → var^(1+α)-weighted greedy per-dim bit allocation
(closed form: the marginal gains fall with b, so the allocation is the
global top-`budget` of the (D, max_bits) gain matrix) → per-dim scalar
codebooks ("gaussian": Gaussian-optimal levels × √var, "lloyd": data-fit
per-dim Lloyd, "exact": optimal 1-D k-means by the port's native DP) →
dense or FFD bit packing (``core/ffd.py``).

Search rotates the queries once: q·x̂ = (qV)·ŷ + q·μ.  The packed route
(N ≥ 512 and k ≤ 128) scans one segment per run of equal bit width with
the packed kernel's "seg" family: "perdim" level tables at B ≤ 4, the f32
value plane at B ≥ 5, no per-row scale (``scale_col = -1``: the levels are
absolute in y-space), and one L2 shift row r2_s = 2·μ_s·ŷ_s + ‖ŷ_s‖² per
segment.  Otherwise the plain streaming scan.

The Gaussian level table is Lloyd on a N(0,1) sample from a torch
generator, so its levels differ from the JAX package's for the same seed:
fits are compared on quality, converted parameters exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from vq_tpu_torch._device import as_f32, bf16_supported, device_of, make_generator, round_bf16
from vq_tpu_torch._device import to_device
from vq_tpu_torch.core.config import Metric, RankAwareConfig
from vq_tpu_torch.core.ffd import (
    FFDLayout,
    dense_decode_codes,
    dense_encode,
    ffd_decode_codes,
    ffd_encode,
    ffd_layout,
)
from vq_tpu_torch.data.sampling import host_sample_rows
from vq_tpu_torch.kernels.adc import _col_mask, _finalize, _nip_norms, _streaming_topk
from vq_tpu_torch.kernels.adc import maximize_scores
from vq_tpu_torch.kernels.lloyd1d import lloyd_1d, lloyd_1d_columns, quantize_to_levels
from vq_tpu_torch.kernels.lloyd1d import quantize_to_levels_per_dim
from vq_tpu_torch.kernels.packed_scan import TILE, PackedCorpus, make_segspec, pack_words
from vq_tpu_torch.methods.packed import (
    PackedQuantizer,
    PackedRoute,
    dense_topk,
    prune_hint_from_stats,
    search_corpus,
)
from vq_tpu_torch.methods.saq import _VALUES_MIN_BITS, _codebook_exact, _tile_stats

_ENCODE_CHUNK = 16384  # rows per encode step (the dense bit stream is (rows, Σb))


class RankAwareParams(NamedTuple):
    mean: torch.Tensor  # (D,)
    rotation: torch.Tensor  # (D, D) PCA, applied as (x − mean) @ rotation
    codebooks: torch.Tensor  # (D, 2^max_bits) per-dim levels (the tail unused)


def _gaussian_mse_table(max_bits: int, seed: int, device):
    """levels[b] (numpy) and the normalized N(0,1) quantizer MSE Dg[b], for
    b = 0..max_bits."""
    samples = torch.randn((200_000,), generator=make_generator(seed, device), device=device)
    levels, dg = [np.zeros(1)], [1.0]
    for b in range(1, max_bits + 1):
        lv = lloyd_1d(samples, 1 << b)
        mse = float(torch.mean((samples - lv[quantize_to_levels(samples, lv).long()]) ** 2))
        levels.append(lv.cpu().numpy())
        dg.append(mse)
    return levels, np.asarray(dg)


def allocate_bits(variances: np.ndarray, dg: np.ndarray, budget_bits: int, alpha: float,
                  max_bits: int) -> np.ndarray:
    """Closed-form rank-aware greedy: gains g[d,b] = var_d^(1+α)·(Dg[b]−Dg[b+1])
    fall with b, so the top-`budget` gains form per-dim prefixes (a copy of
    the JAX package's numpy)."""
    d = len(variances)
    var_pow = np.clip(variances, 1e-12, None) ** (1.0 + alpha)
    gains = var_pow[:, None] * (dg[:-1] - dg[1:])[None, :]  # (D, max_bits)
    flat = gains.ravel()
    budget = min(budget_bits, flat.size)
    if budget <= 0:
        return np.zeros(d, dtype=np.int64)
    thresh_idx = np.argpartition(flat, -budget)[-budget:]
    chosen = np.zeros_like(flat, dtype=bool)
    chosen[thresh_idx] = True
    return chosen.reshape(d, max_bits).sum(axis=1).astype(np.int64)


def _bit_groups(bits: np.ndarray):
    """{b: dims with width b} for every width b > 0."""
    bits = np.asarray(bits)
    return {int(b): np.nonzero(bits == b)[0] for b in sorted(set(bits.tolist())) if b > 0}


def fit(x, cfg: RankAwareConfig, sample_cap: int = 200_000, device=None):
    """→ (params, bits (D,) numpy, FFD layout or None), from ≤ sample_cap
    rows of x sampled before anything moves to ``device``."""
    device = device_of(x, device)
    xs = as_f32(host_sample_rows(x, sample_cap, cfg.seed), device)
    d = xs.shape[1]
    mean = torch.mean(xs, dim=0)
    xc = xs - mean
    w, v = torch.linalg.eigh(xc.T @ xc / xs.shape[0])  # ascending
    order = torch.argsort(-w, stable=True)
    variances = np.clip(w[order].cpu().numpy(), 1e-12, None)
    rotation = v[:, order].contiguous()

    levels, dg = _gaussian_mse_table(cfg.max_bits, cfg.seed, device)
    bits = allocate_bits(variances, dg, int(round(cfg.bits_per_dim * d)), cfg.alpha,
                         cfg.max_bits)
    cb = np.zeros((d, 1 << cfg.max_bits), dtype=np.float32)
    if cfg.codebook == "gaussian":
        scale = np.sqrt(variances)
        for dd in range(d):
            b = int(bits[dd])
            cb[dd, : 1 << b] = levels[b] * scale[dd]
    elif cfg.codebook == "exact":
        y = (xc @ rotation).cpu().numpy()
        for dd in range(d):
            b = int(bits[dd])
            if b:
                cb[dd, : 1 << b] = _codebook_exact(y[:, dd], 1 << b, 16384, cfg.seed)
    else:  # data-fit Lloyd per dim, all dims of one width at once
        y = xc @ rotation
        for b, cols in _bit_groups(bits).items():
            cols_t = torch.as_tensor(cols, device=device)
            cb[cols, : 1 << b] = lloyd_1d_columns(y[:, cols_t], 1 << b).cpu().numpy()
    layout = ffd_layout(bits) if cfg.packing == "ffd" else None
    params = RankAwareParams(mean=mean, rotation=rotation,
                             codebooks=torch.from_numpy(cb).to(device))
    return params, bits, layout


def _quantize(params: RankAwareParams, bits: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """(N, D) → per-dim code indices (N, D) int32."""
    y = (x - params.mean) @ params.rotation
    codes = torch.zeros(y.shape, dtype=torch.int32, device=y.device)
    for b, cols in _bit_groups(bits).items():
        cols_t = torch.as_tensor(cols, device=y.device)
        codes[:, cols_t] = quantize_to_levels_per_dim(
            y[:, cols_t], params.codebooks[cols_t, : 1 << b].contiguous())
    return codes


def _dequantize_y(params: RankAwareParams, idx: torch.Tensor) -> torch.Tensor:
    """codes (N, D) → ŷ (N, D): each dim's level table looked up."""
    dims = torch.arange(idx.shape[1], device=idx.device)
    return params.codebooks[dims[None, :], idx.long()]


def _unpack(bits, layout, packed: torch.Tensor, packing: str) -> torch.Tensor:
    if packing == "ffd":
        return ffd_decode_codes(packed, layout)
    return dense_decode_codes(packed, bits)


def encode(params, bits, layout, x, packing: str, chunk: int = _ENCODE_CHUNK) -> torch.Tensor:
    """(N, D) → (N, code bytes) uint8 rows on the params' device, a chunk at
    a time."""
    dev = params.mean.device
    n = x.shape[0]
    nbytes = layout.n_bytes if packing == "ffd" else (int(np.sum(bits)) + 7) // 8
    out = torch.empty((n, nbytes), dtype=torch.uint8, device=dev)
    for i0 in range(0, n, chunk):
        codes = _quantize(params, bits, as_f32(x[i0:i0 + chunk], dev))
        out[i0:i0 + codes.shape[0]] = (ffd_encode(codes, layout) if packing == "ffd"
                                       else dense_encode(codes, bits))
    return out


def decode(params, bits, layout, packed: torch.Tensor, packing: str) -> torch.Tensor:
    y_hat = _dequantize_y(params, _unpack(bits, layout, packed, packing))
    return y_hat @ params.rotation.T + params.mean


# ---------------------------------------------------------------------------
# packed-word scan layout (kernels/packed_scan.py)
# ---------------------------------------------------------------------------


def _bit_runs(bits: np.ndarray):
    """Maximal runs of equal nonzero bit width → [(start, len, b), ...];
    0-bit dims decode to ŷ = 0 and are left out of the scan."""
    runs, d, i = [], len(bits), 0
    while i < d:
        b = int(bits[i])
        j = i + 1
        while j < d and int(bits[j]) == b:
            j += 1
        if b > 0:
            runs.append((i, j - i, b))
        i = j
    return runs


def packed_segspecs(params: RankAwareParams, bits: np.ndarray):
    """→ (segspecs, per-segment level tables, None for a value plane, dim
    slices): one segment per equal-bit run, no per-row scale; runs at B ≥ 5
    store the f32 value plane."""
    segs, lv_tables, dim_slices = [], [], []
    for st, ln, b in _bit_runs(np.asarray(bits)):
        if b >= _VALUES_MIN_BITS:
            segs.append(make_segspec(b, ln, "values", -1))
            lv_tables.append(None)
        else:
            segs.append(make_segspec(b, ln, "perdim", -1))
            lv_tables.append(params.codebooks[st:st + ln, : 1 << b].contiguous())
        dim_slices.append((st, ln))
    return tuple(segs), tuple(lv_tables), dim_slices


def prepare_packed(params, bits, layout, codes: torch.Tensor, packing: str,
                   norms: Optional[torch.Tensor] = None, row_chunk: int = 131072) -> PackedCorpus:
    """Byte rows (dense or FFD) → PackedCorpus, order-preserving: per
    segment the tile-ordered words (or the f32 value plane); factors
    (S+1, N_pad) feature-major = the per-segment L2 shifts r2_s, then the
    original row norm for Metric.NIP (1.0 when absent); tile stats from
    ‖ŷ‖ over the allocated dims."""
    dev = codes.device
    n = codes.shape[0]
    runs = _bit_runs(np.asarray(bits))
    segspecs = packed_segspecs(params, bits)[0]
    mu_v = params.mean @ params.rotation
    row_chunk = max(TILE, row_chunk - row_chunk % TILE)
    n_pad = n + (-n) % TILE
    w_chunks, r2_chunks, rsq_chunks = [], [], []
    for i0 in range(0, n_pad, row_chunk):
        i1 = min(i0 + row_chunk, n_pad)
        rows = codes[i0:min(i1, n)]
        if i1 > n:  # zero rows decode to idx 0; `limit` masks them
            rows = torch.nn.functional.pad(rows, (0, 0, 0, i1 - max(i0, n)))
        idx = _unpack(bits, layout, rows, packing)
        y_hat = _dequantize_y(params, idx)
        words, r2 = [], []
        rsq = torch.zeros((rows.shape[0],), dtype=torch.float32, device=dev)
        for (st, ln, b), seg in zip(runs, segspecs):
            part = y_hat[:, st:st + ln]
            rsq_s = torch.sum(part * part, dim=1)
            r2.append(2.0 * (part @ mu_v[st:st + ln]) + rsq_s)
            rsq = rsq + rsq_s
            words.append(part.contiguous() if seg.dequant == "values"
                         else pack_words(idx[:, st:st + ln], b, seg.beff))
        w_chunks.append(words)
        r2_chunks.append(torch.stack(r2))
        rsq_chunks.append(rsq)
    words = tuple(torch.cat([c[s] for c in w_chunks]) for s in range(len(runs)))
    nrm_row = torch.ones((n_pad,), dtype=torch.float32, device=dev)
    if norms is not None:
        nrm_row[:n] = norms.to(torch.float32)
    rsq = torch.cat(rsq_chunks)
    stats = _tile_stats(rsq, torch.zeros_like(rsq), n,
                        norms=nrm_row if norms is not None else None)
    fac = torch.cat([torch.cat(r2_chunks, dim=1), nrm_row[None]], dim=0).contiguous()
    return PackedCorpus(words=words, factors=fac, num_rows=n, tile_stats=stats,
                        has_norms=norms is not None, prune_hint=prune_hint_from_stats(stats))


def packed_route(params: RankAwareParams, bits: np.ndarray) -> PackedRoute:
    """The runs' segments; factor row s segment s's L2 shift, row S the NIP
    norm.  q·x̂ = (qV)·ŷ + q·μ over the allocated dims."""
    segs, lv_tables, dim_slices = packed_segspecs(params, bits)

    def query(queries, seg_ids):
        qv = queries @ params.rotation
        return (torch.cat([qv[:, st:st + ln] for st, ln in dim_slices], dim=1),
                queries @ params.mean)

    def centre(seg_ids):
        mu_v = params.mean @ params.rotation
        return torch.cat([mu_v[st:st + ln] for st, ln in dim_slices])

    return PackedRoute(segs, lv_tables, "seg", tuple(range(len(segs))), len(segs), query,
                       lambda: torch.sum(params.mean ** 2), centre)


def scan_topk(params, bits, layout, packing: str, queries, codes: torch.Tensor, k: int,
              metric: Metric, norms=None, tile_rows: int = 16384, use_bf16: bool = True,
              num_valid: Optional[int] = None, approx: bool = False,
              packed_cache: Optional[PackedCorpus] = None,
              use_packed: Optional[bool] = None, prune_tiles: Optional[bool] = None):
    """RankAware search → (Q, k) scores in the metric's form, (Q, k) ids: the
    dense packed route of ``methods/packed.py`` for n ≥ 512 and k ≤ 128
    where some dim has bits (the JAX package's rule), else the plain
    streaming scan."""
    dev = codes.device
    n = codes.shape[0]
    num_q = queries.shape[0]
    use_bf16 = use_bf16 and bf16_supported(dev)
    queries = as_f32(queries, dev)
    q_sq = torch.sum(queries * queries, dim=-1)
    if use_packed is None and not _bit_runs(np.asarray(bits)):
        use_packed = False
    packed = search_corpus(
        packed_cache, lambda nr: prepare_packed(params, bits, layout, codes, packing, nr),
        n, k, metric, norms, num_valid, use_packed)
    if packed is not None:
        return dense_topk(packed_route(params, bits), queries, packed, k, metric, q_sq,
                          num_valid=num_valid, use_bf16=use_bf16, prune_tiles=prune_tiles)

    tile = min(tile_rows, max(8, n))
    qv = queries @ params.rotation
    qv = round_bf16(qv) if use_bf16 else qv
    q_mu = queries @ params.mean
    mu_v = params.mean @ params.rotation
    mu_sq = torch.sum(params.mean ** 2)
    limit = n if num_valid is None else min(n, int(num_valid))
    norms_t = _nip_norms(norms, n, dev) if metric == Metric.NIP else None

    def score_tile(start):
        y_hat = _dequantize_y(params, _unpack(bits, layout, codes[start:start + tile], packing))
        s = maximize_scores(
            qv @ (round_bf16(y_hat) if use_bf16 else y_hat).T + q_mu[:, None],
            lambda: torch.sum(y_hat * y_hat, dim=1) + 2.0 * (y_hat @ mu_v) + mu_sq, metric,
            lambda: norms_t[start:start + y_hat.shape[0]])
        return _col_mask(s, start, limit)

    scores, idx = _streaming_topk(score_tile, n, num_q, k, tile, approx=approx)
    return _finalize(scores, idx, metric, q_sq)


class RankAware(PackedQuantizer):
    name = "rankaware"

    def __init__(self, cfg: RankAwareConfig = RankAwareConfig(), device=None):
        super().__init__(device)
        if not 1 <= cfg.max_bits <= 8:
            raise ValueError("max_bits must be in [1, 8]")
        self.cfg = cfg
        self.bits: Optional[np.ndarray] = None
        self.layout: Optional[FFDLayout] = None

    def fit(self, X) -> "RankAware":
        self._dim = X.shape[1]
        self.params, self.bits, self.layout = fit(X, self.cfg, device=self._bind_device(X))
        return self

    def compress(self, X) -> torch.Tensor:
        return encode(self.params, self.bits, self.layout, X, self.cfg.packing)

    def decompress(self, codes) -> torch.Tensor:
        if isinstance(codes, np.ndarray):
            codes = torch.from_numpy(np.array(codes))
        return decode(self.params, self.bits, self.layout, to_device(codes, self.device),
                      self.cfg.packing)

    def decode_fn(self):
        params, bits, layout, packing = self.params, self.bits, self.layout, self.cfg.packing
        return lambda ct: decode(params, bits, layout, ct, packing)

    def packed_route(self) -> PackedRoute:
        return packed_route(self.params, self.bits)

    def _pack(self, codes, norms=None, sort_rows=False, num_valid_rows=None):
        """Order-preserving, so a shard's pad rows stay at the tail for the
        ``num_valid`` prefix limit; None where no dim has bits."""
        if not _bit_runs(np.asarray(self.bits)):
            return None
        return prepare_packed(self.params, self.bits, self.layout, codes, self.cfg.packing,
                              norms=norms)

    def residual_scorer(self):
        """Code-space window scorer (base contract): decode(ct) = ŷ·Vᵀ + μ,
        so v·decode = (v·V)·ŷ + v·μ and ‖decode‖² = ‖μ‖² + 2·(μ·V)·ŷ + ‖ŷ‖²;
        windows skip decode's D×D un-rotation."""
        params, bits, layout, packing = self.params, self.bits, self.layout, self.cfg.packing
        mu_v = params.mean @ params.rotation
        mu_sq = torch.sum(params.mean ** 2)

        def q_map(v):
            v = as_f32(v, params.mean.device)
            return v @ params.rotation, v @ params.mean

        def window(ct):
            y_hat = _dequantize_y(params, _unpack(bits, layout, ct, packing))
            return y_hat, mu_sq + 2.0 * (y_hat @ mu_v) + torch.sum(y_hat * y_hat, dim=1)

        return q_map, window

    def scan_topk(self, queries, codes, k, metric, norms=None, tile_rows=16384,
                  use_bf16=True, approx=False, cache=None, num_valid=None, use_packed=None,
                  prune_tiles=None):
        """The JAX package's parameters, in its order, but for ``interpret``
        (Pallas interpret mode: a CPU tensor runs the plain twin here)."""
        return scan_topk(self.params, self.bits, self.layout, self.cfg.packing, queries, codes,
                         k, metric, norms=norms, tile_rows=tile_rows, use_bf16=use_bf16,
                         num_valid=num_valid, approx=approx, packed_cache=cache,
                         use_packed=use_packed, prune_tiles=prune_tiles)

    def code_bytes_per_vector(self) -> float:
        if self.cfg.packing == "ffd":
            return float(self.layout.n_bytes)
        return float((int(self.bits.sum()) + 7) // 8)

    def config_dict(self):
        return {"bpd": self.cfg.bits_per_dim, "alpha": self.cfg.alpha,
                "codebook": self.cfg.codebook, "packing": self.cfg.packing}

    def _payload(self):
        return {**super()._payload(), "bits": self.bits, "layout": self.layout}

    def _restore_payload(self, payload) -> None:
        super()._restore_payload(payload)
        self.bits = payload["bits"]
        self.layout = payload["layout"]
