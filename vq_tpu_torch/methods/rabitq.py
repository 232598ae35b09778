"""RaBitQ / Extended RaBitQ — counterpart of ``vq_tpu/methods/rabitq.py``.

Centroid c (a tensor's ``torch.mean``; any other row source's in one
chunked pass, ``data/sampling.py::chunked_mean``), seeded random orthogonal
rotation P (numpy QR, so it equals the JAX package's) and a shared B-bit
Gaussian-optimal scalar codebook (1-D Lloyd on a seeded N(0,1) sample from
a ``torch.Generator``).  Encode:
r = x − c, s = (r/‖r‖)·P·√D, per-coordinate nearest level, rescale
t = ⟨s,ŝ⟩/⟨ŝ,ŝ⟩.  Code rows [packed B-bit indices ‖ ‖r‖ f32 ‖ t f32] are
byte-identical to the JAX package's.

Search rotates the QUERIES once: q·x̂ = α·(qP)·ŝ + q·c with the unbiased
estimator's scale α = ‖r‖√D/(t‖ŝ‖²).  The packed route scans tile-ordered
words (B ≤ 4, "shared" table) or the f32 value plane (B ≥ 5) with the
packed kernel, α folded into the dequantized values (factor row 0) and
c2 = 2α·(ŝ·cP) + ‖r‖² as the L2 shift (factor row 1), written in place
chunk by chunk (``methods/packed.py::PackedFill``); ``use_packed=False``
or k > 128 takes the plain streaming scan.  Spans (``utils/trace.py``):
``rabitq.centroid`` (the chunked pass) and ``rabitq.pack``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from vq_tpu_torch.core.config import Metric, RaBitQConfig
from vq_tpu_torch._device import as_f32, bf16_supported, device_of, round_bf16, to_device
from vq_tpu_torch.core.packing import (
    bytes_to_f32,
    f32_to_bytes,
    pack_bits,
    packed_bytes,
    unpack_bits,
)
from vq_tpu_torch.data.sampling import chunked_mean
from vq_tpu_torch.kernels.adc import _col_mask, _finalize, _nip_norms, _streaming_topk
from vq_tpu_torch.kernels.adc import maximize_scores
from vq_tpu_torch.kernels.lloyd1d import lloyd_1d_normal, quantize_to_levels
from vq_tpu_torch.kernels.packed_scan import TILE, PackedCorpus, make_segspec, pack_words
from vq_tpu_torch.methods.packed import (
    PackedFill,
    PackedQuantizer,
    PackedRoute,
    dense_topk,
    search_corpus,
)
from vq_tpu_torch.methods.saq import _VALUES_MIN_BITS
from vq_tpu_torch.utils.trace import span

_ENCODE_CHUNK = 65536


class RaBitQParams(NamedTuple):
    centroid: torch.Tensor  # (D,)
    rotation: torch.Tensor  # (D, D) orthogonal, applied as v @ rotation
    levels: torch.Tensor  # (2^B,) shared scalar codebook


def fit(x, cfg: RaBitQConfig, device=None) -> RaBitQParams:
    """Centroid of x, the seeded rotation and the Gaussian level table, on
    ``device`` (default: x's device, or the card for host data).  x: a
    tensor, or any row source (``index/flat.py``), whose centroid is taken
    chunk by chunk (``chunked_mean``)."""
    device = device_of(x, device)
    d = x.shape[1]
    if isinstance(x, torch.Tensor):
        centroid = torch.mean(as_f32(x, device), dim=0)
    else:
        with span("rabitq.centroid"):
            centroid = chunked_mean(x, device)
    q, _ = np.linalg.qr(np.random.default_rng(cfg.seed).standard_normal((d, d)))
    rotation = torch.from_numpy(q.astype(np.float32)).to(device)
    levels = lloyd_1d_normal(1 << cfg.num_bits, seed=cfg.seed, device=device)
    return RaBitQParams(centroid=centroid, rotation=rotation, levels=levels)


def _encode_arrays(params: RaBitQParams, x: torch.Tensor):
    """→ (idx (N, D) int32, ‖r‖ (N,), t (N,))."""
    d = x.shape[1]
    r = x - params.centroid
    nrm = torch.linalg.norm(r, dim=1)
    o = r / torch.clamp(nrm, min=1e-12)[:, None]
    s = (o @ params.rotation) * math.sqrt(d)
    idx = quantize_to_levels(s, params.levels)
    s_hat = params.levels[idx.long()]
    num = torch.sum(s * s_hat, dim=1)
    den = torch.sum(s_hat * s_hat, dim=1)
    t = torch.where(den > 1e-12, num / den, torch.ones_like(den))
    return idx, nrm, t


def encode(params: RaBitQParams, x, num_bits: int, chunk: int = _ENCODE_CHUNK) -> torch.Tensor:
    """→ (N, ceil(D·B/8)+8) uint8 self-contained rows, chunk by chunk."""
    dev = params.centroid.device
    n, d = x.shape
    out = torch.empty((n, packed_bytes(d, num_bits) + 8), dtype=torch.uint8, device=dev)
    for st in range(0, n, chunk):
        idx, nrm, t = _encode_arrays(params, as_f32(x[st: st + chunk], dev))
        out[st: st + idx.shape[0]] = torch.cat(
            [pack_bits(idx, num_bits), f32_to_bytes(nrm), f32_to_bytes(t)], dim=1)
    return out


def _parse(params: RaBitQParams, rows: torch.Tensor, num_bits: int):
    """Byte rows → (ŝ (N, D) level values, ‖r‖ (N,), t (N,))."""
    d = params.centroid.shape[0]
    ib = packed_bytes(d, num_bits)
    s_hat = params.levels[unpack_bits(rows[:, :ib], num_bits, d).long()]
    return s_hat, bytes_to_f32(rows[:, ib: ib + 4]), bytes_to_f32(rows[:, ib + 4: ib + 8])


def decode(params: RaBitQParams, codes: torch.Tensor, num_bits: int) -> torch.Tensor:
    d = params.centroid.shape[0]
    s_hat, nrm, t = _parse(params, codes, num_bits)
    o_hat = s_hat / math.sqrt(d) * t[:, None]
    return (o_hat @ params.rotation.T) * nrm[:, None] + params.centroid


# ---------------------------------------------------------------------------
# packed-word scan layout (kernels/packed_scan.py)
# ---------------------------------------------------------------------------


def _packed_segspec(d: int, num_bits: int):
    # scale_col 0 = the estimator scale α, folded into the dequantized values
    if num_bits >= _VALUES_MIN_BITS:
        return make_segspec(num_bits, d, "values", 0)
    return make_segspec(num_bits, d, "shared", 0)


def _convert_rows(params: RaBitQParams, rows: torch.Tensor, num_bits: int, seg, c_rot):
    """Byte rows (a 512 multiple) → (words or value plane, factors (2, rows)
    = (α, c2), ‖r‖, α‖ŝ‖)."""
    d = params.centroid.shape[0]
    s_hat, nrm, t = _parse(params, rows, num_bits)
    snorm_sq = torch.sum(s_hat * s_hat, dim=1)
    alpha = nrm * math.sqrt(d) / torch.clamp(t * snorm_sq, min=1e-12)
    c2 = 2.0 * alpha * (s_hat @ c_rot) + nrm * nrm
    if seg.dequant == "values":  # unscaled ŝ: the kernel applies α
        w = s_hat
    else:
        ib = packed_bytes(d, num_bits)
        w = pack_words(unpack_bits(rows[:, :ib], num_bits, d), num_bits, seg.beff)
    return w, torch.stack([alpha, c2]), nrm, alpha * torch.sqrt(snorm_sq)


def _fill_rows(params: RaBitQParams, num_bits: int, seg, c_rot, rows: torch.Tensor):
    """``_convert_rows`` in ``PackedFill``'s terms: the radius bounds are ‖r‖
    and α‖ŝ‖, with no margin."""
    w, f, nrm, r = _convert_rows(params, rows, num_bits, seg, c_rot)
    return (w,), f, nrm, r, torch.zeros_like(nrm)


def prepare_packed(params: RaBitQParams, codes: torch.Tensor, num_bits: int,
                   norms: Optional[torch.Tensor] = None, row_chunk: int = 131072) -> PackedCorpus:
    """Byte rows → PackedCorpus, written in place ``row_chunk`` rows at a
    time (``PackedFill``; the pad rows parse to idx 0 / ‖r‖ 0 / t 0 and
    ``limit`` masks them).  factors (3, N_pad) feature-major = (α, c2,
    original norm or 1); tile stats = (min ‖r‖, max α‖ŝ‖, 0 margin, norm
    envelope)."""
    n = codes.shape[0]
    row_chunk = max(TILE, row_chunk - row_chunk % TILE)
    seg = _packed_segspec(params.centroid.shape[0], num_bits)
    c_rot = params.centroid @ params.rotation
    with span("rabitq.pack"):
        fill = PackedFill((seg,), 2, n, codes.device, n,
                          partial(_fill_rows, params, num_bits, seg, c_rot))
        for i0 in range(0, n, row_chunk):
            fill.write(i0, codes[i0:i0 + row_chunk],
                       None if norms is None else norms[i0:i0 + row_chunk])
        return fill.corpus(norms is not None)


def packed_route(params: RaBitQParams, num_bits: int) -> PackedRoute:
    """One segment; factor row 0 the scale α, row 1 the L2 shift c2, row 2
    the NIP norm.  q·x̂ = α·(qP)·ŝ + q·c."""
    seg = _packed_segspec(params.centroid.shape[0], num_bits)
    lv = None if seg.dequant == "values" else params.levels.reshape(1, -1)
    return PackedRoute((seg,), (lv,), "rabitq", (1,), 2,
                       lambda queries, seg_ids: (queries @ params.rotation,
                                                 queries @ params.centroid),
                       lambda: torch.sum(params.centroid ** 2),
                       lambda seg_ids: params.centroid @ params.rotation)


def scan_topk(params: RaBitQParams, queries, codes: torch.Tensor, k: int, metric: Metric,
              num_bits: int, norms=None, tile_rows: int = 16384, use_bf16: bool = True,
              num_valid: Optional[int] = None, approx: bool = False,
              packed_cache: Optional[PackedCorpus] = None,
              use_packed: Optional[bool] = None, prune_tiles: Optional[bool] = None):
    """RaBitQ search → (Q, k) scores in the metric's form, (Q, k) ids: the
    dense packed route of ``methods/packed.py`` for n ≥ 512 and k ≤ 128,
    else the plain streaming scan."""
    dev = codes.device
    d = params.centroid.shape[0]
    n = codes.shape[0]
    num_q = queries.shape[0]
    use_bf16 = use_bf16 and bf16_supported(dev)
    queries = as_f32(queries, dev)
    q_sq = torch.sum(queries * queries, dim=-1)
    packed = search_corpus(packed_cache,
                           lambda nr: prepare_packed(params, codes, num_bits, norms=nr),
                           n, k, metric, norms, num_valid, use_packed)
    if packed is not None:
        return dense_topk(packed_route(params, num_bits), queries, packed, k, metric, q_sq,
                          num_valid=num_valid, use_bf16=use_bf16, prune_tiles=prune_tiles)

    tile = min(tile_rows, max(8, n))
    qr = queries @ params.rotation
    qc = queries @ params.centroid
    cr = params.centroid @ params.rotation
    c_sq = torch.sum(params.centroid ** 2)
    qrd = round_bf16(qr) if use_bf16 else qr
    limit = n if num_valid is None else min(n, int(num_valid))
    norms_t = _nip_norms(norms, n, dev) if metric == Metric.NIP else None
    sqrt_d = math.sqrt(d)

    def score_tile(start):
        s_hat, nrm, t = _parse(params, codes[start: start + tile], num_bits)
        # unbiased estimator: α = ‖r‖·√D/(t·‖ŝ‖²) (⟨s,ŝ⟩ = t·‖ŝ‖²)
        alpha = nrm * sqrt_d / torch.clamp(t * torch.sum(s_hat * s_hat, dim=-1), min=1e-12)
        sdot = qrd @ (round_bf16(s_hat) if use_bf16 else s_hat).T
        s = maximize_scores(alpha[None, :] * sdot + qc[:, None],
                            lambda: nrm * nrm + 2.0 * alpha * (s_hat @ cr) + c_sq, metric,
                            lambda: norms_t[start: start + s_hat.shape[0]])
        return _col_mask(s, start, limit)

    scores, idx = _streaming_topk(score_tile, n, num_q, k, tile, approx=approx)
    return _finalize(scores, idx, metric, q_sq)


class RaBitQ(PackedQuantizer):
    name = "rabitq"

    def __init__(self, cfg: RaBitQConfig = RaBitQConfig(), device=None):
        super().__init__(device)
        if not 1 <= cfg.num_bits <= 8:
            raise ValueError("num_bits must be in [1, 8]")
        self.cfg = cfg

    def fit(self, X) -> "RaBitQ":
        self._dim = X.shape[1]
        self.params = fit(X, self.cfg, device=self._bind_device(X))
        return self

    def compress(self, X) -> torch.Tensor:
        return encode(self.params, X, self.cfg.num_bits)

    def decompress(self, codes) -> torch.Tensor:
        if isinstance(codes, np.ndarray):
            codes = torch.from_numpy(np.array(codes))
        return decode(self.params, to_device(codes, self.device), self.cfg.num_bits)

    def decode_fn(self):
        params, bits = self.params, self.cfg.num_bits
        return lambda ct: decode(params, ct, bits)

    def encode_fn(self):
        params, bits = self.params, self.cfg.num_bits
        return lambda x: encode(params, x, bits)

    def scan_topk(self, queries, codes, k, metric, norms=None, tile_rows=16384,
                  use_bf16=True, approx=False, cache=None, num_valid=None,
                  prune_tiles=None):
        return scan_topk(self.params, queries, codes, k, metric, self.cfg.num_bits,
                         norms=norms, tile_rows=tile_rows, use_bf16=use_bf16,
                         num_valid=num_valid, approx=approx, packed_cache=cache,
                         prune_tiles=prune_tiles)

    def packed_route(self) -> PackedRoute:
        return packed_route(self.params, self.cfg.num_bits)

    def _pack(self, codes, norms=None, sort_rows=False, num_valid_rows=None):
        """Unsorted: a shard's pad rows stay at the tail for the ``num_valid``
        prefix limit."""
        return prepare_packed(self.params, codes, self.cfg.num_bits, norms=norms)

    def residual_scorer(self):
        """Code-space window scorer (base contract): with ô = ŝ·(‖r‖·t/√D),
        decode(ct) = ô·Pᵀ + c, so v·decode = (v·P)·ô + v·c and ‖decode‖² =
        ‖c‖² + 2·(c·P)·ô + ‖ô‖²: no D×D rotation a window.  It follows
        decode's reconstruction, not the flat scan's unbiased estimator."""
        params, bits = self.params, self.cfg.num_bits
        sqrt_d = math.sqrt(params.centroid.shape[0])
        c_rot = params.centroid @ params.rotation
        c_sq = torch.sum(params.centroid ** 2)

        def q_map(v):
            v = as_f32(v, params.centroid.device)
            return v @ params.rotation, v @ params.centroid

        def window(ct):
            s_hat, nrm, t = _parse(params, ct, bits)
            o = s_hat * (nrm * t / sqrt_d)[:, None]
            return o, c_sq + 2.0 * (o @ c_rot) + torch.sum(o * o, dim=1)

        return q_map, window

    def code_bytes_per_vector(self) -> float:
        return float(packed_bytes(self._dim, self.cfg.num_bits) + 8)

    def config_dict(self):
        return {"B": self.cfg.num_bits}
