"""PQ ADC scan kernels: CUDA on the card, plain PyTorch on the CPU.

Counterpart of ``vq_tpu/kernels/pallas_scan.py``.  Two wrappers keep the
JAX functions' return contract:

* ``pq_score_all``  → (Q, N) f32 maximize-form scores
  (2·q·x̂ − ‖x̂‖² for l2, else q·x̂); the caller masks and selects.
* ``pq_scan_topk_fused`` → ((Q, k) f32 maximize-form, (Q, k) i32 ids),
  exact, ordered by score descending then id ascending; rows with id ≥
  ``limit`` are masked; empty slots hold −inf with id 0.

On a CUDA tensor each wrapper launches the hand-written kernels of
``csrc/pq_scan.cu`` or raises, for any M and K ≤ 256, by one of two routes
that ``pq_route`` picks from the shapes: "decode" copies each row's bf16
codewords into shared-memory tiles and multiplies them by 64 queries at a
time on the tensor cores (the TPU kernel's design); "table" builds
per-query lookup tables and sums M entries a row.  Within a route both
wrappers sum in the same order, so the fused top-k is the top-k of
``pq_score_all``'s scores bit for bit.  On a CPU tensor a wrapper runs the
plain version beside it (``*_plain``), which the CPU tests hold against
the JAX kernels in interpret mode.  ``use_bf16`` rounds queries and
codebooks to bf16 and accumulates in f32, as the TPU kernel feeds its MXU;
``use_bf16=False`` computes in f32 throughout.  The TPU-only knobs of the
JAX functions (``tile``, ``interpret``, ``group``) have no counterpart: the
CUDA kernels take any N, and grouped decode was a TPU MXU tuning knob.

Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from vq_tpu_torch._device import round_bf16
from vq_tpu_torch.kernels.packed_scan import grid_chunks, merge_groups
from vq_tpu_torch.kernels.topk import ordered_topk

MAX_K = 128  # largest k of the fused kernel (the TPU kernel's _KPAD)
# Largest subvector width the decode route takes (bf16 mode only): per
# (query, row, subspace) the table route loads 4 bytes of shared memory, the
# decode route runs 2·dsub bf16 operations on the tensor cores, so tables
# win at large dsub.  Measured (chip_smoke.py phase 3, D=1536, N=100k,
# Q=1024, K=256; PERF.md): the decode route wins at dsub 8 and 16, tables at
# 32 and 96; at dsub 24 (M=64) four queries' tables no longer fit shared
# memory, so the table route falls to one query a block and decode wins.
DECODE_MAX_DSUB = 24


def pq_route(dsub: int, use_bf16: bool) -> str:
    """The route of a PQ scan on the card: "decode" (bf16 codewords into
    tiles, products on the tensor cores) in bf16 mode at dsub ≤
    DECODE_MAX_DSUB, else "table" (per-query lookup tables).  f32 mode stays
    on tables: TF32 products would break the f32 tolerance.  K does not
    enter: neither route's cost a (query, row, subspace) depends on it."""
    return "decode" if use_bf16 and dsub <= DECODE_MAX_DSUB else "table"


# ---------------------------------------------------------------- plain twins
def decode_pq(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Decode PQ codes: (M, K, dsub) × (n, M) → (n, M·dsub), by gather.

    Codes are cast to long first: a uint8 index tensor would be read as a
    boolean mask."""
    m = codebooks.shape[0]
    sub = torch.arange(m, device=codes.device)
    return codebooks[sub, codes.long()].reshape(codes.shape[0], -1)


def pq_score_all_plain(queries, codes, codebooks, l2: bool = True,
                       use_bf16: bool = True) -> torch.Tensor:
    """Plain PyTorch version of ``pq_score_all``: decode, then one f32 matmul
    (on bf16-rounded values when ``use_bf16``)."""
    q = queries.to(torch.float32)
    cb = codebooks.to(torch.float32)
    if use_bf16:
        q, cb = round_bf16(q), round_bf16(cb)
    dec = decode_pq(cb, codes)
    ip = q @ dec.T
    if l2:
        return 2.0 * ip - torch.sum(dec * dec, dim=-1)[None, :]
    return ip


def pq_scan_topk_fused_plain(queries, codes, codebooks, k: int, l2: bool = True,
                             limit: Optional[int] = None,
                             use_bf16: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``pq_scan_topk_fused``."""
    return topk_of_scores(pq_score_all_plain(queries, codes, codebooks, l2, use_bf16), k, limit)


def topk_of_scores(s: torch.Tensor, k: int,
                   limit: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pq_scan_topk_fused``'s result from a (Q, N) score matrix: columns at
    or past ``limit`` masked, the top-k in (score desc, id asc) order, empty
    slots −inf with id 0."""
    n = s.shape[1]
    lim = _limit(n, limit)
    col = torch.arange(n, device=s.device)
    s = torch.where(col[None, :] < lim, s, torch.tensor(-math.inf, device=s.device))
    if n < k:  # fewer rows than k: the missing slots are empty
        s = torch.nn.functional.pad(s, (0, k - n), value=-math.inf)
    ts, ti = ordered_topk(s, k)
    return ts, torch.where(ts > -math.inf, ti, torch.zeros_like(ti))


# ------------------------------------------------------------------- wrappers
def _limit(n: int, limit) -> int:
    return n if limit is None else max(0, min(n, int(limit)))


def _check_inputs(queries, codes, codebooks, k: Optional[int] = None):
    dev = codes.device
    for name, t, dt, nd in (("queries", queries, torch.float32, 2),
                            ("codes", codes, torch.uint8, 2),
                            ("codebooks", codebooks, torch.float32, 3)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, codes on {dev}")
        if t.dtype != dt or t.dim() != nd or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {nd}-D {dt} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    m, kk, dsub = codebooks.shape
    if codes.shape[1] != m or queries.shape[1] != m * dsub:
        raise ValueError(f"shapes disagree: queries {tuple(queries.shape)}, codes "
                         f"{tuple(codes.shape)}, codebooks {tuple(codebooks.shape)}")
    if kk > 256:
        raise ValueError(f"codebook size {kk} > 256: codes are uint8")
    if k is not None and not 0 < k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")


def _plan(lib, sms: int, route: str, m: int, kk: int, k: int, num_q: int, n: int,
          vec16: int) -> Tuple[int, int]:
    """(queries a block, chunks) of a launch on ``sms`` SMs; k = 0 for
    ``pq_score_all``.  The table route keeps 8, else 4, else 1 query's
    tables in shared memory, the most for which the library reports a
    resident block, else reads one query's from global memory (qb 0).
    Chunks: ``grid_chunks`` at the resident blocks per SM that the library
    reports; the score kernel has no merge, so no merge cap."""
    if route == "decode":
        qb, rows = lib.vq_pq_decode_queries_per_block(), lib.vq_pq_decode_tile_rows()
        per_sm = lib.vq_pq_blocks_per_sm(1, 0, m, kk, k, int(k == 0), 0)
        per_block = qb
    else:
        rows = lib.vq_pq_table_step_rows()
        for qb in (8, 4, 1, 0):
            per_sm = lib.vq_pq_blocks_per_sm(0, qb, m, kk, k, int(k == 0), vec16)
            if per_sm > 0:
                break
        per_block = max(qb, 1)
    if per_sm < 1:
        raise RuntimeError(f"pq_scan: no {route} block fits on an SM (M={m}, K={kk}, k={k})")
    slots = sms * per_sm
    cap, kc = (lib.vq_merge_cap(), k) if k else (1 << 30, 1)
    return qb, grid_chunks(slots, -(-num_q // per_block), -(-n // rows), cap, kc)


def _scan(queries, codes, codebooks, k: int, l2: bool, limit: Optional[int], use_bf16: bool,
          route: str):
    """Launch one route's kernels on checked CUDA inputs: k = 0 gives
    ``pq_score_all``'s (Q, N) scores, else ``pq_scan_topk_fused``'s top-k.
    The CUDA runtime launches (and sets kernel attributes and answers
    occupancy queries) on the current device, so the whole call runs under
    the tensors' device."""
    with torch.cuda.device(codes.device):
        return _scan_on_device(queries, codes, codebooks, k, l2, limit, use_bf16, route)


def _scan_on_device(queries, codes, codebooks, k: int, l2: bool, limit: Optional[int],
                    use_bf16: bool, route: str):
    from vq_tpu_torch.kernels._build import check, load_library

    if route == "decode" and not use_bf16:
        raise ValueError("the decode route is bf16 only")
    lib = load_library()
    num_q, d = queries.shape
    n, m = codes.shape
    _, kk, dsub = codebooks.shape
    dev = codes.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = out_s = out_i = cand_s = cand_i = kth_g = None
    if k == 0:
        out = torch.empty((num_q, n), **f32)
        if n == 0 or num_q == 0:
            return out
    else:
        out_s = torch.empty((num_q, k), **f32)
        out_i = torch.empty((num_q, k), dtype=torch.int32, device=dev)
        if num_q == 0:  # an empty grid is not a launch
            return out_s, out_i
    vec16 = int(m % 16 == 0 and codes.data_ptr() % 16 == 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qb, chunks = _plan(lib, sms, route, m, kk, k, num_q, n, vec16)
    if k:
        ncand = num_q * (chunks + merge_groups(chunks, lib.vq_merge_cap(), k)) * k
        cand_s = torch.empty((ncand,), **f32)
        cand_i = torch.empty((ncand,), dtype=torch.int32, device=dev)
        kth_g = torch.full((num_q,), lib.vq_ordered_neg_inf(), dtype=torch.int32, device=dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    outs = (ptr(out), ptr(cand_s), ptr(cand_i), ptr(out_s), ptr(out_i), ptr(kth_g))
    lim = _limit(n, limit)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "decode":
        qpb, sd = lib.vq_pq_decode_queries_per_block(), lib.vq_pq_decode_stage_dims()
        q16 = torch.empty((-(-num_q // qpb) * qpb, -(-d // sd) * sd), dtype=torch.bfloat16,
                          device=dev)
        cb16 = torch.empty((m, kk, dsub), dtype=torch.bfloat16, device=dev)
        cnorm = torch.empty((m, kk), **f32)
        rn = torch.empty((n,), **f32) if l2 else None
        check(lib.vq_pq_decode_scan(queries.data_ptr(), codebooks.data_ptr(), codes.data_ptr(),
                                    q16.data_ptr(), cb16.data_ptr(), cnorm.data_ptr(), ptr(rn),
                                    *outs, num_q, n, m, kk, dsub, k, lim, int(l2), chunks,
                                    stream), "vq_pq_decode_scan")
    else:
        g = lib.vq_pq_table_group()
        lut = torch.empty((-(-num_q // g) * g, m, kk), **f32)
        check(lib.vq_pq_table_scan(queries.data_ptr(), codebooks.data_ptr(), codes.data_ptr(),
                                   lut.data_ptr(), *outs, num_q, n, m, kk, dsub, k, lim, int(l2),
                                   int(use_bf16), qb, vec16, chunks, stream),
              "vq_pq_table_scan")
    if k == 0:
        pq_score_all.launches += 1
        return out
    pq_scan_topk_fused.launches += 1
    return out_s, out_i


def pq_score_all(queries, codes, codebooks, l2: bool = True,
                 use_bf16: bool = True) -> torch.Tensor:
    """Fused decode+score over the corpus → (Q, N) f32 maximize-form scores.

    queries (Q, D) f32; codes (N, M) uint8; codebooks (M, K ≤ 256, dsub) f32.
    """
    if codes.device.type == "cpu":
        return pq_score_all_plain(queries, codes, codebooks, l2, use_bf16)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    _check_inputs(queries, codes, codebooks)
    return _scan(queries, codes, codebooks, 0, l2, None, use_bf16,
                 pq_route(codebooks.shape[2], use_bf16))


def pq_scan_topk_fused(queries, codes, codebooks, k: int, l2: bool = True,
                       limit: Optional[int] = None,
                       use_bf16: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused decode+score+top-k → ((Q, k) f32 maximize-form, (Q, k) i32).

    Exact: equal to top-k over the full score matrix, in (score desc, id
    asc) order; rows with id ≥ ``limit`` are masked; 1 ≤ k ≤ 128.
    """
    if codes.device.type == "cpu":
        return pq_scan_topk_fused_plain(queries, codes, codebooks, k, l2, limit, use_bf16)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    _check_inputs(queries, codes, codebooks, k)
    return _scan(queries, codes, codebooks, k, l2, limit, use_bf16,
                 pq_route(codebooks.shape[2], use_bf16))


pq_score_all.launches = 0
pq_scan_topk_fused.launches = 0


def reset_launch_counts() -> None:
    pq_score_all.launches = 0
    pq_scan_topk_fused.launches = 0
