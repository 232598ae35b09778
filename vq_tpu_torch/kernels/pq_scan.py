"""PQ ADC scan kernels: CUDA on the card, plain PyTorch on the CPU.

Counterpart of ``vq_tpu/kernels/pallas_scan.py``.  Two wrappers keep the
JAX functions' return contract:

* ``pq_score_all``  → (Q, N) f32 maximize-form scores
  (2·q·x̂ − ‖x̂‖² for l2, else q·x̂); the caller masks and selects.
* ``pq_scan_topk_fused`` → ((Q, k) f32 maximize-form, (Q, k) i32 ids),
  exact, ordered by score descending then id ascending; rows with id ≥
  ``limit`` are masked; empty slots hold −inf with id 0.

On a CUDA tensor each wrapper launches the hand-written kernels of
``csrc/pq_scan.cu`` (a per-query lookup-table build, then the scan) or
raises, for any M and K ≤ 256: the tables of up to 8 queries are kept in
shared memory, or, when one query's table does not fit (M·K above ~56k),
read from global memory.  On a CPU tensor it runs the plain version beside it
(``*_plain``), which the CPU tests hold against the JAX kernels in
interpret mode.  ``use_bf16`` rounds queries and codebooks to bf16 and
accumulates in f32, as the TPU kernel feeds its MXU; ``use_bf16=False``
computes in f32 throughout.  The TPU-only knobs of the JAX functions
(``tile``, ``interpret``, ``group``) have no counterpart: the CUDA kernels
take any N, and grouped decode was a TPU MXU tuning knob.

Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from vq_tpu_torch._device import round_bf16
from vq_tpu_torch.kernels.topk import ordered_topk

MAX_K = 128  # largest k of the fused kernel (the TPU kernel's _KPAD)
_SMEM_BYTES = 227 * 1024 - 1024  # per-block shared memory, less static use
_WAVES = 4  # blocks per SM slot the chunking aims for
_BLOCKS_PER_SM = 8  # 2048 resident threads / 256 a block


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
    n = codes.shape[0]
    s = pq_score_all_plain(queries, codes, codebooks, l2, use_bf16)
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


def _queries_per_block(num_sub: int, k_size: int, topk: bool) -> int:
    """Queries per block whose tables (plus top-k buffers) fit shared
    memory; 0 means one query per block with its table in global memory."""
    from vq_tpu_torch.kernels._build import load_library

    per_query = num_sub * k_size * 4
    if topk:
        per_query += load_library().vq_sort_cap() * 8
    for qb in (8, 4, 2, 1):
        if qb * per_query <= _SMEM_BYTES:
            return qb
    return 0


def _chunks(device, num_q: int, qb: int, smem: int, n_rows: int, cap: int) -> int:
    """Row chunks per query block: enough blocks for _WAVES waves over the
    SMs, at least 256 rows a chunk, at most ``cap``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = max(1, min(_BLOCKS_PER_SM, (_SMEM_BYTES + 1024) // max(smem, 1)))
    qblocks = -(-num_q // max(qb, 1))
    want = -(-_WAVES * sms * per_sm // qblocks)
    return max(1, min(want, -(-n_rows // 256), cap))


def _build_lut(lib, queries, codebooks, l2: bool, use_bf16: bool, stream) -> torch.Tensor:
    from vq_tpu_torch.kernels._build import check

    num_q, d = queries.shape
    m, kk, dsub = codebooks.shape
    lut = torch.empty((num_q, m, kk), dtype=torch.float32, device=queries.device)
    check(lib.vq_pq_lut(queries.data_ptr(), codebooks.data_ptr(), lut.data_ptr(), num_q, d,
                        m, kk, dsub, int(l2), int(use_bf16), stream), "vq_pq_lut")
    return lut


def pq_score_all(queries, codes, codebooks, l2: bool = True,
                 use_bf16: bool = True) -> torch.Tensor:
    """Fused decode+score over the corpus → (Q, N) f32 maximize-form scores.

    queries (Q, D) f32; codes (N, M) uint8; codebooks (M, K ≤ 256, dsub) f32.
    """
    if codes.device.type == "cpu":
        return pq_score_all_plain(queries, codes, codebooks, l2, use_bf16)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    from vq_tpu_torch.kernels._build import check, load_library

    _check_inputs(queries, codes, codebooks)
    lib = load_library()
    num_q = queries.shape[0]
    n, m = codes.shape
    kk = codebooks.shape[1]
    qb = _queries_per_block(m, kk, topk=False)
    out = torch.empty((num_q, n), dtype=torch.float32, device=codes.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    lut = _build_lut(lib, queries, codebooks, l2, use_bf16, stream)
    chunks = _chunks(codes.device, num_q, qb, qb * m * kk * 4, n, 1 << 16)
    check(lib.vq_pq_score_all(lut.data_ptr(), codes.data_ptr(), out.data_ptr(), num_q, n, m,
                              kk, qb, chunks, stream), "vq_pq_score_all")
    pq_score_all.launches += 1
    return out


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
    from vq_tpu_torch.kernels._build import check, load_library

    _check_inputs(queries, codes, codebooks, k)
    lib = load_library()
    num_q = queries.shape[0]
    n, m = codes.shape
    kk = codebooks.shape[1]
    qb = _queries_per_block(m, kk, topk=True)
    dev = codes.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    lut = _build_lut(lib, queries, codebooks, l2, use_bf16, stream)
    smem = qb * m * kk * 4 + max(qb, 1) * lib.vq_sort_cap() * 8
    chunks = _chunks(dev, num_q, qb, smem, n, lib.vq_merge_cap() // k)
    cand_s = torch.empty((num_q, chunks, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((num_q, chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((num_q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((num_q, k), dtype=torch.int32, device=dev)
    check(lib.vq_pq_scan_topk(lut.data_ptr(), codes.data_ptr(), cand_s.data_ptr(),
                              cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), num_q, n,
                              m, kk, k, _limit(n, limit), qb, chunks, stream),
          "vq_pq_scan_topk")
    pq_scan_topk_fused.launches += 1
    return out_s, out_i


pq_score_all.launches = 0
pq_scan_topk_fused.launches = 0


def reset_launch_counts() -> None:
    pq_score_all.launches = 0
    pq_scan_topk_fused.launches = 0
