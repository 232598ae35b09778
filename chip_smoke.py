#!/usr/bin/env python3
"""Drive the PyTorch port (``vq_tpu_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Device: the card's name and power limit (nvidia-smi), CUDA required,
   TF32 off.
2. Build the CUDA kernels of ``vq_tpu_torch/csrc`` from the checkout (one
   nvcc per source, in parallel); the ptxas report; the HMMA (tensor-core)
   instructions in the SASS of the packed kernel's bf16 instance and of
   the PQ decode route's kernels, which must have them.
3. The PQ kernels against their plain PyTorch versions on the card: f32
   edge cases at small shapes (the table route); the decode route's edge
   cases in bf16 (Q = 1, 7, 65; M=25, dsub 3 and 8; K=100; N < 128; M=300;
   k = 1, 10, 128; limit < k; planted ties) against the plain bf16
   version; then the PQ main path's widths (Q=1024, D=1536, N=100,000, M=16
   and M=192), f32 mode on scores and ids, bf16 mode on scores and recall
   against the plain f32 ids, the fused top-k equal to the top-k of the
   score kernel's scores bit for bit (f32 at k=10 and 100, bf16 on both
   routes), kernel and plain times in bf16 and f32 beside each route's
   bound; and both routes timed in bf16 at dsub 8, 16, 32 and 96 with the
   route ``pq_route`` picks.
4. The PQ main path — what ``vq_tpu/bench/sweep.py::run_single_config``
   does: PQ(M=16, B=8) fit, FlatQuantizedIndex fit (encode), ground truth
   by ``exact_topk``, search at k=10 and k=100 (fused kernel) and k=256
   (score kernel + streaming top-k), on a seeded power-law corpus at
   N=1,000,000, D=1536.  The kernels' launch counters must move during
   this phase.  The quantizer is built without a device and must follow
   the corpus onto the card.  Then where the time goes (torch.profiler over
   5 searches) and CUDA-event times of k=100 by the fused kernel and by the
   score kernel + streaming top-k, and of the score kernel over the whole
   corpus.
5. Quality gate: PQ(M=192, B=8) on the planted-neighbourhood corpus
   (N=100k, D=1536), recall@10 ≥ 0.763.
6. The packed kernel against its plain version (N=100,000 lognormal rows,
   D=1024, Q=256): SAQ uniform and lloyd (perdim + values segments),
   RaBitQ B=2 (shared table) and B=6 (value plane), each in L2 / IP / NIP
   at k=10 and k=100, f32 ids and scores, bf16 recall, prune ids = dense
   ids; every dequant kind must launch; edge cases (limit < k, limit
   masking, N < 512, k = 1 and 128, planted ties), and in bf16 Q = 1, 7
   and 65, N < 512, k = 1 and 128 and segment lengths that are not
   multiples of 16 against the plain bf16 version; kernel and plain times
   in bf16 (tensor cores) and f32 (FFMA), each beside its bound.
7. The SAQ path (``bench.py:248-380`` on the port): FlatQuantizedIndex(SAQ
   bpd=2, PCA) fit, encode and norm-ordered pack, ground truth, search at
   k=10 and k=100 on the power-law corpus (σ_i = (1+i)^-0.6, N=1,048,576,
   D=1024, Q=256), the prune stage's scanned fraction, a torch.profiler
   breakdown of the k=10 search; then the banded prune corpus: prune ids
   = dense ids and a scanned fraction below 1.
8. The RaBitQ path: FlatQuantizedIndex(RaBitQ B=2) on the same corpus
   shape, k=10.
9. The packed kernel's tile-gather mode against its plain version
   (N=100,000, D=1024, Q=256, the four phase-6 configurations on
   order-preserving caches): masks of every tile, 25% random, 5% in
   contiguous runs, one tile, only the last (partial) tile, no tile; L2 /
   IP / NIP at k=10 and 100, f32 ids and scores, bf16 recall, prune ids =
   unpruned ids, every tile = the dense kernel bit for bit, no tile = -inf
   with id 0, the same result at three ``mask_cap`` values; kernel and
   plain times in bf16 and f32 at the 25% and every-tile masks.  Its time table
   (dense vs gather at 100/25/5/1% of tiles, N=1,048,576, k=100) runs on
   phase 7's SAQ codes.
10. The probed-tile IVF path (``bench.py:478-651`` on the port, SAQ bpd=2):
   the planted full-rank corpus (N=1,048,576, D=1536), a coarse pass of
   K=4096 cells, ``IvfPackedFlatIndex.fit(coarse=...)``, searches at
   nprobe 50 / 200 / 4096 (Q=256) and 50 / 4096 (Q=8), k=100, with QPS,
   tiles masked in, recall@1/10/100 and recall@100 against nprobe=4096;
   RaBitQ B=2 at nprobe=50.  nprobe=4096 must equal the unmasked kernel bit
   for bit; the gather kernel against its plain version at the path's
   masks; the gather launch counter must move; a torch.profiler breakdown.
   The coarse pass runs twice and must give bit-equal centroids (phase 4
   likewise fits PQ M=16 twice: bit-equal codebooks).
11. The other quantizers on the flat index at full width: OPQ(M=16, B=8)
   on phase 4's corpus (fit, encode, k=10 and 100 through the fused PQ
   kernel, whose launch counter must move; the f32 kernel against its plain
   version on a 100k-row slice with the rotated queries; recall and MSE
   beside PQ M=16's); RankAware bpd=2 on phase 7's corpus (the packed
   kernel, prune ids = dense ids, the scanned fraction); SQ and LVQ at 8
   bits through the generic plain scan, where no kernel may launch.
12. The residual IVF index (``bench.py:543-573`` on the port) on phase 10's
   corpus and coarse pass: IvfQuantizedIndex(SAQ bpd=2) and (PQ M=192),
   build time, nprobe 50 / 200 at Q=256, k=100 (union strategy), recall
   and the batch's union fraction; windows = union where separated at Q=8;
   a profile; then IvfPackedFlatIndex(RankAware bpd=2) at nprobe=50, whose
   gather launches must move.
13. Sharded serving (``vq_tpu_torch/dist``) on a mesh of 4 shards on the
   one card, with the corpora (remade from their seeds), fits and
   single-device indexes of phases 4, 7, 10 and 12:
   ShardedFlatPQIndex(PQ M=16) at k=10 / 100 (fused kernel) / 256 (score
   kernel) = FlatQuantizedIndex (scores bit for bit, ids up to ties, each
   id that differs rescored to its rank's score), at P=4 and at a ragged
   P=3, overlap_chunks=4 = 1; ShardedPackedFlatIndex(SAQ bpd=2) at k=10 /
   100 (f32 ids = the flat index's where separated, bf16 recall ≥ 0.99,
   overlap_chunks=2 = 1, each shard's prune fraction, the overlap chunks'
   factor copies); ShardedIvfPackedIndex(SAQ, fit(coarse=…)) at nprobe 50
   = IvfPackedFlatIndex (as PQ); ShardedIVFIndex(phase 12's SAQ) = an
   IvfQuantizedIndex on its centroids where separated; every search's
   launches = P per kernel; dp_lloyd_step twice, bit-equal; the port's
   dryrun_multichip(4); each index timed beside its single-device search,
   profiles and the merge's time; with more than one card the PQ and SAQ
   checks again on a mesh of one shard per card.

14. The harness and CLI (``vq_tpu_torch.cli.main`` in this process, so the
   launch counters see its kernels) on the card, each step's logged rows
   read back (SQLite, CSV, .npy) and its kernels required: precompute-gt
   on planted-1000000x1536 (= the Dataset's ground truth, and = a plain
   ``torch.cdist`` over the rows for every 16th query where separated);
   run PQ M=16 at k=256 (the fused kernel for the recall search, the score
   kernel for ``measure_qps``); sweep PQ M=16 + SAQ bpd=2 (fused and packed
   kernels); ivf-bench saq_ivf_packed + pq_flat at bpd 1, K=4096, nprobe
   50 (gather kernel; PQ M=192 on the fused kernel's decode route; every
   row's ``error`` empty); streaming-sweep PQ on dummy-262144x1536; run PQ
   M=192 on planted-100000x1536 (recall@10 ≥ 0.763); study (pq, ours,
   saq_paper at bpd 1 and 2 on fvecs files of planted-100000x1536: the
   packed kernel's NIP path); not plot (no matplotlib on the card's
   machine, ``PLOT_ON_CARD``); then ``python -m vq_tpu_torch run`` in a
   subprocess.  Every kernel call a step makes is recorded (one per
   launch), and each distinct shape is held against its plain version on
   the same inputs after the step (f32 ids where separated; bf16 scores
   for PQ, recall for the packed kernel).  The sweep's PQ M=16
   configuration runs once more outside the CLI, through
   ``run_single_config`` with its callees timed (``[profile] harness``
   lines: each callee's seconds and host→card copies); its recall@10 and
   the logged ones of run and sweep must equal, bit for bit, that of a
   FlatQuantizedIndex the phase builds on the same dataset from the same
   seed without the harness.

15. The search options, run after phase 13 (before 14), while phases 4, 7
   and 10's indexes are alive: the packed kernel on SAQ segment subsets
   (the head 1 and 2 segments, and the last alone, whose scale and L2
   shift columns are not the first ones) against its plain version on
   phase 6's corpus, k = 50 and 100, L2 / IP / NIP, a norm-ordered and an
   order-preserving cache, timed beside its bound; the head-segment
   cascade on phase 7's index (prune_segments 1 and 2 × rerank_factor 5
   and 10: recall@10 and ms beside the dense search; each one's stage-1
   kernel call, a segment subset at N=1,048,576 and k1 = 50 or 100,
   against its plain version as phase 14 holds its calls; rerank_factor·k >
   128 = the dense search bit for bit; the rerank = a plain f32 rescore
   of its candidates by the full decode; ``[profile] SAQ cascade``);
   probe-coherent query groups on phase 10's index (G = 1, 4, 16 at Q =
   256 and 64, on phase 10's queries and on a coherent stream, queries
   near one row of each of 8 cells: Σ tiles, ms per search, recall against
   the exact top-100 and the full probe, the last ≥ the per-query probe
   ceiling; G=1 = the ungrouped search bit for bit; each G > 1 = its
   per-group plain witness, by recall in bf16 at Q=256 and where
   separated in f32 at Q=64);
   ``approx=True`` = ``approx=False`` bit for bit on the PQ M=16 flat index
   at k=256, a sharded PQ index, SQ 8 bits and the IVF-packed index.

16. The multi-process mesh, run last (after 14), in processes of its own
   (``torch.multiprocessing``, spawn; joined within ``RANKS_TIMEOUT_S``,
   then killed, and any rank's non-zero exit fails the script), on phases
   4, 7 and 10's fits (``save`` → ``load``) and corpora (remade from their
   seeds in each process): ShardedFlatPQIndex(PQ M=16) at N=1,000,000,
   D=1536, Q=1024, k = 10, 100, 256; ShardedPackedFlatIndex(SAQ bpd=2) at
   N=1,048,576, D=1024, Q=256, k = 10, 100; ShardedIvfPackedIndex(SAQ) on
   phase 10's corpus and coarse pass, nprobe 50, Q=256, k=100; dp_lloyd_step
   twice.  Each index is built by ``fit`` on a 4-shard mesh of one process
   (the witness), then (a) in 2 gloo ranks on the card, 2 shards each, and
   (b) in one NCCL rank a card (``env://`` on 127.0.0.1; on one card one
   rank of 4 shards), PQ and SAQ:
   every rank's ids, scores, centroids and footprints = the witness's bit
   for bit, its launches a search its shards' share of the witness's, its
   merges gone through ``torch.distributed``; each search's ms per rank
   beside the witness's, and the merge's (``_fold``) at Q=1024.

Phases 6 and 9 hold a fifth configuration, RankAware bpd=2 (one segment
per bit width, "perdim" and "values", no per-row scale: scale_col −1), and
phase 6 its FFD packing once.

The line before the last is a JSON object of the kernels: launches of
phase 14's CLI steps (which run all four kernels), with each path's
own count beside them (``launches_by_path``: each path's counters read
just after it, phase 15's among them, and phase 16's ranks' summed over
the ranks); errors from phases 3, 6, 9, 14
and 15, times from 3, 6 and 9; each kernel's bound, the least time the card could take for the timed
call.  A
``[launches] by path`` line before it holds the same counts by path;
the card's name and power limit are printed before it, and the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

RECALL_GATE_PQ192_FLOOR = 0.763  # bench.py:48
# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W): memory rate
# and the operation rate of each operand type (bf16 on the tensor cores,
# f32 outside them).  The 67e12 FP32 rate counts an FMA as two operations,
# so lone f32 adds (the PQ tables' sums) peak at half of it.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "f32 add": 33.5e12}
# f32 mode: kernel and plain scores differ only in the order of f32 sums
# (per-subspace table entries vs one length-D dot product).  The rounding
# error of a sum is relative to the magnitude of its terms, not of the
# result (an L2 score 2·q·x̂ − ‖x̂‖² can be near 0 while its terms are not);
# for D=1536 the worst case is ~D·2⁻²⁴ ≈ 1e-4 of that magnitude.  So scores
# agree within 1e-4 · (‖q‖² + 2·max‖x̂‖²), a per-query bound on |terms|
F32_RTOL = 1e-4
BF16_MIN_RECALL = 0.99
# A row rescored in f32 beside a bf16 search's score: the search rounds the
# query and the decoded values to bf16 (relative error ≤ 2^-9 each), so the
# score's terms |2·q·x̂| + ‖x̂‖² ≤ ‖q‖² + 2·‖x̂‖² move by about 2^-8 of
# their size; 2^-7 leaves a factor of two.
BF16_RTOL = 2.0 ** -7


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int = 5, warmup: int = 2) -> float:
    """Median device time of fn over `reps` runs (CUDA events), after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def wall_s(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def require_launched(counts: dict, what: str) -> None:
    """Every kernel of `counts` ({wrapper name: launches}) was launched."""
    require(all(v > 0 for v in counts.values()), f"{what}: {counts}")


def require_launches(got: int, want: int, what: str) -> None:
    """A launch counter moved by exactly `want`."""
    require(got == want, f"{what}: {got} launches, {want} expected")


# ---------------------------------------------------------------- bounds
def bound_ms(nbytes: float, op_s: float):
    """(least ms, what sets it): the larger of the bytes over the memory
    rate and ``op_s``, the seconds the operations take at peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, op_s) * 1e3, ("bytes" if t_bytes >= op_s else "operations")


def pq_bound(q, codes, cb, k, bf16, score_all):
    """A PQ kernel's bound, the lesser of its two routes' (``pq_route``):
    each route's operations set against the bytes (codes, codebooks and
    queries read once, the (Q, k) top-k or the (Q, N) scores written once).
    Table route: the per-query tables (2·K·D products a query, in the
    operands' type) plus one f32 add per (query, row, subspace); decode
    route: 2·Q·N·D products in the operands' type.  Returns (ms, what sets
    it, the route that sets it, {route: ms})."""
    nq, d = q.shape
    n, m = codes.shape
    nbytes = (codes.numel() * codes.element_size() + cb.numel() * 4 + q.numel() * 4
              + (nq * n * 4 if score_all else nq * k * 8))
    rate = PEAK_OPS_PER_S["bf16" if bf16 else "f32"]
    routes = {"table": bound_ms(nbytes, 2.0 * nq * cb.shape[1] * d / rate
                                + float(nq) * n * m / PEAK_OPS_PER_S["f32 add"]),
              "decode": bound_ms(nbytes, 2.0 * nq * n * d / rate)}
    best = min(routes, key=lambda r: routes[r][0])
    return routes[best][0], routes[best][1], best, {r: v[0] for r, v in routes.items()}


def pq_bound_text(b) -> str:
    return (f"{b[0]:.4f} ms ({b[1]}, {b[2]} route; table {b[3]['table']:.4f}, decode "
            f"{b[3]['decode']:.4f})")


def scanned_rows(torch, n_pad, limit, tile_mask=None):
    """Rows below `limit` in the tiles a scan reads (all, or the masked-in)."""
    valid = torch.clamp(limit - torch.arange(0, n_pad, 512), 0, 512)
    if tile_mask is not None:
        valid = valid * (tile_mask.cpu() != 0)
    return int(valid.sum())


def factor_rows_read(a) -> int:
    """The factor rows a packed call reads: its segments' scale columns, the
    L2 shift columns (L2) or the norm column (NIP)."""
    cols = {s.scale_col for s in a["segs"] if s.scale_col >= 0}
    if a["metric_kind"] == "l2":
        cols |= set(a["r2_cols"])
    elif a["metric_kind"] == "nip":
        cols.add(a["norm_col"])
    return len(cols)


def packed_bound(torch, a):
    """The packed kernel's bound for ``packed_scan_topk`` arguments ``a``:
    the scanned rows' words and the factor rows the call reads
    (``factor_rows_read``: a segment subset reads its own), the level
    tables, the queries (and the mask) read once, the (Q, k) top-k written
    once; 2·Q·D operations a scanned row, in the operands' type (bf16 in
    bf16 mode)."""
    fac = a["factors"]
    n_pad = fac.shape[1]
    mask = a.get("tile_mask")
    rows = scanned_rows(torch, n_pad, a["limit"], mask)
    per_row = (sum(w.numel() * w.element_size() for w in a["words"]) / n_pad
               + factor_rows_read(a) * 4)
    nq, d = a["q_cat"].shape
    nbytes = (rows * per_row + sum(t.numel() * 4 for t in a["lv_tables"]) + nq * (d + 1) * 4
              + nq * a["k"] * 8 + (0 if mask is None else mask.numel() * mask.element_size()))
    ops = 2.0 * nq * rows * d
    return bound_ms(nbytes, ops / PEAK_OPS_PER_S["bf16" if a["use_bf16"] else "f32"])


# ------------------------------------------------------------------ data
def powerlaw_corpus(torch, n, d, nq, seed, dev):
    """bench.py:79-88: rows N(0, diag σ²) with σ_i = (1+i)^-0.75; queries are
    corpus rows jittered by 0.25σ."""
    g = torch.Generator(device=dev).manual_seed(seed)
    sigma = (1.0 + torch.arange(d, device=dev, dtype=torch.float32)) ** -0.75
    x = torch.randn((n, d), generator=g, device=dev).mul_(sigma)
    qidx = torch.randint(0, n, (nq,), generator=g, device=dev)
    q = x[qidx] + 0.25 * sigma * torch.randn((nq, d), generator=g, device=dev)
    return x, q


def planted_corpus(torch, n, d, nq, seed, dev, rank=32, csize=10, spread=0.5):
    """bench.py:196-215: a rank-32 manifold in D with 10-row near-duplicate
    neighbourhoods, unit-normalized rows (the port's ``planted-NxD``
    generator, ``data/datasets.py::planted_arrays``)."""
    from vq_tpu_torch.data.datasets import planted_arrays

    return planted_arrays(n, d, nq, rank, csize, spread, seed, dev)


def remake(torch, maker, dev):
    """A corpus (x, q) from a context's ``maker``: the name of its function
    here and the arguments before the device (phases 13, 15 and 16 remake
    phases 4, 7 and 10's corpora from their seeds)."""
    name, args = maker
    return globals()[name](torch, *args, dev=dev)[:2]


def random_codebooks(torch, x, m, kk, seed):
    """Codebooks of kk random corpus rows per subspace (no k-means: phase 3
    checks the kernels, not the fit)."""
    n, d = x.shape
    g = torch.Generator(device=x.device).manual_seed(seed)
    rows = x[torch.randperm(n, generator=g, device=x.device)[:kk]]
    return rows.reshape(kk, m, d // m).transpose(0, 1).contiguous()


def recall(gt, ids, k: int) -> float:
    """Mean |gt top-k ∩ ids top-k| / k over queries."""
    gt, ids = np.asarray(gt)[:, :k], np.asarray(ids)[:, :k]
    return float(np.mean([len(set(t.tolist()) & set(r.tolist())) / k
                          for t, r in zip(gt, ids)]))


# ---------------------------------------------------------------- phase 3
def f32_tol(torch, q, cb):
    """(Q, 1) tolerance: F32_RTOL · (‖q‖² + 2·Σ_m max_c ‖c_mc‖²), which
    bounds |2·q·x̂| + ‖x̂‖² for every row (see F32_RTOL)."""
    x_max = torch.sum(torch.amax(torch.sum(cb * cb, dim=-1), dim=-1))
    return F32_RTOL * (torch.sum(q * q, dim=1, keepdim=True) + 2.0 * x_max)


def check_scores(torch, got, want, tol, what):
    err = (got - want).abs()
    bad = int((err > tol).sum())
    require(bad == 0, f"{what}: {bad} scores off by more than the f32 tolerance (worst "
                      f"err/tol {float((err / tol).max()):.3g})")
    return float(err.max())


def check_topk_f32(torch, got_s, got_i, ref_s, ref_i, k, tol, what):
    """ref_* are the plain version's top-(k+1).  Scores within tolerance;
    ids equal as sets where the k-th/(k+1)-th gap exceeds the tolerance,
    and position by position where every adjacent gap does."""
    err = check_scores(torch, got_s, ref_s[:, :k], tol, what)
    gaps = ref_s[:, :-1] - ref_s[:, 1:]
    sep = gaps[:, k - 1:k] > tol
    sets_ok = (torch.sort(got_i, 1).values == torch.sort(ref_i[:, :k], 1).values).all(1)
    require(bool((sets_ok | ~sep[:, 0]).all()), f"{what}: id sets differ at separated queries")
    ordered = (gaps[:, :k] > tol).all(1)
    pos_ok = (got_i == ref_i[:, :k]).all(1)
    require(bool((pos_ok | ~ordered).all()), f"{what}: id order differs at separated queries")
    return err, int(sep.sum()), int(ordered.sum())


def phase_kernel_edges(torch, dev, nq=517, n=20000):
    """Small shapes: odd Q, ragged N, chunks of several row tiles, limit
    masking, limit < k, k = 128, IP, planted ties.  f32 ids must equal the
    plain version's where scores are separated; ties go to the lower id."""
    from vq_tpu_torch.kernels import pq_scan as ps

    ps.reset_launch_counts()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((nq, 64), generator=g, device=dev)
    codes = torch.randint(0, 256, (n, 8), generator=g, device=dev).to(torch.uint8)
    cb = torch.randn((8, 256, 8), generator=g, device=dev)
    tol = f32_tol(torch, q, cb)
    for l2 in (True, False):
        s = ps.pq_score_all(q, codes, cb, l2=l2, use_bf16=False)
        check_scores(torch, s, ps.pq_score_all_plain(q, codes, cb, l2, False), tol,
                     "score_all edge")
        for k, limit in ((7, None), (128, None), (10, n - 5679), (5, 3)):
            ks, ki = ps.pq_scan_topk_fused(q, codes, cb, k, l2=l2, limit=limit, use_bf16=False)
            rs, ri = ps.pq_scan_topk_fused_plain(q, codes, cb, k + 1, l2, limit, False)
            if limit is not None and limit < k:
                require(bool((ks[:, limit:] == -np.inf).all() and (ki[:, limit:] == 0).all()),
                        "limit < k must leave -inf / id 0")
                rs, ri = rs[:, :limit + 1], ri[:, :limit + 1]
                ks, ki, kk = ks[:, :limit], ki[:, :limit], limit
            else:
                kk = k
            require(bool((ki < (limit or n)).all()), "ids past limit")
            check_topk_f32(torch, ks, ki, rs, ri, kk, tol, f"fused edge k={k} limit={limit}")
    # planted ties: every row identical → ids 0..k-1 in order
    same = codes[:1].repeat(3000, 1)
    for k in (6, 100):
        _, ti = ps.pq_scan_topk_fused(q, same, cb, k, use_bf16=False)
        require(bool((ti == torch.arange(k, device=dev)).all()), "tie order")
    # M=256, K=256: one query's table (256 KB) exceeds shared memory, so the
    # kernels read it from global memory
    q = torch.randn((nq, 512), generator=g, device=dev)
    codes = torch.randint(0, 256, (n, 256), generator=g, device=dev).to(torch.uint8)
    cb = torch.randn((256, 256, 2), generator=g, device=dev)
    tol = f32_tol(torch, q, cb)
    check_scores(torch, ps.pq_score_all(q, codes, cb, use_bf16=False),
                 ps.pq_score_all_plain(q, codes, cb, True, False), tol, "score_all M=256")
    ks, ki = ps.pq_scan_topk_fused(q, codes, cb, 10, limit=n - 77, use_bf16=False)
    rs, ri = ps.pq_scan_topk_fused_plain(q, codes, cb, 11, True, n - 77, False)
    check_topk_f32(torch, ks, ki, rs, ri, 10, tol, "fused M=256")
    torch.cuda.synchronize()
    log(f"[phase 3] edge cases ok ({time.perf_counter() - t0:.3f} s)")
    require_launched({"pq_score_all": ps.pq_score_all.launches,
                      "pq_scan_topk_fused": ps.pq_scan_topk_fused.launches},
                     "edge cases did not launch every kernel")


def pq_call(torch, route, q, codes, cb, k=0, l2=True, limit=None):
    """One bf16 PQ kernel call by ``route`` ("decode" or "table"; k = 0:
    ``pq_score_all``, else the fused top-k); on the CPU, where the
    rehearsal runs, the plain version."""
    from vq_tpu_torch.kernels import pq_scan as ps

    if codes.is_cuda:
        return ps._scan(q, codes, cb, k, l2, limit, True, route)
    if k == 0:
        return ps.pq_score_all_plain(q, codes, cb, l2, True)
    return ps.pq_scan_topk_fused_plain(q, codes, cb, k, l2, limit, True)


def phase_decode_edges(torch, dev):
    """The decode route (bf16, tensor cores) on the shapes it finds hard,
    held to the plain bf16 version (the same bf16 products summed in
    another order, so scores within the f32 tolerance): Q not a multiple of
    8 or 64, M=25 (the last 64-dim stage partly zero), K=100, N < 128,
    dsub=3 (codewords not 16-byte aligned), M=300 (codes read past the 256
    a row tile stages); k = 1, 10, 128, limit < k.  Ids below the limit,
    limit < k leaving -inf / id 0, the fused top-k = the top-k of the score
    kernel's scores bit for bit, planted ties giving ids 0..k-1."""
    from vq_tpu_torch.kernels import pq_scan as ps

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(6)
    shapes = (("M=25 dsub=8 Q=65", 65, 3000, 25, 256, 8), ("K=100 Q=7", 7, 3000, 16, 100, 8),
              ("N=77 Q=1", 1, 77, 24, 256, 8), ("dsub=3 Q=65", 65, 2000, 25, 256, 3),
              ("M=300 dsub=2 Q=33", 33, 1500, 300, 64, 2))
    worst = 0.0
    for what, nq, n, m, kk, dsub in shapes:
        q = torch.randn((nq, m * dsub), generator=g, device=dev)
        codes = torch.randint(0, kk, (n, m), generator=g, device=dev).to(torch.uint8)
        cb = torch.randn((m, kk, dsub), generator=g, device=dev)
        tol = f32_tol(torch, q, cb)
        for l2 in (True, False):
            s = pq_call(torch, "decode", q, codes, cb, l2=l2)
            worst = max(worst, check_scores(torch, s, ps.pq_score_all_plain(q, codes, cb, l2, True),
                                            tol, f"decode score_all {what} l2={l2}"))
            for k, limit in ((1, None), (10, n - 17), (128, None), (10, 5)):
                case = f"decode fused {what} l2={l2} k={k} limit={limit}"
                ks, ki = pq_call(torch, "decode", q, codes, cb, k, l2, limit)
                ts, ti = ps.topk_of_scores(s, k, limit)
                require(torch.equal(ks, ts) and torch.equal(ki, ti),
                        f"{case}: top-k differs from the score kernel's top-k")
                lim = min(n, limit or n)
                require(bool((ki < max(lim, 1)).all()), f"{case}: ids past limit")
                if lim < k:
                    require(bool((ks[:, lim:] == -np.inf).all() and (ki[:, lim:] == 0).all()),
                            f"{case}: limit < k must leave -inf / id 0")
                rs, _ = ps.pq_scan_topk_fused_plain(q, codes, cb, k, l2, limit, True)
                kk_ = min(k, lim)
                worst = max(worst, check_scores(torch, ks[:, :kk_], rs[:, :kk_], tol, case))
        same = codes[:1].repeat(300, 1)  # every row identical → ids 0..k-1 in order
        for k in (6, 100):
            _, ti = pq_call(torch, "decode", q, same, cb, k)
            require(bool((ti == torch.arange(k, device=dev)).all()), f"decode tie order {what}")
    torch.cuda.synchronize()
    log(f"[phase 3] decode-route edge cases ok, scores within the f32 tolerance of the plain "
        f"bf16 version (max_abs_err={worst:.3e}; {time.perf_counter() - t0:.3f} s)")


def phase_kernels(torch, dev, results, n=100_000, d=1536, nq=1024):
    """The PQ kernels at the main path's widths (Q=1024, D=1536, N=100,000,
    K=256, k=10).  At the PQ main path's M=16 and the gate's M=192: f32
    scores and ids against the plain version, the fused top-k =
    the top-k of the score kernel's scores at k=10 and 100, bf16 scores and
    recall, kernel / plain times in bf16 and f32 beside both routes'
    bounds.  At M = 16, 48, 96 and 192 (dsub 96, 32, 16, 8): both routes
    timed in bf16, each with its fused top-k = the score kernel's bit for
    bit, and the route pq_route picks."""
    from vq_tpu_torch.kernels import pq_scan as ps
    from vq_tpu_torch.kernels.topk import ordered_topk
    from vq_tpu_torch.methods.pq import encode_chunked

    k = 10
    x, q = powerlaw_corpus(torch, n, d, nq, seed=3, dev=dev)
    for m in (16, 48, 96, 192):
        cb = random_codebooks(torch, x, m, 256, seed=m)
        codes = encode_chunked(cb, x)
        tag = f"M={m} dsub={d // m}"
        if m in (16, 192):
            # f32 mode (the table route)
            tol = f32_tol(torch, q, cb)
            s_k = ps.pq_score_all(q, codes, cb, use_bf16=False)
            s_p = ps.pq_score_all_plain(q, codes, cb, True, False)
            err_score = check_scores(torch, s_k, s_p, tol, f"score_all f32 {tag}")
            # both kernels sum the same table entries in the same order, so the
            # fused top-k must be exactly the top-k of the score kernel's scores
            for kc in (k, 100):
                ks, ki = ps.pq_scan_topk_fused(q, codes, cb, kc, use_bf16=False)
                ss, si = ordered_topk(s_k, kc)
                require(torch.equal(ki, si) and torch.equal(ks, ss),
                        f"fused f32 {tag} k={kc}: top-k differs from the score kernel's top-k")
            del s_k, s_p, ss, si
            ks, ki = ps.pq_scan_topk_fused(q, codes, cb, k, use_bf16=False)
            rs, ri = ps.pq_scan_topk_fused_plain(q, codes, cb, k + 1, True, None, False)
            err_fused, n_sep, n_ord = check_topk_f32(torch, ks, ki, rs, ri, k, tol,
                                                      f"fused f32 {tag}")
            log(f"[phase 3] {tag} f32: score_all max_abs_err={err_score:.3e} fused "
                f"max_abs_err={err_fused:.3e}; fused ids = top-k of score kernel at k=10 and "
                f"100; ids = plain at {n_sep}/{nq} separated queries ({n_ord} fully ordered)")
            # bf16 mode: kernel vs plain-bf16 scores, recall vs plain f32 ids
            s_k = ps.pq_score_all(q, codes, cb, use_bf16=True)
            check_scores(torch, s_k, ps.pq_score_all_plain(q, codes, cb, True, True), tol,
                         f"score_all bf16 {tag}")
            del s_k
            _, bi = ps.pq_scan_topk_fused(q, codes, cb, k, use_bf16=True)
            rec = recall(ri[:, :k].cpu(), bi.cpu(), k)
            log(f"[phase 3] {tag} bf16 ({ps.pq_route(d // m, True)} route): fused recall@{k} "
                f"vs plain f32 ids = {rec:.4f}")
            require(rec >= BF16_MIN_RECALL, f"bf16 recall {rec} < {BF16_MIN_RECALL}")
            # times, bf16 as the main path runs them, and f32
            tm = {}
            for bf16 in (True, False):
                tm[bf16] = [cuda_ms(torch, fn) for fn in (
                    lambda: ps.pq_scan_topk_fused(q, codes, cb, k, use_bf16=bf16),
                    lambda: ps.pq_scan_topk_fused_plain(q, codes, cb, k, True, None, bf16),
                    lambda: ps.pq_score_all(q, codes, cb, use_bf16=bf16),
                    lambda: ps.pq_score_all_plain(q, codes, cb, True, bf16))]
                log(f"[phase 3] {tag} times (ms, median of 5, {'bf16' if bf16 else 'f32'}): "
                    f"fused kernel {tm[bf16][0]:.3f} plain {tm[bf16][1]:.3f}; score_all kernel "
                    f"{tm[bf16][2]:.3f} plain {tm[bf16][3]:.3f}")
            for name, err, i, score_all in (("pq_scan_topk_fused", err_fused, 0, False),
                                            ("pq_score_all", err_score, 2, True)):
                r = results.setdefault(name, {"max_abs_err": 0.0, "times": {}, "bounds": {}})
                r["max_abs_err"] = max(r["max_abs_err"], err)
                r["times"][tag] = (tm[True][i], tm[True][i + 1])
                b16, b32 = (pq_bound(q, codes, cb, k, bf16, score_all) for bf16 in (True, False))
                r["bounds"][tag] = b16[:2]
                log(f"[phase 3] {tag} {name} bound bf16 {pq_bound_text(b16)}; f32 "
                    f"{pq_bound_text(b32)}")
        # both routes in bf16: the crossover of pq_route
        rt = {}
        for route in ("decode", "table"):
            fs, fi = pq_call(torch, route, q, codes, cb, k)
            ss, si = ps.topk_of_scores(pq_call(torch, route, q, codes, cb), k)
            require(torch.equal(fi, si) and torch.equal(fs, ss),
                    f"{route} route {tag} bf16: fused top-k differs from the score kernel's")
            rt[route] = (cuda_ms(torch, lambda: pq_call(torch, route, q, codes, cb, k)),
                         cuda_ms(torch, lambda: pq_call(torch, route, q, codes, cb)))
        log(f"[phase 3] routes {tag} bf16 k={k} (ms, median of 5): decode fused "
            f"{rt['decode'][0]:.3f} score_all {rt['decode'][1]:.3f}; table fused "
            f"{rt['table'][0]:.3f} score_all {rt['table'][1]:.3f}; fused top-k = score "
            f"kernel's bit for bit on both; pq_route picks {ps.pq_route(d // m, True)}")
        del codes, cb
    del x, q
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4
def profile_fn(torch, fn, reps: int = 5):
    """torch.profiler over `reps` calls of fn after one warm-up → (wall ms a
    call, device-busy ms a call, device kernels launched a call, {device
    activity: ms a call}, {CUDA runtime call: calls a call})."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
    per_kernel, kernels, runtime = {}, 0, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.device_time / reps / 1e3
            kernels += not e.name.startswith(("Memcpy", "Memset"))
        elif e.name.startswith("cuda"):
            runtime[e.name] = runtime.get(e.name, 0.0) + 1.0 / reps
    busy = sum(per_kernel.values())
    require(busy > 0, "torch.profiler recorded no device time")
    return wall_ms, busy, kernels / reps, per_kernel, runtime


def profile_search(torch, index, q, ks=(10, 100, 256), tag="", reps: int = 5) -> None:
    """torch.profiler over `reps` searches at each k: wall and device-busy ms
    per search, idle share, device ms per kernel."""
    for k in ks:
        wall_ms, busy, _, per_kernel, _ = profile_fn(
            torch, lambda: index.search_with_scores(q, k), reps)
        log(f"[profile]{tag} search k={k}: wall {wall_ms:.3f} ms/search, device busy "
            f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.3f} (torch.profiler, {reps} "
            f"searches)")
        for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
            log(f"[profile]{tag}   {ms:9.3f} ms/search  {name[:100]}")


def phase_main(torch, dev, n=1_000_000, d=1536, nq=1024, profile=True):
    from vq_tpu_torch import KMeansConfig, PQConfig, SearchConfig
    from vq_tpu_torch.index.flat import FlatQuantizedIndex
    from vq_tpu_torch.kernels import pq_scan as ps
    from vq_tpu_torch.kernels.adc import _score_kernel_topk, exact_topk
    from vq_tpu_torch.methods.pq import PQ

    (x, q), t_gen = wall_s(torch, lambda: powerlaw_corpus(torch, n, d, nq, seed=0, dev=dev))
    log(f"[phase 4] corpus N={n} D={d} Q={nq} on {dev}: {t_gen:.3f} s "
        f"({x.numel() * 4 / 1e9:.2f} GB)")
    ps.reset_launch_counts()
    pq = PQ(PQConfig(num_subquantizers=16, num_bits=8, kmeans=KMeansConfig(iters=20)),
            seed=0)  # no device: the quantizer takes the corpus's
    _, t_fit = wall_s(torch, lambda: pq.fit(x))
    require(pq.device == x.device, f"quantizer on {pq.device}, corpus on {x.device}")
    # the Lloyd step sums in a fixed order: one seed, one set of codebooks
    again, t_fit2 = wall_s(torch, lambda: PQ(pq.cfg, seed=0).fit(x))
    require(torch.equal(again.params.codebooks, pq.params.codebooks),
            "two PQ fits from one seed gave different codebooks")
    log(f"[phase 4] PQ M=16 fitted twice from seed 0: codebooks bit-equal ({t_fit:.3f} s, "
        f"{t_fit2:.3f} s)")
    del again
    index = FlatQuantizedIndex(pq, SearchConfig(use_bf16=True))
    _, t_enc = wall_s(torch, lambda: index.fit(x))
    require(index.codes.device == x.device and pq.params.codebooks.device == x.device,
            "index state left the corpus's device")
    (gt_s, gt_i), t_gt = wall_s(torch, lambda: exact_topk(q, x, 100))
    gt = gt_i.cpu().numpy()
    log(f"[phase 4] fit {t_fit:.3f} s; encode (index fit) {t_enc:.3f} s "
        f"({n / t_enc:.0f} rows/s); ground truth k=100 {t_gt:.3f} s")
    out = {}
    for k in (10, 100, 256):  # k ≤ 128: the fused kernel; 256: the score kernel
        index.search_with_scores(q, k)  # warm-up
        runs = [wall_s(torch, lambda: index.search_with_scores(q, k)) for _ in range(3)]
        ids, scores = runs[-1][0]
        t = float(np.median([r[1] for r in runs]))
        require(ids.shape == (nq, k) and scores.shape == (nq, k), f"k={k} result shape")
        require(bool(np.isfinite(scores).all()) and int(ids.max()) < n, f"k={k} result values")
        require(bool((np.diff(scores, axis=1) >= 0).all()), f"k={k} distances not ascending")
        out[k] = ids
        recalls = ", ".join(f"recall@{r} {recall(gt, ids, r):.4f}" for r in sorted({10, min(k, 100)}))
        log(f"[phase 4] search k={k}: {t * 1e3:.3f} ms/batch (median of 3, host clock), "
            f"QPS {nq / t:.1f}, {recalls}")
    launches = {"pq_scan_topk_fused": ps.pq_scan_topk_fused.launches,
                "pq_score_all": ps.pq_score_all.launches}
    log(f"[phase 4] launches during the main path: {launches}")
    require_launched(launches, "a kernel of the main path never launched")
    # both kernels sum the same table entries in the same order: the k=10 ids
    # are k=100's head, and k=100's are k=256's
    require(bool((out[10] == out[100][:, :10]).all()), "k=10 and k=100 searches disagree")
    require(bool((out[100] == out[256][:, :100]).all()), "k=100 and k=256 searches disagree")
    # reference on a query subset: the plain version on the same codes
    sub = q[:64]
    _, ri = ps.pq_scan_topk_fused_plain(sub, index.codes, pq.params.codebooks, 10, True, None,
                                        True)
    rec = recall(ri.cpu(), out[10][:64], 10)
    log(f"[phase 4] kernel vs plain (64 queries, bf16) recall@10 = {rec:.4f}")
    require(rec >= BF16_MIN_RECALL, "main path disagrees with its plain reference")
    if profile:
        profile_search(torch, index, q)
        # k=100 by both routes of scan_codes_topk (CUDA events): the fused
        # kernel, and the score kernel over row tiles + streaming top-k; and
        # the score kernel alone over all rows
        codes, cb = index.codes, pq.params.codebooks
        t_fused = cuda_ms(torch, lambda: ps.pq_scan_topk_fused(q, codes, cb, 100))
        t_two = cuda_ms(torch, lambda: _score_kernel_topk(q, codes, cb, 100, True, True, n))
        t_score = cuda_ms(torch, lambda: ps.pq_score_all(q, codes, cb))
        log(f"[profile] N={codes.shape[0]} k=100 bf16 (CUDA events, median of 5): fused kernel "
            f"{t_fused:.3f} ms; score kernel + streaming top-k {t_two:.3f} ms; "
            f"pq_score_all over all rows {t_score:.3f} ms")
    del x, q
    torch.cuda.empty_cache()
    # phases 13 and 16 remake the corpus from its seed and reuse the fit
    return launches, dict(maker=("powerlaw_corpus", (n, d, nq, 0)), pq=pq, index=index, gt=gt)


# ---------------------------------------------------------------- phase 5
def phase_gate(torch, dev, n=100_000, d=1536, nq=1024):
    from vq_tpu_torch import KMeansConfig, PQConfig, SearchConfig
    from vq_tpu_torch.index.flat import FlatQuantizedIndex
    from vq_tpu_torch.kernels.adc import exact_topk
    from vq_tpu_torch.methods.pq import PQ

    k = 10
    x, q = planted_corpus(torch, n, d, nq, seed=0, dev=dev)
    _, gt = exact_topk(q, x, k)
    pq = PQ(PQConfig(num_subquantizers=192, num_bits=8, kmeans=KMeansConfig(iters=10)),
            seed=1, device=dev)
    index, t_fit = wall_s(torch, lambda: FlatQuantizedIndex(pq, SearchConfig()).fit(x))
    ids, _ = index.search_with_scores(q, k)
    r = recall(gt.cpu(), ids, k)
    log(f"[phase 5] PQ M=192 B=8 planted corpus: fit+encode {t_fit:.3f} s, "
        f"recall@10 {r:.4f} (floor {RECALL_GATE_PQ192_FLOOR})")
    require(r >= RECALL_GATE_PQ192_FLOOR, f"recall gate {r} < {RECALL_GATE_PQ192_FLOOR}")


# ---------------------------------------------------------------- phase 6
def packed_corpus(torch, n, d, nq, seed, dev, lognormal=False):
    """bench.py:254-275 (and :316-341 with `lognormal`): rows N(0, diag σ²),
    σ_i = (1+i)^-0.6, optionally times a lognormal row scale exp(0.5·N(0,1));
    queries are corpus rows jittered by 0.1σ.  Returns (x, q, σ)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    sigma = (1.0 + torch.arange(d, device=dev, dtype=torch.float32)) ** -0.6
    x = torch.randn((n, d), generator=g, device=dev).mul_(sigma)
    if lognormal:
        x.mul_(torch.exp(0.5 * torch.randn((n, 1), generator=g, device=dev)))
    qidx = torch.randint(0, n, (nq,), generator=g, device=dev)
    q = x[qidx] + 0.1 * sigma * torch.randn((nq, d), generator=g, device=dev)
    return x, q, sigma


def packed_tol(torch, a):
    """(Q, 1) f32 tolerance of a packed scan (``a``: packed_scan_topk's
    arguments): F32_RTOL times a bound on the magnitude of the score's terms,
    c·‖q‖·max‖x̂‖ + |qa| (+ max |L2 shift|; over the least row norm for NIP),
    x̂ a row's scaled values.  Kernel and plain sum the same products in
    another order (see F32_RTOL)."""
    from vq_tpu_torch.kernels import packed_scan as pk

    fac = a["factors"]
    n = fac.shape[1]
    r2 = torch.zeros((n,), device=fac.device)
    li = 0
    for w, seg in zip(a["words"], a["segs"]):
        lv = None
        if seg.dequant in ("perdim", "shared"):
            lv, li = a["lv_tables"][li], li + 1
        for r0 in range(0, n, 16384):
            r1 = min(n, r0 + 16384)
            rows = w[r0:r1] if seg.dequant == "values" else w[r0 // seg.u:r1 // seg.u]
            scale = fac[seg.scale_col, r0:r1] if seg.scale_col >= 0 else None
            r2[r0:r1] += torch.sum(pk.dequant_seg(rows, seg, lv, scale) ** 2, dim=1)
    qx = torch.linalg.norm(a["q_cat"], dim=1, keepdim=True) * torch.sqrt(r2.max())
    qa = a["qa"].abs()[:, None]
    if a["metric_kind"] == "l2":
        shift = sum(fac[c] for c in a["r2_cols"]).abs().max()
        return F32_RTOL * (2.0 * qx + qa + shift)
    tol = F32_RTOL * (qx + qa)
    if a["metric_kind"] == "nip":
        tol = tol / torch.clamp(fac[a["norm_col"]], min=1e-30).min()
    return tol


def packed_configs(torch, x, q, norms, tile_cache=False):
    """(tag, args(metric, k, use_bf16, prune, limit) → packed_scan_topk
    arguments for the queries q, dequant kinds, quantizer, packed corpus)
    for the five configurations of phases 6 and 9 (SAQ uniform and lloyd,
    RaBitQ B=2 and 6, RankAware lloyd: one segment per bit width, no per-row
    scale); SAQ's cache is norm-ordered, or order-preserving with
    ``tile_cache`` (the IVF one); the others keep the rows' order."""
    from vq_tpu_torch import RaBitQConfig, RankAwareConfig, SAQConfig
    from vq_tpu_torch.methods import rabitq as rb
    from vq_tpu_torch.methods import rankaware as ra
    from vq_tpu_torch.methods import saq as sq

    out = []
    for tag, cfg in (("SAQ uniform bpd=2", SAQConfig(bits_per_dim=2.0)),
                     ("SAQ lloyd bpd=2", SAQConfig(bits_per_dim=2.0, codebook="lloyd"))):
        m = sq.SAQ(cfg).fit(x)
        packed = sq.prepare_packed(m.plan, m.params, m.compress(x), norms=norms,
                                   sort_rows=not tile_cache)

        def args(metric, k, bf16, prune, limit=None, m=m, packed=packed):
            return sq.packed_scan_args(m.plan, m.params, q, packed, k, metric,
                                       num_valid=limit, use_bf16=bf16, prune=prune)
        kinds = {s.dequant for s in sq.packed_segspecs(m.plan, m.params)[0]}
        out.append((f"{tag} bits={m.plan.seg_bits}", args, kinds, m, packed))
    for bits in (2, 6):
        m = rb.RaBitQ(RaBitQConfig(num_bits=bits)).fit(x)
        packed = rb.prepare_packed(m.params, m.compress(x), bits, norms=norms)

        def args(metric, k, bf16, prune, limit=None, m=m, packed=packed, bits=bits):
            return rb.packed_scan_args(m.params, q, packed, k, metric, bits,
                                       num_valid=limit, use_bf16=bf16, prune=prune)
        out.append((f"RaBitQ B={bits}", args, {rb._packed_segspec(1, bits).dequant}, m,
                    packed))
    m = ra.RankAware(RankAwareConfig(bits_per_dim=2.0, codebook="lloyd")).fit(x)
    packed = ra.prepare_packed(m.params, m.bits, m.layout, m.compress(x), "dense", norms=norms)

    def args(metric, k, bf16, prune, limit=None, m=m, packed=packed):
        return ra.packed_scan_args(m.params, m.bits, q, packed, k, metric, num_valid=limit,
                                   use_bf16=bf16, prune=prune)
    segs = ra.packed_segspecs(m.params, m.bits)[0]
    out.append((f"RankAware lloyd bpd=2 {rankaware_segments(segs)}", args,
                {s.dequant for s in segs}, m, packed))
    return out


def rankaware_segments(segs) -> str:
    """A RankAware layout's segments as (bits, length, kind) runs."""
    return "segments " + " ".join(f"({s.bits},{s.ln},{s.dequant})" for s in segs)


def time_packed(torch, a, what):
    """The packed call ``a`` timed in bf16 (tensor cores) and f32 (FFMA):
    kernel and plain CUDA-event ms (median of 5), each beside its bound.
    Returns the bf16 (kernel ms, plain ms, bound) and a line for the log."""
    from vq_tpu_torch.kernels import packed_scan as pk

    parts, out = [], None
    for bf16 in (True, False):
        ab = {**a, "use_bf16": bf16}
        tk = cuda_ms(torch, lambda: pk.packed_scan_topk(**ab))
        tp = cuda_ms(torch, lambda: pk.packed_scan_topk_plain(**ab))
        bnd = packed_bound(torch, ab)
        parts.append(f"{'bf16 (tensor cores)' if bf16 else 'f32 (FFMA)'} kernel {tk:.3f} ms, "
                     f"plain {tp:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        out = out or (tk, tp, bnd)
    return out, f"{what}: " + "; ".join(parts)


def synthetic_packed(torch, dev, n, nq, seed):
    """``packed_scan_topk`` arguments over hand-made segments whose lengths
    are not multiples of 16 -- uniform 2-bit (ln 40), perdim 3-bit (21),
    shared 4-bit (9), an f32 value plane (7) -- with seeded codes, level
    tables, row scales, L2 shifts and norms; n rows (padded to 512), nq
    queries, L2, k=10, bf16."""
    from vq_tpu_torch.kernels import packed_scan as pk

    g = torch.Generator(device=dev).manual_seed(seed)
    n_pad = -(-n // 512) * 512
    segs = (pk.make_segspec(2, 40, "uniform", 0), pk.make_segspec(3, 21, "perdim", 1),
            pk.make_segspec(4, 9, "shared", 2), pk.make_segspec(6, 7, "values", 3))
    words, lv = [], []
    for sp in segs:
        if sp.dequant == "values":
            words.append(torch.randn((n_pad, sp.ln), generator=g, device=dev))
            continue
        idx = torch.randint(0, 1 << sp.bits, (n_pad, sp.ln), generator=g, device=dev)
        words.append(pk.pack_words(idx, sp.bits, sp.beff))
        if sp.dequant != "uniform":
            rows = sp.ln if sp.dequant == "perdim" else 1
            lv.append(torch.randn((rows, 1 << sp.bits), generator=g, device=dev))
    d = sum(sp.ln for sp in segs)
    fac = torch.rand((6, n_pad), generator=g, device=dev) + 0.5  # 4 scales, L2 shift, norm
    return dict(q_cat=torch.randn((nq, d), generator=g, device=dev),
                qa=torch.randn((nq,), generator=g, device=dev), words=tuple(words),
                factors=fac, lv_tables=tuple(lv), segs=segs, k=10, family="seg",
                metric_kind="l2", norm_col=5, r2_cols=(4,), limit=n, use_bf16=True,
                prune=False, tile_stats=None, qprune=None)


def sass_hmma(lib_path) -> dict:
    """HMMA (tensor-core) instructions in the scan kernels of the built
    library, from ``cuobjdump -sass``: {"bf16": n, "f32": n} of the packed
    kernel's two instances, "pq decode score_all" / "pq decode fused" of the
    PQ decode route's."""
    from vq_tpu_torch.kernels._build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for sec in sass.split("Function : ")[1:]:
        name = sec.split("\n", 1)[0]
        if "packed_scan_kernel" in name:
            out["bf16" if "packed_scan_kernelILb1" in name else "f32"] = sec.count("HMMA")
        elif "decode_scan_kernel" in name:
            out["pq decode " + ("score_all" if "decode_scan_kernelILb1" in name
                                else "fused")] = sec.count("HMMA")
    return out


def phase_packed_edges(torch, dev, q, m, packed, codes):
    """SAQ uniform: limit < k, limit masking, N < 512, k = 1 and 128, planted
    ties; f32 ids must equal the plain version's where separated.  Then bf16
    (tensor cores) on the shapes the MMA path finds hard -- Q = 1, 7 and 65
    (not multiples of its 8-query tiles or 64-query blocks), k = 1 and 128,
    N < 512, and segments whose lengths are not multiples of its 16-dim
    k-steps -- against the plain bf16 version: ids below the limit and a
    pooled recall ≥ BF16_MIN_RECALL."""
    from vq_tpu_torch import Metric
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.methods import saq as sq

    n = packed.num_rows
    for k, limit in ((10, 5), (10, n - 777), (1, None), (128, None)):
        a = sq.packed_scan_args(m.plan, m.params, q, packed, k, Metric.L2, num_valid=limit,
                                use_bf16=False)
        ks, ki = pk.packed_scan_topk(**a)
        lim = limit or n
        require(bool((ki < lim).all()), f"packed edge k={k}: ids past limit")
        if lim < k:
            require(bool((ks[:, lim:] == -np.inf).all() and (ki[:, lim:] == 0).all()),
                    "packed limit < k must leave -inf / id 0")
            continue
        rs, ri = pk.packed_scan_topk_plain(**{**a, "k": k + 1})
        check_topk_f32(torch, ks, ki, rs, ri, k, packed_tol(torch, a),
                       f"packed edge k={k} limit={limit}")
    small = sq.prepare_packed(m.plan, m.params, codes[:300])  # one tile, 212 pad rows
    a = sq.packed_scan_args(m.plan, m.params, q, small, 10, Metric.IP, use_bf16=False)
    ks, ki = pk.packed_scan_topk(**a)
    rs, ri = pk.packed_scan_topk_plain(**{**a, "k": 11})
    check_topk_f32(torch, ks, ki, rs, ri, 10, packed_tol(torch, a), "packed edge N=300")
    same = sq.prepare_packed(m.plan, m.params, codes[:1].repeat(3000, 1))
    for k in (6, 100):  # every row identical → ids 0..k-1 in order
        a = sq.packed_scan_args(m.plan, m.params, q, same, k, Metric.L2, use_bf16=False)
        require(bool((pk.packed_scan_topk(**a)[1] == torch.arange(k, device=dev)).all()),
                "packed tie order")
    syn = synthetic_packed(torch, dev, 1000, 65, seed=9)  # two tiles, the last partial
    for kind, limit in (("l2", 1000), ("ip", 1000 - 77), ("nip", 1000)):
        a = {**syn, "metric_kind": kind, "limit": limit, "use_bf16": False}
        ks, ki = pk.packed_scan_topk(**a)
        require(bool((ki < limit).all()), f"packed edge segments {kind}: ids past limit")
        rs, ri = pk.packed_scan_topk_plain(**{**a, "k": 11})
        check_topk_f32(torch, ks, ki, rs, ri, 10, packed_tol(torch, a),
                       f"packed edge segments ln (40, 21, 9, 7) {kind} limit={limit}")
    hits = total = 0
    cases = []
    for what, a in ([(f"SAQ Q={nq} k={k}", sq.packed_scan_args(m.plan, m.params, q[:nq], packed,
                                                                k, Metric.L2))
                     for nq in (1, 7, 65) for k in (1, 128)] +
                    [("SAQ N=300 Q=65 IP", sq.packed_scan_args(m.plan, m.params, q[:65], small,
                                                               10, Metric.IP))] +
                    [(f"segments Q={nq} k={k} {kind}",
                      {**syn, "q_cat": syn["q_cat"][:nq], "qa": syn["qa"][:nq], "k": k,
                       "metric_kind": kind, "limit": 1000 - 77 if kind == "ip" else 1000})
                     for nq in (1, 7, 65) for k in (1, 10, 128) for kind in ("l2", "ip")]):
        ki = pk.packed_scan_topk(**a)[1].cpu()
        pi = pk.packed_scan_topk_plain(**a)[1].cpu()
        kk = min(a["k"], a["limit"])
        require(bool((ki < a["limit"]).all()), f"packed bf16 edge {what}: ids past limit")
        h = sum(len(set(x[:kk]) & set(y[:kk])) for x, y in zip(ki.tolist(), pi.tolist()))
        hits, total = hits + h, total + kk * ki.shape[0]
        cases.append(f"{what} {h / (kk * ki.shape[0]):.3f}")
    log("[phase 6] bf16 edge cases, recall@k vs plain bf16: " + ", ".join(cases))
    require(hits / total >= BF16_MIN_RECALL,
            f"packed bf16 edge cases: pooled recall {hits / total} < {BF16_MIN_RECALL}")


def phase_packed_kernels(torch, dev, results, n=100_000, d=1024, nq=256):
    """The packed kernel against its plain version on the card: SAQ uniform
    and lloyd (perdim + values), RaBitQ B=2 (shared) and B=6 (values), each
    in L2 / IP / NIP at k=10 and 100 with prune off and on; edge cases."""
    from vq_tpu_torch import Metric
    from vq_tpu_torch.kernels import packed_scan as pk

    t0 = time.perf_counter()
    pk.reset_launch_counts()
    x, q, _ = packed_corpus(torch, n, d, nq, seed=11, dev=dev, lognormal=True)
    norms = torch.linalg.norm(x, dim=1)
    configs = packed_configs(torch, x, q, norms)
    log(f"[phase 6] corpus N={n} (lognormal rows) D={d} Q={nq}; {len(configs)} configurations "
        f"fitted, encoded and packed in {time.perf_counter() - t0:.3f} s")
    kind_launches = {"uniform": 0, "perdim": 0, "shared": 0, "values": 0}
    r = results.setdefault("packed_scan_topk", {"max_abs_err": 0.0, "times": {}, "bounds": {}})
    for tag, args, kinds, m, packed in configs:
        before = pk.packed_scan_topk.launches
        worst, n_sep, fracs, worst_rec = 0.0, 0, [], (1.0, 1.0, 1.0)
        for metric in (Metric.L2, Metric.IP, Metric.NIP):
            for k in (10, 100):
                what = f"{tag} {metric.name} k={k}"
                a = args(metric, k, False, False)
                ks, ki = pk.packed_scan_topk(**a)
                rs, ri = pk.packed_scan_topk_plain(**{**a, "k": k + 1})
                err, sep, _ = check_topk_f32(torch, ks, ki, rs, ri, k, packed_tol(torch, a),
                                             f"packed f32 {what}")
                worst, n_sep = max(worst, err), n_sep + sep
                ps_, pi, cnt = pk.packed_scan_topk(**args(metric, k, False, True))
                require(torch.equal(pi, ki) and torch.equal(ps_, ks),
                        f"packed f32 prune {what}: differs from prune off")
                fracs.append(int(cnt) / pk.prune_units(nq, packed.factors.shape[1], dev))
                ab = args(metric, k, True, False)
                _, bi = pk.packed_scan_topk(**ab)
                _, pbi = pk.packed_scan_topk_plain(**ab)
                rec = recall(ri[:, :k].cpu(), bi.cpu(), k)
                rec_plain = recall(ri[:, :k].cpu(), pbi.cpu(), k)
                rec_like = recall(pbi.cpu(), bi.cpu(), k)
                worst_rec = min(worst_rec, (rec, rec_plain, rec_like))
                # bf16 rounding alone (the plain version) may lose more than
                # 1% of the f32 top-k; the kernel must not lose more than it
                require(rec_like >= BF16_MIN_RECALL and
                        (rec >= BF16_MIN_RECALL or rec >= rec_plain - 0.005),
                        f"packed bf16 {what}: recall vs plain f32 {rec} (plain bf16 "
                        f"{rec_plain}), vs plain bf16 {rec_like}")
                _, bpi, _ = pk.packed_scan_topk(**args(metric, k, True, True))
                require(torch.equal(bpi, bi), f"packed bf16 prune {what}: differs from off")
        for kind in kinds:
            kind_launches[kind] += pk.packed_scan_topk.launches - before
        require_launched({tag: pk.packed_scan_topk.launches - before}, "a configuration never "
                                                                        "launched the kernel")
        if tag.startswith("RankAware"):  # no per-row scale: scale_col −1 in every segment
            require(all(sp.scale_col == -1 for sp in args(Metric.L2, 10, True, False)["segs"]),
                    f"{tag}: a segment carries a scale column")
        (tk, tp, bnd), line = time_packed(torch, args(Metric.L2, 10, True, False), "L2 k=10")
        a = args(Metric.L2, 100, True, False)
        t100, b100 = cuda_ms(torch, lambda: pk.packed_scan_topk(**a)), packed_bound(torch, a)
        r["max_abs_err"] = max(r["max_abs_err"], worst)
        r["times"][tag] = (tk, tp)
        r["bounds"][tag] = bnd
        log(f"[phase 6] {tag} kinds {sorted(kinds)}: f32 max_abs_err={worst:.3e}, ids = plain "
            f"at {n_sep} separated (query, metric, k); prune ids = dense; lowest bf16 recall@k "
            f"vs plain f32 {worst_rec[0]:.4f} (plain bf16 vs f32 {worst_rec[1]:.4f}, kernel vs "
            f"plain bf16 {worst_rec[2]:.4f}); scanned fraction with prune "
            f"{min(fracs):.3f}-{max(fracs):.3f}")
        log(f"[phase 6] {tag} times (CUDA events, median of 5): {line}; L2 k=100 bf16 kernel "
            f"{t100:.3f} ms, bound {b100[0]:.4f} ms ({b100[1]})")
    require_launched(kind_launches, "a dequant kind was never launched")
    rankaware_ffd(torch, dev, x, q, norms, *configs[-1][3:])
    tag, args, kinds, m, packed = configs[0]
    phase_packed_edges(torch, dev, q, m, packed, m.compress(x[:3000]))
    torch.cuda.synchronize()
    log(f"[phase 6] packed kernel checks and edge cases ok ({time.perf_counter() - t0:.3f} s)")
    del x, q, norms, configs
    torch.cuda.empty_cache()


def rankaware_ffd(torch, dev, x, q, norms, m, packed):
    """RankAware with FFD (byte-aligned) packing of the same codes: its scan
    layout equals the dense one's (both unpack to the same indices), and
    the kernel holds its plain version (f32, L2, k=10)."""
    from vq_tpu_torch import Metric
    from vq_tpu_torch.core.ffd import ffd_layout
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.methods import rankaware as ra

    mf = ra.RankAware(dataclasses.replace(m.cfg, packing="ffd"), device=dev)
    mf.params, mf.bits, mf.layout, mf._dim = m.params, m.bits, ffd_layout(m.bits), m._dim
    codes = mf.compress(x)
    pf = ra.prepare_packed(mf.params, mf.bits, mf.layout, codes, "ffd", norms=norms)
    require(all(torch.equal(a, b) for a, b in zip(pf.words, packed.words)),
            "RankAware FFD: scan layout differs from the dense packing's")
    a = ra.packed_scan_args(mf.params, mf.bits, q, pf, 10, Metric.L2, use_bf16=False)
    ks, ki = pk.packed_scan_topk(**a)
    rs, ri = pk.packed_scan_topk_plain(**{**a, "k": 11})
    err, n_sep, _ = check_topk_f32(torch, ks, ki, rs, ri, 10, packed_tol(torch, a),
                                   "RankAware FFD f32 L2 k=10")
    log(f"[phase 6] RankAware FFD packing: {codes.shape[1]} code bytes/row (dense "
        f"{m.code_bytes_per_vector():.0f}); scan layout = dense's; kernel vs plain f32 L2 k=10 "
        f"max_abs_err={err:.3e}, ids = plain at {n_sep} separated queries")


# ---------------------------------------------------------------- phase 7
def timed(torch, index, q, k, what):
    """Warm-up, then the median of 3 host-clock searches → ((ids, scores),
    ms a search); checks the result's shape, values and order."""
    index.search_with_scores(q, k)
    runs = [wall_s(torch, lambda: index.search_with_scores(q, k)) for _ in range(3)]
    ids, scores = runs[-1][0]
    require(ids.shape == (q.shape[0], k) and scores.shape == (q.shape[0], k),
            f"{what} k={k} result shape")
    require(bool(np.isfinite(scores).all()) and int(ids.max()) < index.num_rows,
            f"{what} k={k} result values")
    require(bool((np.diff(scores, axis=1) >= 0).all()), f"{what} k={k} not ascending")
    return (ids, scores), float(np.median([r[1] for r in runs])) * 1e3


def timed_search(torch, index, q, k, gt, what):
    """``timed``, logged with recall against the ground truth; returns the
    ids."""
    (ids, _), ms = timed(torch, index, q, k, what)
    recalls = ", ".join(f"recall@{r} {recall(gt, ids, r):.4f}" for r in sorted({10, k}))
    log(f"[{what}] search k={k}: {ms:.3f} ms/batch (median of 3, host clock), "
        f"QPS {q.shape[0] / ms * 1e3:.1f}, {recalls}")
    return ids


def phase_saq_main(torch, dev, n=1_048_576, d=1024, nq=256, profile=True):
    """bench.py:248-380 on the port: FlatQuantizedIndex(SAQ bpd=2, PCA) on
    the power-law corpus at the Cohere MS MARCO width, then the banded
    prune corpus."""
    from vq_tpu_torch import Metric, SAQConfig, SearchConfig
    from vq_tpu_torch.index.flat import FlatQuantizedIndex
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.kernels.adc import exact_topk
    from vq_tpu_torch.methods import saq as sq

    (x, q, sigma), t_gen = wall_s(torch, lambda: packed_corpus(torch, n, d, nq, 0, dev))
    log(f"[phase 7] corpus N={n} D={d} Q={nq} on {dev}: {t_gen:.3f} s "
        f"({x.numel() * 4 / 1e9:.2f} GB)")
    pk.reset_launch_counts()
    saq = sq.SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True))  # no device: the corpus's
    _, t_fit = wall_s(torch, lambda: saq.fit(x))
    require(saq.device == x.device, f"quantizer on {saq.device}, corpus on {x.device}")
    index = FlatQuantizedIndex(saq, SearchConfig(use_bf16=True))
    _, t_index = wall_s(torch, lambda: index.fit(x))
    require(index.codes.device == x.device and index._scan_cache.factors.device == x.device,
            "index state left the corpus's device")
    _, t_enc = wall_s(torch, lambda: saq.compress(x))
    _, t_pack = wall_s(torch, lambda: saq.prepare_scan(index.codes, norms=index.norms))
    (_, gt_i), t_gt = wall_s(torch, lambda: exact_topk(q, x, 100))
    gt = gt_i.cpu().numpy()
    cache = index._scan_cache
    log(f"[phase 7] SAQ plan bits {saq.plan.seg_bits} lens {saq.plan.seg_lens}, "
        f"{saq.plan.code_bytes} code bytes/row; fit {t_fit:.3f} s; index fit (encode + norms + "
        f"norm-ordered pack) {t_index:.3f} s; encode alone {t_enc:.3f} s ({n / t_enc:.0f} "
        f"rows/s); pack alone {t_pack:.3f} s; ground truth k=100 {t_gt:.3f} s; prune hint "
        f"{cache.prune_hint}")
    out = {k: timed_search(torch, index, q, k, gt, "phase 7") for k in (10, 100)}
    launches = pk.packed_scan_topk.launches
    log(f"[phase 7] packed_scan_topk launches during the SAQ path: {launches}")
    require_launched({"packed_scan_topk": launches}, "the SAQ path never launched")
    require(bool((out[10] == out[100][:, :10]).all()), "k=10 and k=100 searches disagree")
    _, _, cnt = sq._packed_scan(saq.plan, saq.params, q, cache, 10, Metric.L2, prune=True)
    units = pk.prune_units(nq, cache.factors.shape[1], dev)
    log(f"[phase 7] prune stage on this corpus: {int(cnt)}/{units} (query block, tile) pairs "
        f"scanned = {int(cnt) / units:.4f}")
    # reference on a query subset: the plain version on the same cache
    a = sq.packed_scan_args(saq.plan, saq.params, q[:64], cache, 10, Metric.L2)
    _, ri = pk.packed_scan_topk_plain(**a)
    rec = recall(cache.perm[ri.long()].cpu(), out[10][:64], 10)
    log(f"[phase 7] kernel vs plain (64 queries, bf16) recall@10 = {rec:.4f}")
    require(rec >= BF16_MIN_RECALL, "SAQ path disagrees with its plain reference")
    if profile:
        profile_search(torch, index, q, ks=(10,), tag=" SAQ")
    gather_table(torch, dev, saq, index.codes, index.norms, q)
    # phases 13 and 16 remake the corpus from its seed and reuse the fit
    ctx = dict(maker=("packed_corpus", (n, d, nq, 0)), saq=saq, index=index, gt=gt)
    del x, q, cache, gt_i
    torch.cuda.empty_cache()

    # banded prune corpus (bench.py:316-368): lognormal row scale, norm-
    # ordered packing, queries from the lowest-norm band
    x, _, sigma = packed_corpus(torch, n, d, nq, seed=1, dev=dev, lognormal=True)
    codes = saq.compress(x)
    cache = sq.prepare_packed(saq.plan, saq.params, codes, sort_rows=True)
    g = torch.Generator(device=dev).manual_seed(5)
    band = torch.argsort(torch.linalg.norm(x[:131072], dim=1))[:nq]
    qb = x[band] + 0.05 * sigma * torch.randn((nq, d), generator=g, device=dev)
    del x
    pk.reset_launch_counts()
    res, times = {}, {}
    for prune in (True, False, True, False):
        def run():
            return sq.scan_topk(saq.plan, saq.params, qb, codes, 10, Metric.L2,
                                packed_cache=cache, prune_tiles=prune)
        (res[prune]), t = wall_s(torch, run)
        times.setdefault(prune, []).append(t)
    banded = pk.packed_scan_topk.launches
    require_launched({"packed_scan_topk": banded}, "the banded path never launched")
    require(torch.equal(res[True][1], res[False][1]), "banded: prune ids differ from dense")
    _, _, cnt = sq._packed_scan(saq.plan, saq.params, qb, cache, 10, Metric.L2, prune=True)
    units = pk.prune_units(nq, cache.factors.shape[1], dev)
    frac = int(cnt) / units
    log(f"[phase 7] banded corpus k=10 (host clock, second of two runs): prune "
        f"{times[True][1] * 1e3:.3f} ms, dense {times[False][1] * 1e3:.3f} ms; ids identical; "
        f"{int(cnt)}/{units} (query block, tile) pairs scanned = {frac:.4f}; prune hint "
        f"{cache.prune_hint}")
    require(frac < 1.0, "the prune stage never fired on the banded corpus")
    del codes, cache, qb
    torch.cuda.empty_cache()
    return launches + banded, ctx


def phase_rabitq_main(torch, dev, n=1_048_576, d=1024, nq=256):
    """bench.py:385-438 on the port: FlatQuantizedIndex(RaBitQ B=2), k=10."""
    from vq_tpu_torch import RaBitQConfig, SearchConfig
    from vq_tpu_torch.index.flat import FlatQuantizedIndex
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.kernels.adc import exact_topk
    from vq_tpu_torch.methods.rabitq import RaBitQ

    x, q, _ = packed_corpus(torch, n, d, nq, seed=2, dev=dev)
    pk.reset_launch_counts()
    rbq = RaBitQ(RaBitQConfig(num_bits=2))
    _, t_fit = wall_s(torch, lambda: rbq.fit(x))
    index = FlatQuantizedIndex(rbq, SearchConfig(use_bf16=True))
    _, t_index = wall_s(torch, lambda: index.fit(x))
    (_, gt_i), t_gt = wall_s(torch, lambda: exact_topk(q, x, 10))
    log(f"[phase 8] RaBitQ B=2 N={n} D={d}: fit {t_fit:.3f} s; index fit (encode + pack) "
        f"{t_index:.3f} s; ground truth {t_gt:.3f} s")
    timed_search(torch, index, q, 10, gt_i.cpu().numpy(), "phase 8")
    launches = pk.packed_scan_topk.launches
    require_launched({"packed_scan_topk": launches}, "the RaBitQ path never launched")
    del x, q, index
    torch.cuda.empty_cache()
    return launches

# ---------------------------------------------------------------- phase 9
def run_mask(torch, nb, frac, seed, run=8):
    """(nb,) i32 mask with max(1, round(frac·nb)) tiles in contiguous runs
    of up to `run` tiles at seeded positions (what cluster-sorted rows give)."""
    g = torch.Generator().manual_seed(seed)
    want = max(1, round(frac * nb))
    m = torch.zeros((nb,), dtype=torch.int32)
    while int(m.sum()) < want:
        start = int(torch.randint(0, nb, (1,), generator=g))
        m[start:start + min(run, want - int(m.sum()))] = 1
    return m


def gather_masks(torch, nb, dev, seed=0):
    """Phase 9's tile masks over nb tiles."""
    g = torch.Generator().manual_seed(seed)
    rand = (torch.rand((nb,), generator=g) < 0.25).to(torch.int32)
    rand[nb // 2] = 1
    one, last = torch.zeros((nb,), dtype=torch.int32), torch.zeros((nb,), dtype=torch.int32)
    one[nb // 3] = 1
    last[-1] = 1
    masks = {"all": torch.ones((nb,), dtype=torch.int32), "25% random": rand,
             "5% runs": run_mask(torch, nb, 0.05, seed + 1), "one tile": one,
             "last partial tile": last, "none": torch.zeros((nb,), dtype=torch.int32)}
    return {name: m.to(dev) for name, m in masks.items()}


def check_gather(torch, args, mask, k, what):
    """One f32 gather scan held against its plain version; returns the
    kernel's (scores, ids) and the largest score error.  Ids lie in
    masked-in tiles below the limit; no tile gives -inf with id 0."""
    from vq_tpu_torch.kernels import packed_scan as pk

    a = {**args, "tile_mask": mask}
    ks, ki = pk.packed_scan_topk(**a)
    cnt = int(mask.sum())
    if cnt == 0:
        require(bool((ks == -np.inf).all() and (ki == 0).all()), f"{what}: empty mask")
        return ks, ki, 0.0
    require(bool((mask[ki.long() // 512] != 0).all() and (ki < a["limit"]).all()),
            f"{what}: ids outside the masked-in rows")
    rs, ri = pk.packed_scan_topk_plain(**{**a, "k": k + 1})
    err, _, _ = check_topk_f32(torch, ks, ki, rs, ri, k, packed_tol(torch, a), what)
    return ks, ki, err


def phase_gather_kernels(torch, dev, results, n=100_000, d=1024, nq=256):
    """The gather mode against its plain version (see the module docstring)."""
    from vq_tpu_torch import Metric
    from vq_tpu_torch.kernels import packed_scan as pk

    t0 = time.perf_counter()
    pk.reset_launch_counts()
    x, q, _ = packed_corpus(torch, n, d, nq, seed=11, dev=dev, lognormal=True)
    norms = torch.linalg.norm(x, dim=1)
    configs = packed_configs(torch, x, q, norms, tile_cache=True)
    nb = -(-n // 512)
    masks = gather_masks(torch, nb, dev)
    log(f"[phase 9] corpus N={n} ({nb} tiles) D={d} Q={nq}; order-preserving caches; masks "
        + ", ".join(f"{name} {int(m.sum())}" for name, m in masks.items()))
    r = results.setdefault("packed_scan_topk_gather",
                           {"max_abs_err": 0.0, "times": {}, "bounds": {}})
    for tag, args, _, _, packed in configs:
        require(packed.perm is None, f"{tag}: the cache must keep the rows' order")
        worst, worst_rec, max_frac = 0.0, 1.0, 0.0
        for mname, mask in masks.items():
            cnt = int(mask.sum())
            for metric in (Metric.L2, Metric.IP, Metric.NIP):
                for k in (10, 100):
                    what = f"gather {tag} {mname} {metric.name} k={k}"
                    ks, ki, err = check_gather(torch, args(metric, k, False, False), mask, k,
                                               what)
                    worst = max(worst, err)
                    if mname == "all":
                        ds, di = pk.packed_scan_topk(**args(metric, k, False, False))
                        require(torch.equal(ds, ks) and torch.equal(di, ki),
                                f"{what}: differs from the dense kernel")
                    ps_, pi, pc = pk.packed_scan_topk(**{**args(metric, k, False, True),
                                                        "tile_mask": mask})
                    require(torch.equal(pi, ki) and torch.equal(ps_, ks),
                            f"{what} prune: differs from prune off")
                    units = pk.prune_units(nq, packed.factors.shape[1], dev, tiles=cnt)
                    require(int(pc) <= units, f"{what} prune: {int(pc)} > {units} pairs")
                    max_frac = max(max_frac, int(pc) / max(units, 1))
            a = {**args(Metric.L2, 10, False, False), "tile_mask": mask}
            base = pk.packed_scan_topk(**a)
            for cap in (cnt, nb, max(1, cnt // 2)):  # at, above and below the count
                capped = pk.packed_scan_topk(**{**a, "mask_cap": cap})
                require(torch.equal(capped[0], base[0]) and torch.equal(capped[1], base[1]),
                        f"gather {tag} {mname}: mask_cap={cap} changed the result")
            if cnt:
                ab = {**args(Metric.L2, 10, True, False), "tile_mask": mask}
                rec = recall(pk.packed_scan_topk_plain(**ab)[1].cpu(),
                             pk.packed_scan_topk(**ab)[1].cpu(), 10)
                worst_rec = min(worst_rec, rec)
                require(rec >= BF16_MIN_RECALL, f"gather bf16 {tag} {mname}: recall {rec}")
        r["max_abs_err"] = max(r["max_abs_err"], worst)
        line = (f"[phase 9] {tag}: f32 max_abs_err={worst:.3e}; every tile = dense bit for "
                f"bit; no tile -inf/id 0; prune ids = unpruned, largest scanned fraction of "
                f"masked-in pairs {max_frac:.3f}; mask_cap never changes the result; lowest "
                f"bf16 recall@10 vs plain bf16 {worst_rec:.4f}")
        log(line)
        # times on the first configuration (the kernels line's) and on
        # RankAware's, L2 k=10
        if not r["times"] or tag.startswith("RankAware"):
            key = "RankAware " if r["times"] else ""
            for mname in ("25% random", "all"):
                (tk, tp, bnd), line = time_packed(
                    torch, {**args(Metric.L2, 10, True, False), "tile_mask": masks[mname]},
                    f"{mname} mask, gather")
                log(f"[phase 9] {tag} times (CUDA events, median of 5): {line}")
                r["times"][key + mname], r["bounds"][key + mname] = (tk, tp), bnd
            a = args(Metric.L2, 10, True, False)
            log(f"[phase 9] {tag} dense kernel (CUDA events, median of 5): bf16 "
                f"{cuda_ms(torch, lambda: pk.packed_scan_topk(**a)):.3f} ms, f32 "
                f"{cuda_ms(torch, lambda: pk.packed_scan_topk(**{**a, 'use_bf16': False})):.3f} "
                f"ms")
    require_launched({"gather": pk.packed_scan_topk.gather_launches},
                     "the gather checks never launched the gather kernel")
    torch.cuda.synchronize()
    log(f"[phase 9] gather kernel checks ok ({time.perf_counter() - t0:.3f} s)")
    del x, q, norms, configs
    torch.cuda.empty_cache()


def gather_table(torch, dev, saq, codes, norms, q, k=100):
    """Phase 9's time table on phase 7's SAQ codes: the dense kernel against
    the gather mode at 100/25/5/1% of tiles (contiguous runs), bf16, k=100,
    on an order-preserving cache; dense timed first and last."""
    from vq_tpu_torch import Metric
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.methods import saq as sq

    cache = saq.prepare_tile_cache(codes, norms=norms)
    nb = cache.factors.shape[1] // 512
    a = sq.packed_scan_args(saq.plan, saq.params, q, cache, k, Metric.L2, use_bf16=True)
    cells = [("dense", None)] + [(f"gather {f:.0%}", run_mask(torch, nb, f, seed=7).to(dev))
                                 for f in (1.0, 0.25, 0.05, 0.01)] + [("dense again", None)]
    parts = []
    for name, mask in cells:
        am = a if mask is None else {**a, "tile_mask": mask}
        ms = cuda_ms(torch, lambda: pk.packed_scan_topk(**am))
        bnd = packed_bound(torch, am)
        tiles = nb if mask is None else int(mask.sum())
        parts.append(f"{name} ({tiles} tiles) {ms:.3f} ms [bound {bnd[0]:.4f} {bnd[1]}]")
    log(f"[phase 9] N={cache.num_rows} D={q.shape[1]} Q={q.shape[0]} k={k} bf16 (CUDA events, "
        f"median of 5): " + "; ".join(parts))
    del cache


# ---------------------------------------------------------------- phase 10
def fullrank_corpus(torch, n, d, nq, seed, dev, rank=None, csize=100, spread=1.0,
                    block=65536):
    """bench.py:441-475: planted neighbourhoods at full rank, rows
    z·A with z = centre + spread·N(0, I), A (rank, D) with column scale
    (1+i)^-0.5, unit-normalized; made block by block on the card."""
    rank = rank or d
    g = torch.Generator(device=dev).manual_seed(seed)
    kc = n // csize
    a = torch.randn((rank, d), generator=g, device=dev)
    a = a * (1.0 + torch.arange(d, device=dev)) ** -0.5
    cents = torch.randn((kc, rank), generator=g, device=dev)
    x = torch.empty((n, d), device=dev)
    for i0 in range(0, n, block):
        rows = torch.arange(i0, min(n, i0 + block), device=dev)
        xb = (cents[rows % kc] + spread * torch.randn((rows.shape[0], rank), generator=g,
                                                      device=dev)) @ a
        x[i0:i0 + rows.shape[0]] = xb / torch.linalg.norm(xb, dim=1, keepdim=True)
    qdoc = torch.randint(0, kc, (nq,), generator=g, device=dev)
    qv = (cents[qdoc] + spread * torch.randn((nq, rank), generator=g, device=dev)) @ a
    return x, qv / torch.linalg.norm(qv, dim=1, keepdim=True)


def ivf_search(torch, index, q, nprobe, k, gt, what, phase="phase 10"):
    """One search setting: the result, its checks, QPS from
    ``sustained_search_s`` and the masked-in tile fraction."""
    index.ivf_cfg = dataclasses.replace(index.ivf_cfg, nprobe=nprobe)
    ids, scores = index.search_with_scores(q, k)
    tiles = index.last_tiles_scanned
    nq, nb = q.shape[0], -(-index.num_rows // 512)
    require(ids.shape == (nq, k) and scores.shape == (nq, k), f"{what} result shape")
    require(bool(np.isfinite(scores).all()) and int(ids.max()) < index.num_rows,
            f"{what} result values")
    require(bool((np.diff(scores, axis=1) >= 0).all()), f"{what} not ascending")
    sec = index.sustained_search_s(q, k, reps=5, outer=3)
    recalls = ", ".join(f"recall@{r} {recall(gt, ids, r):.4f}" for r in (1, 10, 100))
    log(f"[{phase}] {what}: {sec * 1e3:.3f} ms/search (sustained, CUDA events), QPS "
        f"{nq / sec:.1f}; tiles masked in {tiles}/{nb} = {tiles / nb:.4f}; {recalls}")
    return ids, scores


def phase_ivf_main(torch, dev, n=1_048_576, d=1536, nq=256, k_cl=4096, nprobes=(50, 200),
                   nq_small=8, profile=True):
    """bench.py:478-651 on the port (module docstring); nprobe = k_cl is the
    full probe.  Returns the gather launches and what phase 12 reuses: the
    corpus, queries, ground truth and the coarse pass."""
    from vq_tpu_torch import IVFConfig, KMeansConfig, Metric, RaBitQConfig, SAQConfig
    from vq_tpu_torch import SearchConfig
    from vq_tpu_torch._device import bf16_supported
    from vq_tpu_torch.data.sampling import chunk_rows_for_bytes, host_sample_rows
    from vq_tpu_torch.index.ivf import chunked_assign, coarse_pass
    from vq_tpu_torch.index.ivf_packed import IvfPackedFlatIndex, tile_mask_from_probes
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.kernels.adc import _finalize, exact_topk
    from vq_tpu_torch.kernels.kmeans import pairwise_sqdist_xc
    from vq_tpu_torch.kernels.topk import ordered_topk
    from vq_tpu_torch.methods import saq as sq
    from vq_tpu_torch.methods.rabitq import RaBitQ

    k = 100
    (x, q), t_gen = wall_s(torch, lambda: fullrank_corpus(torch, n, d, nq, seed=11, dev=dev))
    (_, gt_i), t_gt = wall_s(torch, lambda: exact_topk(q, x, k))
    gt = gt_i.cpu().numpy()
    log(f"[phase 10] planted full-rank corpus N={n} D={d} Q={nq} on {dev}: {t_gen:.3f} s "
        f"({x.numel() * 4 / 1e9:.2f} GB); ground truth k={k} {t_gt:.3f} s")
    kmc = KMeansConfig(iters=10, max_points_per_centroid=64)
    ivf_cfg = IVFConfig(k_cl, nprobes[0], kmc)
    cents, t_km = wall_s(torch, lambda: coarse_pass(x, ivf_cfg, dev))
    cents2, t_km2 = wall_s(torch, lambda: coarse_pass(x, ivf_cfg, dev))
    require(torch.equal(cents, cents2), "two coarse passes from one seed gave different "
                                        "centroids")
    log(f"[phase 10] coarse k-means K={k_cl} run twice from seed {kmc.seed}: centroids "
        f"bit-equal; {t_km:.3f} s, {t_km2:.3f} s")
    del cents2
    asn, t_asn = wall_s(torch, lambda: chunked_assign(x, cents, chunk_rows_for_bytes(d)))
    pk.reset_launch_counts()
    saq = sq.SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True))  # no device: the corpus's
    _, t_qfit = wall_s(torch, lambda: saq.fit(host_sample_rows(x, 200_000, kmc.seed)))
    index = IvfPackedFlatIndex(saq, ivf_cfg, SearchConfig(use_bf16=True))
    _, t_fit = wall_s(torch, lambda: index.fit(x, coarse=(cents, asn)))
    require(index.cache.factors.device == x.device and index.cache.perm is None,
            "the IVF cache left the card or lost the rows' order")
    nb = index.cache.factors.shape[1] // 512
    log(f"[phase 10] build: coarse k-means K={k_cl} {t_km:.3f} s; "
        f"assignment {t_asn:.3f} s; SAQ fit {t_qfit:.3f} s (plan bits {saq.plan.seg_bits}, "
        f"{saq.plan.code_bytes} code bytes/row); encode + pack {t_fit:.3f} s; {nb} tiles; "
        f"prune hint {index.cache.prune_hint}")
    full = {}
    for qq, gq, probes in ((q, gt, (k_cl,) + tuple(nprobes)),
                           (q[:nq_small], gt[:nq_small], (k_cl, nprobes[0]))):
        for nprobe in probes:
            ids, scores = ivf_search(torch, index, qq, nprobe, k, gq,
                                     f"SAQ bpd=2 Q={qq.shape[0]} nprobe={nprobe} k={k}")
            if nprobe == k_cl:
                full[qq.shape[0]] = (ids, scores)
            else:
                log(f"[phase 10]   recall@{k} vs nprobe={k_cl}: "
                    f"{recall(full[qq.shape[0]][0], ids, k):.4f}")
    rbq = RaBitQ(RaBitQConfig(num_bits=2))
    rindex = IvfPackedFlatIndex(rbq, IVFConfig(k_cl, nprobes[0], kmc), SearchConfig(use_bf16=True))
    _, t_rfit = wall_s(torch, lambda: rindex.fit(x, coarse=(cents, asn)))
    log(f"[phase 10] RaBitQ B=2 build (fit + encode + pack) {t_rfit:.3f} s")
    ivf_search(torch, rindex, q, nprobes[0], k, gt, f"RaBitQ B=2 Q={nq} nprobe={nprobes[0]} k={k}")
    launches = {"packed_scan_topk_gather": pk.packed_scan_topk.gather_launches}
    log(f"[phase 10] launches during the IVF path: {launches}, dense "
        f"{pk.packed_scan_topk.launches}")
    require_launched(launches, "the IVF path never launched the gather kernel")
    # full probe = the unmasked (dense) kernel over the same cache, bit for bit
    metric = index.search_cfg.metric
    bf16 = bf16_supported(dev)  # the index's rule: bf16 on a card, f32 on the CPU
    for qq in (q, q[:nq_small]):
        s, pos = saq.packed_scan_raw(qq, index.cache, k, metric, use_bf16=bf16)
        ws, wi = _finalize(s, index.ids_sorted[pos.long()], metric, torch.sum(qq * qq, dim=-1))
        ids, scores = full[qq.shape[0]]
        require(np.array_equal(ids, wi.cpu().numpy().astype(np.uint32)) and
                np.array_equal(scores, ws.cpu().numpy()),
                f"Q={qq.shape[0]} nprobe={k_cl} differs from the unmasked kernel")
    # the gather kernel against its plain version at the path's own masks
    for qq in (q, q[:nq_small]):
        _, probe = ordered_topk(-pairwise_sqdist_xc(qq, index.centroids), nprobes[0])
        mask = tile_mask_from_probes(probe, index.cl_first, index.cl_last, k_cl)
        a = sq.packed_scan_args(saq.plan, saq.params, qq, index.cache, k, Metric.L2,
                                use_bf16=False)
        _, _, err = check_gather(torch, a, mask, k,
                                 f"IVF Q={qq.shape[0]} nprobe={nprobes[0]} gather f32")
        ab = {**a, "use_bf16": bf16, "tile_mask": mask}
        rec = recall(pk.packed_scan_topk_plain(**ab)[1].cpu(), pk.packed_scan_topk(**ab)[1].cpu(),
                     k)
        require(rec >= BF16_MIN_RECALL, f"IVF gather bf16 recall {rec}")
        log(f"[phase 10] Q={qq.shape[0]} nprobe={nprobes[0]} mask ({int(mask.sum())} tiles): "
            f"gather vs plain f32 max_abs_err={err:.3e}, bf16 recall@{k} vs plain bf16 "
            f"{rec:.4f}; nprobe={k_cl} = unmasked kernel bit for bit")
    if profile:
        index.ivf_cfg = dataclasses.replace(index.ivf_cfg, nprobe=nprobes[0])
        profile_search(torch, index, q, ks=(k,), tag=" IVF")
        # each stage of one search alone (CUDA events): the routing product,
        # top-nprobe, the mask, its compaction, the scan (compaction, gather
        # kernel and merge launch: one packed_scan_topk call)
        cd = pairwise_sqdist_xc(q, index.centroids)
        probe = ordered_topk(-cd, nprobes[0])[1]
        mask = tile_mask_from_probes(probe, index.cl_first, index.cl_last, k_cl)
        a = {**sq.packed_scan_args(saq.plan, saq.params, q, index.cache, k, Metric.L2),
             "tile_mask": mask}
        stages = {
            "routing product": lambda: pairwise_sqdist_xc(q, index.centroids),
            "top-nprobe": lambda: ordered_topk(-cd, nprobes[0]),
            "mask build": lambda: tile_mask_from_probes(probe, index.cl_first, index.cl_last,
                                                        k_cl),
            "compaction": lambda: pk.compact_tile_mask(mask),
            "query side (rotations)": lambda: sq.packed_scan_args(saq.plan, saq.params, q,
                                                                  index.cache, k, Metric.L2),
            "scan (compaction + gather kernel + merge)": lambda: pk.packed_scan_topk(**a),
        }
        log(f"[profile] IVF stages nprobe={nprobes[0]} Q={nq} (CUDA events, median of 5): "
            + "; ".join(f"{name} {cuda_ms(torch, fn):.3f} ms" for name, fn in stages.items()))
    del rindex
    torch.cuda.empty_cache()
    return launches["packed_scan_topk_gather"], dict(x=x, q=q, gt=gt, cents=cents, asn=asn,
                                                     maker=("fullrank_corpus", (n, d, nq, 11)),
                                                     kmc=kmc, saq=saq, index=index)


# ---------------------------------------------------------------- phase 11
def phase_quantizers(torch, dev, n=1_000_000, d=1536, nq=1024, n_ra=1_048_576, d_ra=1024,
                     nq_ra=256, opq_iters=10, opq_train=100_000, profile=True):
    """The other quantizers on the flat index at full width: OPQ(M=16, B=8)
    on phase 4's corpus through the fused PQ kernel (beside PQ M=16);
    RankAware bpd=2 on phase 7's corpus through the packed kernel, prune on
    and off; SQ and LVQ at 8 bits through the generic plain scan (no
    kernel).  Profiles of OPQ's and RankAware's k=10 searches.  Returns the
    launches of OPQ's and RankAware's searches."""
    from vq_tpu_torch import KMeansConfig, LVQConfig, Metric, OPQConfig, PQConfig
    from vq_tpu_torch import RankAwareConfig, SearchConfig, SQConfig
    from vq_tpu_torch.data.sampling import host_sample_rows
    from vq_tpu_torch.index.flat import FlatQuantizedIndex
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.kernels import pq_scan as ps
    from vq_tpu_torch.kernels.adc import exact_topk
    from vq_tpu_torch.methods import rankaware as ra
    from vq_tpu_torch.methods.lvq import LVQ
    from vq_tpu_torch.methods.opq import OPQ
    from vq_tpu_torch.methods.pq import PQ
    from vq_tpu_torch.methods.sq import SQ

    launches = {}
    x, q = powerlaw_corpus(torch, n, d, nq, seed=0, dev=dev)
    gt = exact_topk(q, x, 100)[1].cpu().numpy()
    km = KMeansConfig(iters=20)
    ps.reset_launch_counts()
    opq = OPQ(OPQConfig(16, 8, opq_iters=opq_iters, kmeans=km), seed=0)
    _, t_fit = wall_s(torch, lambda: opq.fit(x))
    index = FlatQuantizedIndex(opq, SearchConfig(use_bf16=True))
    _, t_enc = wall_s(torch, lambda: index.fit(x))
    rot = opq.params.rotation
    r64 = rot.to(torch.float64)
    orth = float((r64.T @ r64 - torch.eye(d, dtype=torch.float64, device=dev)).abs().max())
    require(orth < 1e-5, f"OPQ rotation not orthogonal: max |RᵀR − I| = {orth}")
    log(f"[phase 11] OPQ M=16 B=8 N={n} D={d}: fit {t_fit:.3f} s (train cap {opq_train}, "
        f"opq_iters {opq_iters}), index fit (encode) {t_enc:.3f} s; max |RᵀR − I| = {orth:.2e}")
    opq_ids = {k: timed_search(torch, index, q, k, gt, "phase 11 OPQ") for k in (10, 100)}
    if profile:
        profile_search(torch, index, q, ks=(10,), tag=" OPQ")
    launches["pq_scan_topk_fused"] = ps.pq_scan_topk_fused.launches
    require_launched(launches, "OPQ's search never launched the fused kernel")
    qr, cb = q @ rot, opq.params.codebooks
    sl = index.codes[:100_000].contiguous()
    ks, ki = ps.pq_scan_topk_fused(qr, sl, cb, 10, use_bf16=False)
    rs, ri = ps.pq_scan_topk_fused_plain(qr, sl, cb, 11, True, None, False)
    err, n_sep, _ = check_topk_f32(torch, ks, ki, rs, ri, 10, f32_tol(torch, qr, cb),
                                   "OPQ fused f32 (rotated queries, 100k rows)")
    pq = PQ(PQConfig(16, 8, km), seed=0)
    pindex = FlatQuantizedIndex(pq, SearchConfig(use_bf16=True)).fit(x)
    pq_ids = {k: pindex.search_with_scores(q, k)[0] for k in (10, 100)}
    sample = host_sample_rows(x, opq_train, 0)
    log(f"[phase 11] OPQ fused kernel vs plain (f32, rotated queries, 100k rows, k=10): "
        f"max_abs_err={err:.3e}, ids = plain at {n_sep}/{nq} separated queries; launches "
        f"{launches}")
    log(f"[phase 11] OPQ vs PQ M=16 on this corpus: recall@10 {recall(gt, opq_ids[10], 10):.4f}"
        f" vs {recall(gt, pq_ids[10], 10):.4f}, recall@100 {recall(gt, opq_ids[100], 100):.4f} "
        f"vs {recall(gt, pq_ids[100], 100):.4f}; reconstruction MSE on the training sample "
        f"{opq.reconstruction_mse(sample):.6e} vs {pq.reconstruction_mse(sample):.6e}")
    del x, q, index, pindex, sample, qr, sl
    torch.cuda.empty_cache()

    x, q, _ = packed_corpus(torch, n_ra, d_ra, nq_ra, 0, dev)
    gt = exact_topk(q, x, 100)[1].cpu().numpy()
    pk.reset_launch_counts()
    ram = ra.RankAware(RankAwareConfig(bits_per_dim=2.0))
    _, t_fit = wall_s(torch, lambda: ram.fit(x))
    index = FlatQuantizedIndex(ram, SearchConfig(use_bf16=True))
    _, t_index = wall_s(torch, lambda: index.fit(x))
    cache = index._scan_cache
    segs = ra.packed_segspecs(ram.params, ram.bits)[0]
    log(f"[phase 11] RankAware bpd=2 N={n_ra} D={d_ra}: {rankaware_segments(segs)}, "
        f"{ram.code_bytes_per_vector():.0f} code bytes/row; fit {t_fit:.3f} s; index fit "
        f"(encode + norms + pack) {t_index:.3f} s; prune hint {cache.prune_hint}")
    out = {}
    for k in (10, 100):
        out[k] = timed_search(torch, index, q, k, gt, "phase 11 RankAware")
        ms = cuda_ms(torch, lambda: index.search_with_scores(q, k), reps=3, warmup=1)
        pr = {p_: ra.scan_topk(ram.params, ram.bits, ram.layout, "dense", q, index.codes, k,
                               Metric.L2, packed_cache=cache, prune_tiles=p_) for p_ in (True,
                                                                                        False)}
        require(torch.equal(pr[True][1], pr[False][1]), f"RankAware k={k}: prune ids differ "
                                                        f"from dense")
        _, _, cnt = ra._packed_scan(ram.params, ram.bits, q, cache, k, Metric.L2, prune=True)
        units = pk.prune_units(nq_ra, cache.factors.shape[1], dev)
        log(f"[phase 11] RankAware k={k}: {ms:.3f} ms/search (CUDA events, median of 3); prune "
            f"ids = dense ids; {int(cnt)}/{units} (query block, tile) pairs scanned = "
            f"{int(cnt) / units:.4f}")
    require(bool((out[10] == out[100][:, :10]).all()), "RankAware k=10 and k=100 disagree")
    if profile:
        profile_search(torch, index, q, ks=(10,), tag=" RankAware")
    launches["packed_scan_topk"] = pk.packed_scan_topk.launches
    require_launched({"packed_scan_topk": launches["packed_scan_topk"]},
                     "RankAware's search never launched the packed kernel")
    del index, cache
    torch.cuda.empty_cache()
    for name, quant in (("SQ 8 bits", SQ(SQConfig(8))), ("LVQ 8 bits", LVQ(LVQConfig(8)))):
        ps.reset_launch_counts()
        pk.reset_launch_counts()
        index, t_index = wall_s(torch, lambda: FlatQuantizedIndex(
            quant, SearchConfig(use_bf16=True)).fit(x))
        timed_search(torch, index, q, 10, gt, f"phase 11 {name}")
        ms = cuda_ms(torch, lambda: index.search_with_scores(q, 10), reps=3, warmup=1)
        kernels = (ps.pq_scan_topk_fused.launches + ps.pq_score_all.launches
                   + pk.packed_scan_topk.launches + pk.packed_scan_topk.gather_launches)
        require(kernels == 0, f"{name}: a scan kernel launched on the generic path")
        log(f"[phase 11] {name}: index fit {t_index:.3f} s, {quant.code_bytes_per_vector():.0f} "
            f"code bytes/row; k=10 {ms:.3f} ms/search (CUDA events, median of 3) through the "
            f"generic plain scan (no kernel: the JAX package leaves it to XLA)")
        del index
    del x, q
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 12
def union_fraction(torch, index, q, nprobe) -> float:
    """Rows in the batch's union of probed lists / all rows."""
    from vq_tpu_torch.kernels.kmeans import pairwise_sqdist_xc
    from vq_tpu_torch.kernels.topk import ordered_topk

    probe = ordered_topk(-pairwise_sqdist_xc(q, index.centroids), nprobe)[1]
    union = torch.zeros((index.centroids.shape[0],), dtype=torch.bool, device=q.device)
    union[probe.reshape(-1).long()] = True
    return int(index.sizes[union].sum()) / index.num_rows


def probe_ceiling(torch, index, q, gt, nprobe, r) -> float:
    """The share of the true top-r that lies in the lists each query
    probes: the recall@r an exact scan of those lists' raw rows would
    reach, so recall below it is the quantizer's, not the probes'."""
    from vq_tpu_torch.kernels.kmeans import pairwise_sqdist_xc
    from vq_tpu_torch.kernels.topk import ordered_topk

    probe = ordered_topk(-pairwise_sqdist_xc(q, index.centroids), nprobe)[1]
    cells = index._assignment[torch.as_tensor(gt[:, :r], device=q.device).long()]
    return float((cells[..., None] == probe[:, None, :]).any(-1).float().mean())


def probed_exact_topk(torch, index, q, nprobe, k):
    """Plain witness of a residual-IVF search: each query's probed lists
    read row by row, every row rebuilt by global id (``decompress``: the
    residual decode plus its centroid) and scored by the direct difference
    ‖q − x̂‖², top-k ascending → (ids (Q, k) uint32, scores (Q, k) f32) as
    numpy.  It shares no window, mask or score algebra with the scans."""
    from vq_tpu_torch.kernels.kmeans import pairwise_sqdist_xc
    from vq_tpu_torch.kernels.topk import ordered_topk

    probe = ordered_topk(-pairwise_sqdist_xc(q, index.centroids), nprobe)[1].cpu().numpy()
    offs, szs = index.offsets.cpu().numpy(), index.sizes.cpu().numpy()
    out_i, out_s = [], []
    for qi in range(q.shape[0]):
        pos = np.concatenate([np.arange(offs[c], offs[c] + szs[c]) for c in probe[qi]])
        ids = index.ids_sorted[torch.as_tensor(pos, device=q.device)].long()
        d2 = torch.sum((q[qi] - index.decompress(ids)) ** 2, dim=1)
        s, j = ordered_topk(-d2[None], k)
        out_s.append((-s[0]).cpu().numpy())
        out_i.append(ids[j[0].long()].cpu().numpy().astype(np.uint32))
    return np.stack(out_i), np.stack(out_s)


def union_host_split(torch, index, q, k, reps=3) -> None:
    """Where a union search's wall time goes, for one query block (the
    whole batch): per run, the host seconds to issue the block (the Python
    loop over windows returns once every launch is queued; its one host
    read, the loop bound, comes first) and the seconds the device still
    needs after that, each per window; then torch.profiler over one block:
    the CUDA runtime calls per window (launches, synchronizations, copies,
    allocations), the allocator's requests and device allocations, and the
    host ops with the most host time."""
    from torch.profiler import ProfilerActivity, profile

    nprobe = index.ivf_cfg.nprobe
    chunk = index._auto_chunk("union")
    rows = round(union_fraction(torch, index, q, nprobe) * index.num_rows)
    windows = -(-rows // chunk)
    valid = torch.ones((q.shape[0],), dtype=torch.bool, device=q.device)

    def block():
        return index._search_block(q, valid, k, nprobe, chunk, "union")

    issue, tail = [], []
    for _ in range(reps + 1):  # the first is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        issue.append((t1 - t0) * 1e3)
        tail.append((time.perf_counter() - t1) * 1e3)
    log(f"[profile] IVF-residual host split Q={q.shape[0]} nprobe={nprobe} k={k}: {windows} "
        f"windows of {chunk} rows; host issue " + ", ".join(f"{t:.3f}" for t in issue[1:])
        + " ms (" + ", ".join(f"{t / windows:.4f}" for t in issue[1:]) + " ms a window), "
        "device tail after it " + ", ".join(f"{t:.3f}" for t in tail[1:])
        + " ms (host clock, synchronised; " + f"{reps} runs)")
    m0 = torch.cuda.memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        block()
        torch.cuda.synchronize()
    m1 = torch.cuda.memory_stats()
    runtime, busy = {}, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.device_time / 1e3
        elif e.name.startswith("cu"):
            n, ms = runtime.get(e.name, (0, 0.0))
            runtime[e.name] = (n + 1, ms + e.cpu_time_total / 1e3)
    allocs = {key: m1.get(key, 0) - m0.get(key, 0)
              for key in ("allocation.all.allocated", "num_device_alloc", "num_alloc_retries")}
    log(f"[profile] IVF-residual host split: device busy {busy:.3f} ms a block; allocator "
        f"requests {allocs['allocation.all.allocated'] / windows:.1f} a window, device "
        f"allocations (cudaMalloc) {allocs['num_device_alloc']}, retries "
        f"{allocs['num_alloc_retries']} (torch.cuda.memory_stats)")
    for name, (n, ms) in sorted(runtime.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[profile] IVF-residual host split:   {n / windows:7.2f} a window  {ms:9.3f} ms "
            f"host  {name[:60]}")
    for a in sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:10]:
        log(f"[profile] IVF-residual host split:   host op {a.key[:50]:50s} {a.count:6d} calls "
            f"{a.self_cpu_time_total / 1e3:9.3f} ms self")


def same_where_separated(torch, index, q, a, b, what):
    """Two residual-IVF results of the same candidates, (ids, scores) as
    numpy, L2 ascending: scores within the f32 tolerance F32_RTOL·(‖q‖² +
    2·max‖x̂‖²), ids equal at every rank whose score is separated from its
    neighbours by more than it.  Returns (max |Δscore|, separated ranks)."""
    xh = index.decompress(a[0].reshape(-1).astype(np.int64))
    return where_separated(torch, q, float(torch.max(torch.sum(xh * xh, dim=1))), a, b, what)


def where_separated(torch, q, xh_sq_max, a, b, what):
    """``same_where_separated`` with max‖x̂‖² given."""
    ids_a, s_a = a
    ids_b, s_b = b
    tol = F32_RTOL * (torch.sum(q * q, dim=1).cpu().numpy()[:, None] + 2.0 * xh_sq_max)
    err = np.abs(s_a - s_b)
    require(bool((err <= tol).all()), f"{what}: scores differ by more than the f32 tolerance")
    gap = np.diff(s_a, axis=1)
    sep = np.ones_like(s_a, dtype=bool)
    sep[:, 1:] &= gap > tol
    sep[:, :-1] &= gap > tol
    require(bool((ids_a == ids_b)[sep].all()), f"{what}: ids differ at separated ranks")
    return float(err.max()), int(sep.sum())


def phase_ivf_residual(torch, dev, ctx, k_cl=4096, nprobes=(50, 200), nq_small=8,
                       pq_m=192, profile=True):
    """The residual IVF index (``bench.py:543-573`` on the port) on phase 10's
    corpus and coarse pass (no second k-means): SAQ bpd=2 + PCA (the
    residual_scorer path) and PQ M=192 B=8 (the decode_fn path), union
    strategy, nprobe 50 and 200 at Q=256, k=100, each recall beside its
    probe ceiling; at Q=8, nprobe=50, union = the probed lists decoded and
    scored exactly (both indexes) and windows = union (SAQ), where
    separated; a profile and a host split of the SAQ nprobe=50 search;
    then IvfPackedFlatIndex(RankAware bpd=2) at nprobe=50, whose gather
    launches it returns."""
    from vq_tpu_torch import IVFConfig, KMeansConfig, PQConfig, RankAwareConfig, SAQConfig
    from vq_tpu_torch import SearchConfig
    from vq_tpu_torch.data.sampling import host_sample_rows
    from vq_tpu_torch.index.ivf import IvfQuantizedIndex
    from vq_tpu_torch.index.ivf_packed import IvfPackedFlatIndex
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.methods.pq import PQ
    from vq_tpu_torch.methods.rankaware import RankAware
    from vq_tpu_torch.methods.saq import SAQ

    x, q, gt, cents, asn, kmc = (ctx[key] for key in ("x", "q", "gt", "cents", "asn", "kmc"))
    k = 100
    for tag, quant in (("SAQ bpd=2", SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True))),
                       (f"PQ M={pq_m} B=8", PQ(PQConfig(pq_m, 8, KMeansConfig(iters=10)),
                                                seed=1))):
        index = IvfQuantizedIndex(quant, IVFConfig(k_cl, nprobes[0], kmc),
                                  SearchConfig(use_bf16=True))
        _, t_build = wall_s(torch, lambda: index.fit(x, coarse=(cents, asn)))
        path = "residual_scorer" if quant.residual_scorer() is not None else "decode_fn"
        require(index.codes_sorted.device == x.device, f"IVF {tag}: the lists left the card")
        log(f"[phase 12] IVF-residual {tag} ({path} path): build (residual fit + encode, the "
            f"coarse pass reused) {t_build:.3f} s; {quant.code_bytes_per_vector():.0f} code "
            f"bytes/row; largest list {index.max_cluster} rows; footprint "
            f"{index.memory_footprint() / 1e6:.1f} MB")
        for nprobe in nprobes:
            index.ivf_cfg = dataclasses.replace(index.ivf_cfg, nprobe=nprobe)
            ids, scores = index.search_with_scores(q, k)
            require(ids.shape == (q.shape[0], k) and bool(np.isfinite(scores).all()),
                    f"IVF {tag} nprobe={nprobe}: result")
            require(bool((np.diff(scores, axis=1) >= 0).all()), f"IVF {tag}: not ascending")
            ms = cuda_ms(torch, lambda: index.search_with_scores(q, k), reps=3, warmup=1)
            recalls = ", ".join(f"recall@{r} {recall(gt, ids, r):.4f} (probe ceiling "
                                f"{probe_ceiling(torch, index, q, gt, nprobe, r):.4f})"
                                for r in (1, 10, 100))
            log(f"[phase 12] IVF-residual {tag} Q={q.shape[0]} nprobe={nprobe} k={k} union: "
                f"{ms:.3f} ms/search (CUDA events, median of 3), QPS {q.shape[0] / ms * 1e3:.1f}"
                f"; rows in the batch's union {union_fraction(torch, index, q, nprobe):.4f}; "
                f"{recalls}")
            if tag.startswith("SAQ") and nprobe == nprobes[0]:  # what phase 13 reuses
                ctx["residual"] = dict(saq=quant, recall=recall(gt, ids, k))
        index.ivf_cfg = dataclasses.replace(index.ivf_cfg, nprobe=nprobes[0])
        qs = q[:nq_small]
        u = index.search_with_scores(qs, k, strategy="union")
        err, n_sep = same_where_separated(
            torch, index, qs, u, probed_exact_topk(torch, index, qs, nprobes[0], k),
            f"IVF {tag} Q={nq_small} union vs the probed lists decoded exactly")
        log(f"[phase 12] IVF-residual {tag} Q={nq_small} nprobe={nprobes[0]}: union = the "
            f"probed lists' rows decoded by id and scored exactly (max |Δscore| {err:.3e}, ids "
            f"equal at {n_sep} separated ranks)")
        if tag.startswith("SAQ"):
            w = index.search_with_scores(qs, k, strategy="windows")
            err, n_sep = same_where_separated(torch, index, qs, u, w,
                                              f"IVF {tag} Q={nq_small} windows vs union")
            t_s = {st: cuda_ms(torch, lambda: index.search_with_scores(qs, k, strategy=st),
                               reps=3, warmup=1) for st in ("windows", "union")}
            log(f"[phase 12] IVF-residual {tag} Q={nq_small} nprobe={nprobes[0]}: windows = "
                f"union (max |Δscore| {err:.3e}, ids equal at {n_sep} separated ranks); "
                f"windows {t_s['windows']:.3f} ms, union {t_s['union']:.3f} ms (CUDA events, "
                f"median of 3)")
            if profile:
                profile_search(torch, index, q, ks=(k,), tag=" IVF-residual", reps=3)
                union_host_split(torch, index, q, k)
        del index, quant
        torch.cuda.empty_cache()
    pk.reset_launch_counts()
    ram = RankAware(RankAwareConfig(bits_per_dim=2.0))
    _, t_qfit = wall_s(torch, lambda: ram.fit(host_sample_rows(x, 200_000, kmc.seed)))
    rindex = IvfPackedFlatIndex(ram, IVFConfig(k_cl, nprobes[0], kmc), SearchConfig(use_bf16=True))
    _, t_fit = wall_s(torch, lambda: rindex.fit(x, coarse=(cents, asn)))
    log(f"[phase 12] IVF-packed RankAware bpd=2: fit {t_qfit:.3f} s, encode + pack "
        f"{t_fit:.3f} s; {ram.code_bytes_per_vector():.0f} code bytes/row")
    ivf_search(torch, rindex, q, nprobes[0], k, gt,
               f"IVF-packed RankAware bpd=2 Q={q.shape[0]} nprobe={nprobes[0]} k={k}",
               phase="phase 12")
    launches = pk.packed_scan_topk.gather_launches
    require_launched({"packed_scan_topk_gather": launches},
                     "IVF-packed RankAware never launched the gather kernel")
    del rindex, ram
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 13
def same_up_to_ties(torch, q, decode, a, b, what) -> int:
    """Two top-k results (ids, scores) as numpy that should be one: scores
    bit for bit, and ids equal at every rank whose score ties neither
    neighbour's, the k-th excepted.  Inside a run of equal scores two scans
    may order the tied rows differently, and at the k-th pick another of
    the rows that tie it (one the top-k does not show): the kernels break a
    tie by the order rows reach the fold.  Where the ids differ, both rows
    are rebuilt (``decode``: global ids → (n, D) rows on q's device) and
    rescored by the direct difference ‖q − x̂‖²: each must score what its
    rank reports, within BF16_RTOL·(‖q‖² + 2·‖x̂‖²).  Every query's first
    row is rescored too, so the rescoring itself is held on every call.
    Returns the ranks whose ids differ."""
    (ia, sa), (ib, sb) = a, b
    require(np.array_equal(sa, sb), f"{what}: scores differ")
    tied = np.zeros(sa.shape, dtype=bool)
    eq = sa[:, 1:] == sa[:, :-1]
    tied[:, 1:] |= eq
    tied[:, :-1] |= eq
    tied[:, -1] = True
    qd, rd = np.nonzero(ia != ib)
    bad = np.argwhere((ia != ib) & ~tied)
    require(len(bad) == 0, f"{what}: ids differ at untied ranks (query, rank) {bad[:5].tolist()}")
    nq = ia.shape[0]
    qi = np.concatenate([qd, qd, np.arange(nq)])
    r = np.concatenate([rd, rd, np.zeros(nq, dtype=rd.dtype)])
    xh = decode(np.concatenate([ia[qd, rd], ib[qd, rd], ia[:, 0]]).astype(np.int64))
    qq = q[torch.as_tensor(qi, device=q.device)]
    d2 = torch.sum((qq - xh) ** 2, dim=1).cpu().numpy()
    tol = BF16_RTOL * (torch.sum(qq * qq, dim=1) + 2.0 * torch.sum(xh * xh, dim=1))
    off = np.nonzero(np.abs(d2 - sa[qi, r]) > tol.cpu().numpy())[0]
    require(len(off) == 0, f"{what}: a row rescored does not score its rank's score (query, "
                           f"rank) {list(zip(qi[off][:5].tolist(), r[off][:5].tolist()))}")
    return len(qd)


def decode_codes(torch, quant, codes):
    """Rows rebuilt by global id from a flat index's codes."""
    return lambda ids: quant.decompress(codes[torch.as_tensor(ids, device=codes.device)])


def decode_corpus(torch, quant, x):
    """Rows rebuilt by global id by encoding the corpus's rows again (an
    index that keeps only a packed cache)."""
    return lambda ids: quant.decompress(quant.compress(x[torch.as_tensor(ids,
                                                                         device=x.device)]))


def beside(what, k, nq, ms, ms_single, single):
    log(f"[phase 13] {what} k={k}: {ms:.3f} ms/search, QPS {nq / ms * 1e3:.1f} (host clock, "
        f"median of 3); {single} {ms_single:.3f} ms, QPS {nq / ms_single * 1e3:.1f}; ratio "
        f"{ms / ms_single:.3f}")


def max_sq_norm(torch, decode, ids) -> float:
    """max ‖x̂‖² over the rows ``ids`` (numpy), rebuilt by ``decode``."""
    xh = decode(ids.reshape(-1).astype(np.int64))
    return float(torch.max(torch.sum(xh * xh, dim=1)))


KERNELS = ("pq_scan_topk_fused", "pq_score_all", "packed_scan_topk", "packed_scan_topk_gather")


def launch_counts() -> dict:
    """The four kernels' launch counters, by kernel."""
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.kernels import pq_scan as ps

    return dict(zip(KERNELS, (ps.pq_scan_topk_fused.launches, ps.pq_score_all.launches,
                              pk.packed_scan_topk.launches,
                              pk.packed_scan_topk.gather_launches)))


@contextlib.contextmanager
def counting(path: dict):
    """Yields a dict that holds, when the block ends, the launches made in
    it by kernel; they are added to ``path``, the launches of the path the
    block drives (the launches of any other work stay out of it)."""
    before, got = launch_counts(), {}
    yield got
    for name, n in launch_counts().items():
        got[name] = n - before[name]
        path[name] = path.get(name, 0) + got[name]


def sharded_pq(torch, mesh, x, q, ctx, what, path, profile=True):
    """ShardedFlatPQIndex(PQ M=16) on ``mesh`` against phase 4's flat index:
    k=10 and 100 (the fused kernel, P launches a search), k=256 (the score
    kernel), scores bit for bit and ids up to ties; overlap_chunks=4 = 1.
    The sharded searches' launches are added to ``path``."""
    from vq_tpu_torch.dist import ShardedFlatPQIndex
    from vq_tpu_torch.dist.mesh import all_gather
    from vq_tpu_torch.dist.sharded import sharded_scan_topk

    flat, pq = ctx["index"], ctx["pq"]
    n, nq, p_cnt = x.shape[0], q.shape[0], mesh.size
    decode = decode_codes(torch, pq, flat.codes)
    sidx, t_fit = wall_s(torch, lambda: ShardedFlatPQIndex(pq, flat.search_cfg, mesh).fit(x))
    codes = all_gather(mesh, sidx.codes, dim=0)
    require(torch.equal(codes[:n], flat.codes) and codes.shape[0] == -(-n // p_cnt) * p_cnt,
            f"{what}: the shards' codes are not the flat index's")
    log(f"[phase 13] {what}: ShardedFlatPQIndex fit (encode + shard) {t_fit:.3f} s; {p_cnt} "
        f"shards of {sidx.codes[0].shape[0]} rows ({codes.shape[0] - n} pad rows)")
    for k in (10, 100, 256):  # k ≤ 128: the fused kernel; 256: the score kernel
        with counting(path) as got:
            (ids, scores), ms = timed(torch, sidx, q, k, what)  # the warm-up and 3 searches
        require_launches(got["pq_scan_topk_fused"], 4 * p_cnt if k <= 128 else 0,
                         f"{what} k={k} fused, 4 searches")
        if k > 128:
            require_launched({"pq_score_all": got["pq_score_all"]}, f"{what} k={k}: the score "
                                                                    f"kernel")
        else:
            require_launches(got["pq_score_all"], 0, f"{what} k={k} score kernel")
        want, ms_flat = timed(torch, flat, q, k, "phase 4 flat")
        tied = same_up_to_ties(torch, q, decode, (ids, scores), want,
                               f"{what} k={k} vs FlatQuantizedIndex")
        beside(f"{what} PQ M=16 Q={nq}", k, nq, ms, ms_flat, "FlatQuantizedIndex")
        log(f"[phase 13] {what} k={k}: scores = FlatQuantizedIndex's bit for bit, ids equal at "
            f"every untied rank ({tied} of {ids.size} ids differ, each at a tie, each rescored "
            f"to its rank's score)")
    cbs = [r.params.codebooks for r in sidx._replicas]
    with counting(path) as got:
        res = [sharded_scan_topk(mesh, q, sidx.codes, cbs, 10, true_n=n, overlap_chunks=c)
               for c in (1, 4)]
    fused = got["pq_scan_topk_fused"]
    # a shard's rows split into the most chunks, at most 4, that divide them
    chunks = next(c for c in (4, 3, 2, 1) if sidx.codes[0].shape[0] % c == 0)
    require_launches(fused, p_cnt * (1 + chunks), f"{what} overlap_chunks 1 and {chunks}")
    tied = same_up_to_ties(torch, q, decode,
                           *[(i.cpu().numpy(), s.cpu().numpy()) for s, i in res],
                           f"{what} overlap_chunks=4 vs 1")
    log(f"[phase 13] {what}: {p_cnt} fused launches a search at k ≤ 128; overlap_chunks=4 = 1 "
        f"up to ties ({tied} ids differ, each at a tie; {fused} launches for the two)")
    if profile:
        profile_search(torch, sidx, q, ks=(10,), tag=f" sharded PQ {what}")
    return sidx


def sharded_saq(torch, mesh, x, q, ctx, what, path, profile=True):
    """ShardedPackedFlatIndex(SAQ bpd=2) on ``mesh`` against phase 7's flat
    index at k=10 and 100: f32 ids equal where separated, bf16 recall ≥
    BF16_MIN_RECALL, P packed launches a search, overlap_chunks=2 = 1.  The
    sharded searches' launches are added to ``path``."""
    from vq_tpu_torch.dist import ShardedPackedFlatIndex

    flat, saq = ctx["index"], ctx["saq"]
    nq, p_cnt = q.shape[0], mesh.size
    decode = decode_codes(torch, saq, flat.codes)
    bf16_cfg = flat.search_cfg
    f32_cfg = dataclasses.replace(bf16_cfg, use_bf16=False)
    sidx, t_fit = wall_s(torch, lambda: ShardedPackedFlatIndex(saq, bf16_cfg, mesh).fit(x))
    log(f"[phase 13] {what}: ShardedPackedFlatIndex(SAQ bpd=2) fit (encode + per-shard "
        f"norm-ordered pack) {t_fit:.3f} s; {p_cnt} shards of {sidx._n_loc} rows; prune hint "
        f"{sidx.shards[0].prune_hint}")
    for k in (10, 100):
        with counting(path) as got:
            (ids, scores), ms = timed(torch, sidx, q, k, what)  # the warm-up and 3 searches
        require_launches(got["packed_scan_topk"], 4 * p_cnt, f"{what} k={k} packed, 4 searches")
        (fids, _), ms_flat = timed(torch, flat, q, k, "phase 7 flat")
        rec = recall(fids, ids, k)
        require(rec >= BF16_MIN_RECALL, f"{what} k={k}: bf16 recall {rec} against the flat index")
        with counting(path) as got:
            two = sidx.search_with_scores(q, k, overlap_chunks=2)
        require_launches(got["packed_scan_topk"], 2 * p_cnt, f"{what} k={k} overlap_chunks=2")
        tied = same_up_to_ties(torch, q, decode, two, (ids, scores),
                               f"{what} k={k} overlap_chunks=2 vs 1")
        sidx.search_cfg, flat.search_cfg = f32_cfg, f32_cfg
        with counting(path):
            got32 = sidx.search_with_scores(q, k)
        want = flat.search_with_scores(q, k)
        sidx.search_cfg, flat.search_cfg = bf16_cfg, bf16_cfg
        err, n_sep = where_separated(torch, q, max_sq_norm(torch, decode, want[0]), want, got32,
                                     f"{what} k={k} f32")
        beside(f"{what} SAQ bpd=2 Q={nq}", k, nq, ms, ms_flat, "FlatQuantizedIndex")
        log(f"[phase 13] {what} k={k}: bf16 recall@{k} against the flat index {rec:.4f}; f32 "
            f"max |Δscore| {err:.3e}, ids equal at {n_sep} separated ranks; {p_cnt} packed "
            f"launches a search; overlap_chunks=2 = 1 up to ties ({tied} ids differ, each at a "
            f"tie)")
    if profile:
        profile_search(torch, sidx, q, ks=(10,), tag=f" sharded SAQ {what}")
    return sidx


def phase_sharded(torch, dev, ctx4, ctx7, ctx10, shards=4, nprobe=50, profile=True):
    """Sharded serving on one card: a mesh of ``shards`` shards on ``dev``
    (and of 3, where phase 4's N is ragged), each index beside the
    single-device index of the same phase on that phase's corpus, fits and
    quantizers; then dp_lloyd_step twice (bit-equal) and the port's
    dryrun_multichip; the PQ and SAQ checks again on a mesh of one shard
    per card where there is more than one.  Returns the launches of the
    sharded indexes' searches on the one card, by kernel: those of the
    single-device searches they are held against, of the profiles, of the
    per-shard prune read-out and of the dryrun's toy sizes are not in it."""
    from vq_tpu_torch import IVFConfig, Metric, SearchConfig
    from vq_tpu_torch.data.sampling import chunk_rows_for_bytes
    from vq_tpu_torch.dist import ShardedIVFIndex, ShardedIvfPackedIndex, make_mesh
    from vq_tpu_torch.dist.dryrun import dryrun_multichip
    from vq_tpu_torch.dist.sharded import _fold, dp_lloyd_step
    from vq_tpu_torch.dist.sharded_packed import chunk_of
    from vq_tpu_torch.index.ivf import IvfQuantizedIndex, chunked_assign, coarse_sample
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.methods import saq as sq

    mesh = make_mesh(devices=[dev] * shards)
    log(f"[phase 13] mesh of {shards} shards on {dev} (one process; devices may repeat)")
    path = dict.fromkeys(KERNELS, 0)
    x, q = remake(torch, ctx4["maker"], dev)
    spq = sharded_pq(torch, mesh, x, q, ctx4, f"P={shards}", path, profile)
    sharded_pq(torch, make_mesh(devices=[dev] * 3), x, q, ctx4, "P=3 (ragged)", path, False)
    del x
    torch.cuda.empty_cache()
    x7, q7 = remake(torch, ctx7["maker"], dev)
    ssaq = sharded_saq(torch, mesh, x7, q7, ctx7, f"P={shards}", path, profile)
    del x7

    x, q, gt, cents, asn, kmc = (ctx10[key] for key in ("x", "q", "gt", "cents", "asn", "kmc"))
    k, k_cl, nq = 100, cents.shape[0], q.shape[0]
    single = ctx10["index"]
    single.ivf_cfg = dataclasses.replace(single.ivf_cfg, nprobe=nprobe)
    sidx, t_fit = wall_s(torch, lambda: ShardedIvfPackedIndex(
        ctx10["saq"], single.ivf_cfg, single.search_cfg, mesh).fit(x, coarse=(cents, asn)))
    with counting(path) as got:
        (ids, scores), ms = timed(torch, sidx, q, k, "sharded IVF-packed")
    require_launches(got["packed_scan_topk_gather"], 4 * shards,
                     "sharded IVF-packed gather, 4 searches")
    want, ms_single = timed(torch, single, q, k, "phase 10 IVF-packed")
    tied = same_up_to_ties(torch, q, decode_corpus(torch, ctx10["saq"], x), (ids, scores), want,
                           "sharded IVF-packed vs IvfPackedFlatIndex")
    log(f"[phase 13] P={shards} ShardedIvfPackedIndex(SAQ bpd=2) fit(coarse=…) {t_fit:.3f} s; "
        f"nprobe={nprobe} Q={nq} k={k}: scores = IvfPackedFlatIndex's bit for bit, ids at "
        f"every untied rank ({tied} ids differ, each at a tie); {shards} gather launches a "
        f"search; recall@{k} {recall(gt, ids, k):.4f}")
    beside(f"P={shards} IVF-packed SAQ nprobe={nprobe} Q={nq}", k, nq, ms, ms_single,
           "IvfPackedFlatIndex")
    del sidx

    res = ctx10["residual"]
    cfg = IVFConfig(k_cl, nprobe, kmc)
    sivf, t_fit = wall_s(torch, lambda: ShardedIVFIndex(res["saq"], cfg, SearchConfig(),
                                                        mesh).fit(x))
    require(torch.equal(sivf.centroids, cents), "the sharded index's coarse pass differs from "
                                                "phase 10's (one seed, one recipe)")
    own_asn = chunked_assign(x, sivf.centroids, chunk_rows_for_bytes(x.shape[1]))
    ref = IvfQuantizedIndex(res["saq"], cfg, SearchConfig()).fit(x, coarse=(sivf.centroids,
                                                                            own_asn))
    with counting(path):
        got = sivf.search_with_scores(q, k)
    want = ref.search_with_scores(q, k)
    err, n_sep = same_where_separated(torch, ref, q, want, got,
                                      "sharded IVF-residual vs IvfQuantizedIndex")
    with counting(path):
        ms = cuda_ms(torch, lambda: sivf.search_with_scores(q, k), reps=3, warmup=1)
    ms_single = cuda_ms(torch, lambda: ref.search_with_scores(q, k), reps=3, warmup=1)
    loads = [int((sivf.ids_sh[p] >= 0).sum()) for p in range(shards)]
    log(f"[phase 13] P={shards} ShardedIVFIndex(SAQ bpd=2, phase 12's fit) build (coarse pass "
        f"+ encode) {t_fit:.3f} s, centroids = phase 10's bit for bit, rows a shard {loads}; "
        f"nprobe={nprobe} Q={nq} k={k} union: = IvfQuantizedIndex on its centroids where "
        f"separated (max |Δscore| {err:.3e}, ids equal at {n_sep} separated ranks); "
        f"recall@{k} {recall(gt, got[0], k):.4f} (phase 12: {res['recall']:.4f}); "
        f"{ms:.3f} ms/search against {ms_single:.3f} (CUDA events, median of 3)")
    del sivf, ref
    log(f"[phase 13] launches of the sharded searches on {dev}: {path}")
    require_launched(path, "a kernel of sharded serving never launched")

    xs = coarse_sample(x, kmc, k_cl, dev)  # the coarse pass's training rows
    xs = xs[: xs.shape[0] // shards * shards]
    c1, t1 = wall_s(torch, lambda: dp_lloyd_step(mesh, xs, cents))
    c2, t2 = wall_s(torch, lambda: dp_lloyd_step(mesh, xs, cents))
    require(torch.equal(c1, c2), "two dp_lloyd_step runs differ")
    log(f"[phase 13] dp_lloyd_step on {xs.shape[0]} rows, K={k_cl}, run twice: bit-equal "
        f"({t1:.3f} s, {t2:.3f} s)")
    del xs
    dryrun_multichip(shards, device=dev.type)

    # what the searches above do not show: each shard's prune stage, the
    # factor-column copies of overlap chunks, the merge
    for p, cache in enumerate(ssaq.shards):
        _, _, cnt = sq._packed_scan(ctx7["saq"].plan, ctx7["saq"].params, q7, cache, 10,
                                    Metric.L2, prune=True)
        units = pk.prune_units(q7.shape[0], cache.factors.shape[1], dev)
        log(f"[phase 13] sharded SAQ shard {p}: prune stage k=10 {int(cnt)}/{units} (query "
            f"block, tile) pairs scanned = {int(cnt) / units:.4f}")
    nf, n_loc = ssaq.shards[0].factors.shape
    copies = cuda_ms(torch, lambda: [chunk_of(c, i, n_loc // 2) for c in ssaq.shards
                                     for i in range(2)])
    log(f"[profile] sharded SAQ overlap_chunks=2: the chunks' factor-column copies "
        f"{copies:.3f} ms a search (CUDA events, median of 5; {shards} shards × ({nf}, "
        f"{n_loc}) f32, {2 * shards * nf * n_loc * 4 / 1e6:.1f} MB read and written)")
    for name, nqq in (("PQ", ctx4["gt"].shape[0]), ("SAQ", ctx7["gt"].shape[0])):
        parts = [(torch.randn((nqq, 10), device=dev), torch.randint(
            0, 1 << 20, (nqq, 10), device=dev, dtype=torch.int32)) for _ in range(shards)]
        log(f"[profile] sharded {name} merge Q={nqq} k=10 P={shards}: "
            f"{cuda_ms(torch, lambda: _fold(mesh, None, parts, 10)):.3f} ms (CUDA events, "
            f"median of 5: the all-gather at the root and the ordered top-k)")
    del spq, ssaq

    if torch.cuda.device_count() > 1:
        cards, per_card = make_mesh(), dict.fromkeys(KERNELS, 0)
        x, q = remake(torch, ctx4["maker"], dev)
        sharded_pq(torch, cards, x, q, ctx4, f"one shard per card (P={cards.size})", per_card,
                   False)
        del x
        x7, q7 = remake(torch, ctx7["maker"], dev)
        sharded_saq(torch, cards, x7, q7, ctx7, f"one shard per card (P={cards.size})",
                    per_card, False)
        del x7
        log(f"[phase 13] launches of the sharded searches on one shard per card: {per_card}")
    else:
        log(f"[phase 13] one shard per card: not run ({torch.cuda.device_count()} card)")
    torch.cuda.empty_cache()
    return path


# ---------------------------------------------------------------- phase 15
def subset_kernel(torch, dev, results, n, d, nq, heads, k1s):
    """The packed kernel on a segment subset against its plain version:
    SAQ uniform bpd=2 on phase 6's corpus, the head subsets ``heads`` and a
    tail subset (whose segments' scale and L2 shift columns are not the
    first ones), k1s, L2 / IP / NIP, a norm-ordered and an
    order-preserving cache: f32 ids where separated, bf16 recall against
    the plain bf16 version; then kernel and plain times beside the bound."""
    from vq_tpu_torch import Metric, SAQConfig
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.methods import saq as sq

    t0 = time.perf_counter()
    x, q, _ = packed_corpus(torch, n, d, nq, seed=11, dev=dev, lognormal=True)
    norms = torch.linalg.norm(x, dim=1)
    m = sq.SAQ(SAQConfig(bits_per_dim=2.0)).fit(x)
    codes = m.compress(x)
    del x
    s_cnt = m.plan.num_segments
    subsets = [tuple(range(p)) for p in heads] + [(s_cnt - 1,)]
    r = results.setdefault("packed_scan_topk", {"max_abs_err": 0.0, "times": {}, "bounds": {}})
    worst, n_sep, worst_rec, combos = 0.0, 0, 1.0, 0
    for sort_rows in (True, False):
        cache = sq.prepare_packed(m.plan, m.params, codes, norms=norms, sort_rows=sort_rows)
        for seg_ids in subsets:
            for k1 in k1s:
                for metric in (Metric.L2, Metric.IP, Metric.NIP):
                    what = (f"subset {seg_ids} k={k1} {metric.name} "
                            f"{'norm-ordered' if sort_rows else 'order-preserving'}")
                    a = sq.packed_scan_args(m.plan, m.params, q, cache, k1, metric,
                                            seg_ids=seg_ids, use_bf16=False)
                    require([s.scale_col for s in a["segs"]] == list(seg_ids) and
                            (metric != Metric.L2 or
                             a["r2_cols"] == tuple(s_cnt + s for s in seg_ids)),
                            f"{what}: the subset's factor columns")
                    ks, ki = pk.packed_scan_topk(**a)
                    rs, ri = pk.packed_scan_topk_plain(**{**a, "k": k1 + 1})
                    err, sep, _ = check_topk_f32(torch, ks, ki, rs, ri, k1, packed_tol(torch, a),
                                                 f"packed f32 {what}")
                    worst, n_sep, combos = max(worst, err), n_sep + sep, combos + 1
                    ab = {**a, "use_bf16": True}
                    rec = recall(pk.packed_scan_topk_plain(**ab)[1].cpu(),
                                 pk.packed_scan_topk(**ab)[1].cpu(), k1)
                    worst_rec = min(worst_rec, rec)
                    require(rec >= BF16_MIN_RECALL, f"packed bf16 {what}: recall {rec}")
    r["max_abs_err"] = max(r["max_abs_err"], worst)
    log(f"[phase 15] packed kernel on segment subsets {subsets} of SAQ bits {m.plan.seg_bits} "
        f"lens {m.plan.seg_lens} (N={n}, D={d}, Q={nq}), {combos} (cache, subset, k, metric) "
        f"calls: f32 max_abs_err={worst:.3e}, ids = plain at {n_sep} separated queries; lowest "
        f"bf16 recall@k vs plain bf16 {worst_rec:.4f}")
    seg_ids, k1 = subsets[0], k1s[-1]  # the cascade's stage 1 at rerank_factor 10
    (tk, tp, bnd), line = time_packed(
        torch, sq.packed_scan_args(m.plan, m.params, q, cache, k1, Metric.L2, seg_ids=seg_ids),
        f"L2 k={k1}")
    tag = f"SAQ uniform segments {seg_ids} k={k1}"
    r["times"][tag], r["bounds"][tag] = (tk, tp), bnd
    full = sq.packed_scan_args(m.plan, m.params, q, cache, k1, Metric.L2)
    log(f"[phase 15] {tag} times (CUDA events, median of 5): {line}; every segment "
        f"{cuda_ms(torch, lambda: pk.packed_scan_topk(**full)):.3f} ms, bound "
        f"{packed_bound(torch, full)[0]:.4f} ms")
    log(f"[phase 15] segment-subset checks ok ({time.perf_counter() - t0:.3f} s)")
    del codes, cache, norms, q
    torch.cuda.empty_cache()


def check_result(torch, ids, scores, nq, k, n, what):
    require(ids.shape == (nq, k) and scores.shape == (nq, k), f"{what}: result shape")
    require(bool(torch.isfinite(scores).all()) and int(ids.max()) < n and int(ids.min()) >= 0,
            f"{what}: result values")
    require(bool((torch.diff(scores, dim=1) >= 0).all()), f"{what}: not ascending")


def cascade(torch, dev, results, ctx, heads, rfs, path, profile, k=10):
    """The head-segment cascade on phase 7's SAQ index (N=1,048,576,
    D=1024, Q=256, k=10, bf16): recall@10 and ms beside the dense search;
    each (prune_segments, rerank_factor)'s stage-1 kernel call held against
    its plain version (``check_calls``); rerank_factor·k > 128 = the dense
    search bit for bit; the rerank = a plain f32 rescore of its
    candidates; a profile."""
    from vq_tpu_torch import Metric
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.kernels.topk import ordered_topk
    from vq_tpu_torch.methods import saq as sq

    saq, index, gt = ctx["saq"], ctx["index"], ctx["gt"]
    x, q = remake(torch, ctx["maker"], dev)
    del x
    codes, norms, cache, nq = index.codes, index.norms, index._scan_cache, q.shape[0]
    plan, params = saq.plan, saq.params

    def search(p=0, rf=10):
        return saq.scan_topk(q, codes, k, Metric.L2, norms=norms, use_bf16=True,
                             prune_segments=p, rerank_factor=rf, cache=cache)

    dense = search()
    ms_dense = cuda_ms(torch, search)
    rec_dense = recall(gt, dense[1].cpu(), k)
    log(f"[phase 15] SAQ dense search (plan bits {plan.seg_bits}, lens {plan.seg_lens}) Q={nq} "
        f"k={k}: {ms_dense:.3f} ms (CUDA events, median of 5), recall@{k} {rec_dense:.4f}")
    for p in heads:
        for rf in rfs:
            calls = []
            with counting(path) as got, recording(calls):
                s, i = search(p, rf)
                ms = cuda_ms(torch, lambda: search(p, rf))
            require_launches(got["packed_scan_topk"], 8, f"cascade p={p} rf={rf}: stage 1, "
                                                         f"8 searches")
            check_result(torch, i, s, nq, k, cache.num_rows, f"cascade p={p} rf={rf}")
            # stage 1 as the search called it (segment subset, k1, bf16, N=1M)
            # against its plain version: f32 ids where separated, bf16 recall
            held = check_calls(torch, calls, got, results, f"phase 15 cascade p={p} rf={rf}")
            log(f"[phase 15] cascade prune_segments={p} rerank_factor={rf} (k1={rf * k}): "
                f"{ms:.3f} ms/search (CUDA events, median of 5) against dense {ms_dense:.3f}, "
                f"ratio {ms / ms_dense:.3f}; recall@{k} {recall(gt, i.cpu(), k):.4f} against "
                f"dense {rec_dense:.4f}; stage 1 = its plain version: {held}")
            del calls
    p, rf = heads[0], 128 // k + 1
    wide = search(p, rf)
    require(torch.equal(wide[0], dense[0]) and torch.equal(wide[1], dense[1]),
            f"rerank_factor·k = {rf * k} > 128 must be the dense search bit for bit")
    # the rerank against a plain f32 rescore of the same candidates:
    # rows rebuilt by the full decode, scored by the direct difference
    rf = rfs[-1]
    head = tuple(range(p))
    s1, cand = sq._packed_scan(plan, params, q, cache, rf * k, Metric.L2, seg_ids=head)
    cand = cache.perm[cand.long()]
    alive = torch.isfinite(s1)
    q_sq = torch.sum(q * q, dim=1)
    rr = sq._saq_rerank(plan, params, q, codes, cand, alive, k, Metric.L2, norms=norms,
                        q_sq=q_sq)
    xh = saq.decompress(codes[cand.reshape(-1).long()]).reshape(nq, rf * k, -1)
    d2 = torch.sum((q[:, None, :] - xh) ** 2, dim=-1)
    d2 = torch.where(alive, d2, torch.full_like(d2, np.inf))
    ns, pos = ordered_topk(-d2, k)
    ref = (torch.gather(cand, 1, pos.long()).cpu().numpy(), (-ns).cpu().numpy())
    err, n_sep = where_separated(torch, q, float(torch.max(torch.sum(xh * xh, dim=-1))),
                                 ref, (rr[1].cpu().numpy(), rr[0].cpu().numpy()),
                                 f"cascade p={p} rf={rf} rerank vs a plain f32 rescore")
    log(f"[phase 15] rerank_factor·k = {128 // k + 1}·{k} > 128: = the dense search bit for "
        f"bit; the rerank (p={p}, k1={rf * k}) = a plain f32 rescore of its candidates by the "
        f"full decode where separated (max |Δscore| {err:.3e}, ids equal at {n_sep} separated "
        f"ranks)")
    if profile:
        a = sq.packed_scan_args(plan, params, q, cache, rf * k, Metric.L2, seg_ids=head)
        t1 = cuda_ms(torch, lambda: pk.packed_scan_topk(**a))
        t2 = cuda_ms(torch, lambda: sq._saq_rerank(plan, params, q, codes, cand, alive, k,
                                                   Metric.L2, norms=norms, q_sq=q_sq))
        _, rr_busy, rr_kernels, _, _ = profile_fn(torch, lambda: sq._saq_rerank(
            plan, params, q, codes, cand, alive, k, Metric.L2, norms=norms, q_sq=q_sq))
        wall, busy, kernels, per_kernel, _ = profile_fn(torch, lambda: search(p, rf))
        dwall, dbusy = profile_fn(torch, search)[:2]
        log(f"[profile] SAQ cascade p={p} rf={rf} Q={nq} k={k}: stage 1 kernel "
            f"(segments {head}, k1={rf * k}) {t1:.3f} ms; rerank {t2:.3f} ms (CUDA events, "
            f"median of 5), {rr_kernels:.0f} device kernels, device busy {rr_busy:.3f} ms; the "
            f"search: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
            f"{1 - busy / wall:.3f}, {kernels:.0f} device kernels (torch.profiler, 5 searches); "
            f"dense search wall {dwall:.3f} ms, busy {dbusy:.3f} ms, idle share "
            f"{1 - dbusy / dwall:.3f}")
        for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
            log(f"[profile] SAQ cascade   {ms:9.3f} ms/search  {name[:100]}")
    del q, cand, xh, d2


def coherent_queries(torch, x, asn, nq, cells, seed):
    """A coherent stream: ``cells`` cells drawn through seeded corpus rows;
    in each, one member row, the source of the cell's nq/cells queries,
    each perturbed by N(0, 0.05²/D) per dimension and unit-normalized:
    every query lies near one of ``cells`` rows, so a cell's queries probe
    nearly the same cells."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    n, d = x.shape
    picks = asn[torch.randint(0, n, (cells,), generator=g, device=x.device)]
    rows = []
    for c in picks.tolist():
        members = torch.nonzero(asn == c).reshape(-1)
        rows.append(members[torch.randint(0, members.shape[0], (1,), generator=g,
                                          device=x.device)])
    qc = x[torch.cat(rows).repeat_interleave(nq // cells)]
    qc = qc + (0.05 / d ** 0.5) * torch.randn(qc.shape, generator=g, device=x.device)
    return qc / torch.linalg.norm(qc, dim=1, keepdim=True)


def grouped_reference(torch, index, q, k, groups, nprobe, bf16=False):
    """Plain witness of a grouped search (f32 unless ``bf16``): the batch
    padded by its last query, sorted by nearest cell (stable), each group's
    own tile mask scanned by the gather kernel's plain version, un-permuted
    → ((ids, scores) as numpy, L2 ascending; Σ masked-in tiles)."""
    from vq_tpu_torch import Metric
    from vq_tpu_torch.index.ivf_packed import tile_mask_from_probes
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.kernels.kmeans import pairwise_sqdist_xc
    from vq_tpu_torch.kernels.topk import ordered_topk
    from vq_tpu_torch.methods import saq as sq

    nq = q.shape[0]
    ng = max(1, min(groups, nq))
    qp = torch.cat([q, q[-1:].expand((-nq) % ng, -1)])
    probe = ordered_topk(-pairwise_sqdist_xc(qp, index.centroids), nprobe)[1]
    order = torch.argsort(probe[:, 0], stable=True)
    ids = torch.empty((qp.shape[0], k), dtype=torch.int64, device=q.device)
    dist = torch.empty((qp.shape[0], k), device=q.device)
    tiles = 0
    saq = index.quantizer
    for g in order.reshape(ng, -1):
        mask = tile_mask_from_probes(probe[g], index.cl_first, index.cl_last,
                                     index.centroids.shape[0])
        tiles += int(mask.sum())
        a = sq.packed_scan_args(saq.plan, saq.params, qp[g], index.cache, k, Metric.L2,
                                use_bf16=bf16)
        s, pos = pk.packed_scan_topk_plain(**{**a, "tile_mask": mask})
        ids[g] = index.ids_sorted[pos.long()].long()
        dist[g] = torch.sum(qp[g] * qp[g], dim=1, keepdim=True) - s
    return (ids[:nq].cpu().numpy().astype(np.uint32), dist[:nq].cpu().numpy()), tiles


def query_groups(torch, dev, ctx, groups, nq_small, cells, path, nprobe=50, k=100,
                 profile=True):
    """Probe-coherent groups on phase 10's IVF-packed index: G in
    ``groups`` at Q = 256 and ``nq_small`` on phase 10's queries and on a
    coherent stream (queries near one row of each of ``cells`` cells); G=1
    = the ungrouped search bit for bit; recall ≥ the ceiling of per-query
    probing (against the full probe on the same codes); Σ tiles and ms per
    search, a profile at Q=256; each G > 1 as searched at Q=256 (bf16 on
    the card) = its per-group plain witness by recall and Σ tiles, and in
    f32 at Q=nq_small where separated."""
    import dataclasses as dc

    from vq_tpu_torch._device import bf16_supported
    from vq_tpu_torch.index.ivf_packed import tile_mask_from_probes
    from vq_tpu_torch.kernels.adc import _finalize, exact_topk
    from vq_tpu_torch.kernels.kmeans import pairwise_sqdist_xc
    from vq_tpu_torch.kernels.topk import ordered_topk

    index, x, asn, saq = ctx["index"], ctx["x"], ctx["asn"], ctx["saq"]
    index.ivf_cfg = dc.replace(index.ivf_cfg, nprobe=nprobe)
    metric, bf16 = index.search_cfg.metric, index.search_cfg.use_bf16
    bf16_here = bf16 and bf16_supported(dev)  # the index's rule: f32 on the CPU
    k_cl, nb = index.centroids.shape[0], index.cache.factors.shape[1] // 512
    nq_all = ctx["q"].shape[0]
    sets = {"phase 10 queries": (ctx["q"], ctx["gt"])}
    qc = coherent_queries(torch, x, asn, nq_all, cells, seed=23)
    sets[f"near {cells} rows"] = (qc, exact_topk(qc, x, k)[1].cpu().numpy())
    decode = decode_corpus(torch, saq, x)
    for name, (qs, gt) in sets.items():
        for nq in (qs.shape[0], nq_small):
            q = qs[:nq]
            # G=1 is the search as it was before groups: one mask, one pass
            probe = ordered_topk(-pairwise_sqdist_xc(q, index.centroids), nprobe)[1]
            mask = tile_mask_from_probes(probe, index.cl_first, index.cl_last, k_cl)
            s, pos = saq.packed_scan_raw(q, index.cache, k, metric, use_bf16=bf16_here,
                                         tile_mask=mask)
            ws, wi = _finalize(s, index.ids_sorted[pos.long()], metric, torch.sum(q * q, 1))
            s, pos = saq.packed_scan_raw(q, index.cache, k, metric, use_bf16=bf16_here)
            full = index.ids_sorted[pos.long()].long()
            ceiling = float((asn[full][..., None] == probe[:, None, :]).any(-1).float().mean())
            parts = []
            for g in groups:
                with counting(path) as got:
                    ids, scores = index.search_with_scores(q, k, query_groups=g)
                    tiles = index.last_tiles_scanned
                    ms = index.sustained_search_s(q, k, query_groups=g, reps=5, outer=3) * 1e3
                ng = min(g, nq)
                require_launches(got["packed_scan_topk_gather"], ng * (1 + 1 + 15),
                                 f"groups G={g}: one gather launch a group a search")
                check_result(torch, torch.as_tensor(ids.astype(np.int64)),
                             torch.as_tensor(scores), nq, k, index.num_rows,
                             f"{name} Q={nq} G={g}")
                if g == 1:
                    require(np.array_equal(ids, wi.cpu().numpy().astype(np.uint32)) and
                            np.array_equal(scores, ws.cpu().numpy()),
                            f"{name} Q={nq}: G=1 differs from the ungrouped search")
                rec_full = recall(full.cpu().numpy(), ids, k)
                require(rec_full >= ceiling - 1e-3, f"{name} Q={nq} G={g}: recall@{k} against "
                                                    f"the full probe {rec_full} < ceiling "
                                                    f"{ceiling}")
                held = ""
                if g > 1 and nq == qs.shape[0]:
                    # the search as run (bf16 on the card) against its
                    # per-group plain witness at the same precision
                    want, want_tiles = grouped_reference(torch, index, q, k, g, nprobe,
                                                         bf16=bf16_here)
                    require(tiles == want_tiles, f"{name} Q={nq} G={g}: Σ tiles {tiles} != "
                                                 f"{want_tiles}")
                    rec = recall(want[0], ids, k)
                    require(rec >= BF16_MIN_RECALL, f"{name} Q={nq} G={g}: recall@{k} against "
                                                    f"its per-group plain witness {rec}")
                    held = f", recall@{k} vs its plain witness {rec:.4f}"
                parts.append(f"G={g}: {ms:.3f} ms/search, QPS {nq / ms * 1e3:.1f}, Σ tiles "
                             f"{tiles} = {tiles / nb:.4f} of one dense pass, recall@{k} "
                             f"{recall(gt, ids, k):.4f} (vs the full probe {rec_full:.4f}"
                             f"{held})")
            log(f"[phase 15] groups, {name} Q={nq} nprobe={nprobe} k={k} (sustained, CUDA "
                f"events; per-query probe ceiling vs the full probe {ceiling:.4f}; G=1 = the "
                f"ungrouped search bit for bit): " + "; ".join(parts))
            if profile and nq == qs.shape[0]:
                for g in groups:
                    qg, ng, _ = index._grouped(q, g)
                    wall, busy, kernels, per_kernel, runtime = profile_fn(
                        torch, lambda: index._search(qg, k, nprobe, ng))
                    gather = sum(ms for kname, ms in per_kernel.items()
                                 if "packed_scan_kernel" in kname)
                    syncs = sum(c for rname, c in runtime.items() if "Synchronize" in rname)
                    log(f"[profile] query groups, {name} Q={nq} G={g}: wall {wall:.3f} ms, "
                        f"device busy {busy:.3f} ms (gather kernel {gather:.3f}), idle share "
                        f"{1 - busy / wall:.3f}, {kernels:.0f} device kernels, {syncs:.0f} "
                        f"synchronizations a search (torch.profiler, 5 searches)")
        q = qs[:nq_small]
        index.search_cfg = dc.replace(index.search_cfg, use_bf16=False)
        try:
            for g in groups[1:]:
                got = index.search_with_scores(q, k, query_groups=g)
                tiles = index.last_tiles_scanned
                want, want_tiles = grouped_reference(torch, index, q, k, g, nprobe)
                require(tiles == want_tiles, f"{name} G={g}: Σ tiles {tiles} != {want_tiles}")
                err, n_sep = where_separated(torch, q, max_sq_norm(torch, decode, want[0]),
                                             want, got, f"{name} Q={nq_small} G={g} f32 vs "
                                                        f"its per-group plain witness")
                log(f"[phase 15] groups, {name} Q={nq_small} G={g} f32 = its per-group plain "
                    f"witness where separated (max |Δscore| {err:.3e}, ids equal at {n_sep} "
                    f"separated ranks; Σ tiles {tiles})")
        finally:
            index.search_cfg = dc.replace(index.search_cfg, use_bf16=bf16)


def approx_searches(torch, dev, ctx4, ctx7, ctx10, path, shards=4):
    """SearchConfig(approx=True) = approx=False bit for bit: the PQ M=16 flat
    index at k=256 (the score kernel + the streaming top-k), SQ 8 bits
    through the generic scan, a sharded PQ index and the IVF-packed index."""
    import dataclasses as dc

    from vq_tpu_torch import SearchConfig, SQConfig
    from vq_tpu_torch.dist import ShardedFlatPQIndex, make_mesh
    from vq_tpu_torch.index.flat import FlatQuantizedIndex
    from vq_tpu_torch.methods.sq import SQ

    def same(index, q, k, what):
        cfg = index.search_cfg
        with counting(path):
            want = index.search_with_scores(q, k)
            index.search_cfg = dc.replace(cfg, approx=True)
            got = index.search_with_scores(q, k)
        index.search_cfg = cfg
        require(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]),
                f"{what}: approx=True differs from approx=False")
        return f"{what} k={k} Q={q.shape[0]}"

    done = []
    x, q = remake(torch, ctx4["maker"], dev)
    done.append(same(ctx4["index"], q, 256, "PQ M=16 flat"))
    sidx = ShardedFlatPQIndex(ctx4["pq"], SearchConfig(use_bf16=True),
                              make_mesh(devices=[dev] * shards)).fit(x)
    done.append(same(sidx, q, 10, f"sharded PQ M=16 P={shards}"))
    del x, sidx
    torch.cuda.empty_cache()
    x7, q7 = remake(torch, ctx7["maker"], dev)
    sq8 = FlatQuantizedIndex(SQ(SQConfig(8)), SearchConfig(use_bf16=True)).fit(x7)
    del x7
    done.append(same(sq8, q7, 10, "SQ 8 bits flat (generic scan)"))
    del sq8
    done.append(same(ctx10["index"], ctx10["q"], 100,
                     f"IVF-packed SAQ nprobe={ctx10['index'].ivf_cfg.nprobe}"))
    torch.cuda.empty_cache()
    log("[phase 15] approx=True = approx=False bit for bit (ids and scores): " + "; ".join(done))


def phase_search_options(torch, dev, results, ctx4, ctx7, ctx10, n=100_000, d=1024, nq=256,
                         heads=(1, 2), k1s=(50, 100), rfs=(5, 10), groups=(1, 4, 16),
                         nq_small=64, cells=8, nprobe=50, profile=True):
    """This slice's options (module docstring): the packed kernel on segment
    subsets against its plain version, the SAQ head-segment cascade, the
    probe-coherent query groups and ``approx``.  Returns the launches of
    the cascade's, the groups' and the approx searches, by kernel."""
    t0 = time.perf_counter()
    path = dict.fromkeys(KERNELS, 0)
    subset_kernel(torch, dev, results, n, d, nq, heads, k1s)
    cascade(torch, dev, results, ctx7, heads, rfs, path, profile)
    query_groups(torch, dev, ctx10, groups, nq_small, cells, path, nprobe, profile=profile)
    approx_searches(torch, dev, ctx4, ctx7, ctx10, path)
    log(f"[phase 15] launches of the search options' searches: {path} "
        f"({time.perf_counter() - t0:.3f} s)")
    require_launched({name: path[name] for name in ("packed_scan_topk",
                                                    "packed_scan_topk_gather")},
                     "the search options never launched the packed or the gather kernel")
    return path


# ---------------------------------------------------------------- phase 14
# The H100 machine this script is run on has pandas and yaml but no
# matplotlib (`import matplotlib` fails there).  So `study` runs on the card
# (without --plot it needs only pandas) and `plot` does not; the CPU tests
# run both.
PLOT_ON_CARD = False
# the query count of ``load_planted_dataset`` (and so of ``get_dataset``'s
# planted-NxD): the direct build draws the same rows and queries
PLANTED_QUERIES = 1024


def harness_steps(tmp, device, n, d, nq, n_gate, n_stream, clusters, nprobe, plot):
    """Phase 14's CLI steps in order: (name, argv of ``vq_tpu_torch.cli.main``,
    the kernels the step must launch on the card).  ``tmp`` holds the runs
    database, the outputs and the study's fvecs files."""
    big, db, dv = f"planted-{n}x{d}", ["--db-path", os.path.join(tmp, "runs.db")], [
        "--device", device]
    steps = [
        ("precompute-gt", ["precompute-gt", "--dataset", big, "--k", "100", "--output",
                           os.path.join(tmp, "gt.npy"), *dv], ()),
        ("run PQ M=16 k=256", ["run", "--dataset", big, "--method", "pq", "--param", "M=16",
                               "--k", "256", "--num-queries", str(nq), *db, *dv],
         ("pq_scan_topk_fused", "pq_score_all")),
        ("sweep PQ M=16 + SAQ bpd=2", ["sweep", "--dataset", big, "--methods", "pq", "saq",
                                       "--pq-subquantizers", "16", "--bpd", "2", "--k", "10",
                                       "--num-queries", str(nq), *db, *dv],
         ("pq_scan_topk_fused", "packed_scan_topk")),
        ("ivf-bench", ["ivf-bench", "--dataset", big, "--methods", "saq_ivf_packed", "pq_flat",
                       "--bpd", "1", "--num-clusters", str(clusters), "--nprobe", str(nprobe),
                       "--k", "100", "--output", os.path.join(tmp, "ivf", "ivf.csv"), *dv],
         ("packed_scan_topk_gather", "pq_scan_topk_fused")),
        ("streaming-sweep", ["streaming-sweep", "--dataset", f"dummy-{n_stream}x{d}",
                             "--methods", "pq", "--train-size", str(n_stream // 4),
                             "--batch-size", str(n_stream // 4), *db, *dv], ()),
        (f"run PQ M={d // 8}", ["run", "--dataset", f"planted-{n_gate}x{d}", "--method", "pq",
                                "--param", f"M={d // 8}", "--k", "10", "--num-queries",
                                str(nq), *db, *dv], ("pq_scan_topk_fused",)),
        ("study", ["study", "--base", os.path.join(tmp, "base.fvecs"), "--queries",
                   os.path.join(tmp, "query.fvecs"), "--methods", "pq", "ours", "saq_paper",
                   "--bpd", "1,2", "--output-dir", os.path.join(tmp, "study"), *dv],
         ("packed_scan_topk",)),
    ]
    if plot:
        steps.append(("plot", ["plot", *db, "--output-dir", os.path.join(tmp, "plots")], ()))
    return steps


def read_csv(directory):
    """The rows of the one CSV file in ``directory``."""
    import csv

    (name,) = [f for f in os.listdir(directory) if f.endswith(".csv")]
    with open(os.path.join(directory, name), newline="") as f:
        return list(csv.DictReader(f))


def harness_profile(torch, dev, n, d, nq, profile):
    """The sweep's PQ M=16 configuration on planted-{n}x{d}, through the
    harness's own functions, ``get_dataset`` and
    ``bench/sweep.py::run_single_config``, their callees timed to a
    synchronised end by shims for this one call (``[profile] harness``
    lines); with ``profile``, each callee under torch.profiler (device
    activity only), which also counts its host→card copies: it records the
    256 MB chunks that compress streams, but not always a whole 6.1 GB
    corpus copied in one piece, whose time the lone copy's line gives on
    the host clock.  Returns the dataset, the call's metrics and that lone
    copy (the corpus on the card)."""
    from unittest import mock

    from vq_tpu_torch.bench import sweep
    from vq_tpu_torch.data import datasets

    rows, build, flat = [], sweep.build_quantizer, sweep.FlatQuantizedIndex

    def step(name, fn):
        copies = ""
        if profile:
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as prof_ctx

            with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
                out, s = wall_s(torch, fn)
            h2d = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name.startswith("Memcpy HtoD")]
            copies = (f"; torch.profiler recorded {len(h2d)} host→card copies, "
                      f"{sum(e.device_time for e in h2d) / 1e3:.3f} ms on the card")
        else:
            out, s = wall_s(torch, fn)
        rows.append((name, s))
        log(f"[profile] harness {name}: {s:.3f} s{copies}")
        return out

    def timed(name, f):
        return lambda *a, **kw: step(name, lambda: f(*a, **kw))

    def quantizer(*a, **kw):
        model = build(*a, **kw)
        model.fit = timed("fit", model.fit)
        return model

    searches = []

    def index(*a, **kw):
        idx = flat(*a, **kw)
        idx.fit = timed("index fit (compress + norms)", idx.fit)
        search = idx.search_with_scores

        def first_search(queries, k=10):  # the recall search; measure_qps's are one step
            searches.append(k)
            if len(searches) > 1:
                return search(queries, k=k)
            return step(f"recall search k={k}", lambda: search(queries, k=k))
        idx.search_with_scores = first_search
        return idx

    shims = {(datasets, "planted_arrays"): timed("dataset generation (planted_arrays on the "
                                                  "card)", datasets.planted_arrays),
             (datasets, "compute_ground_truth"): timed(
                 "ground truth (corpus host→card + exact scan)", datasets.compute_ground_truth),
             (sweep, "build_quantizer"): quantizer, (sweep, "FlatQuantizedIndex"): index,
             (sweep, "time_compress"): timed("compress (time_compress)", sweep.time_compress),
             (sweep, "time_decompress"): timed("decompress sample (time_decompress)",
                                               sweep.time_decompress),
             (sweep, "measure_qps"): timed("measure_qps k=10 (1 + 3 searches)",
                                           sweep.measure_qps)}
    for fn in ("compute_distortion", "reconstruction_mse", "compute_pairwise_distortion",
               "compute_rank_distortion", "recall_at_k"):
        shims[(sweep, fn)] = timed(f"host metric {fn}", getattr(sweep, fn))
    with contextlib.ExitStack() as stack:
        for (mod, name), shim in shims.items():
            stack.enter_context(mock.patch.object(mod, name, shim))
        data, s = wall_s(torch, lambda: datasets.get_dataset(f"planted-{n}x{d}", device=dev))
        rest = s - sum(t for _, t in rows)
        rows.append(("card→host copy (the rest of get_dataset)", rest))
        log(f"[profile] harness card→host copy of the corpus (the rest of get_dataset): "
            f"{rest:.3f} s")
        metrics = sweep.run_single_config(data, "pq", {"M": 16}, k=10, num_queries=nq,
                                          log=False, device=dev)
    total = sum(s for _, s in rows)
    host = sum(s for name, s in rows if name.startswith("host metric"))
    x_dev = step("one host→card copy of the corpus alone",
                 lambda: torch.from_numpy(data.vectors).to(dev))
    log(f"[profile] harness host metrics in all: {host:.3f} s; get_dataset + "
        f"run_single_config(pq, M=16) on {data.name}: {total:.3f} s in all")
    return data, metrics, x_dev


def direct_recall(torch, dev, data, nq):
    """recall@10 of a FlatQuantizedIndex(PQ M=16, B=8, seed 0) built on
    ``data`` without the harness, searched at k=100 as the sweep's recall
    search is."""
    from vq_tpu_torch import Metric, PQConfig, SearchConfig
    from vq_tpu_torch.index.flat import FlatQuantizedIndex
    from vq_tpu_torch.methods.pq import PQ
    from vq_tpu_torch.metrics import recall_at_k

    index = FlatQuantizedIndex(PQ(PQConfig(num_subquantizers=16), seed=0, device=dev),
                               SearchConfig(metric=Metric.L2, use_bf16=True)).fit(data.vectors)
    ids, _ = index.search_with_scores(data.queries[:nq], k=100)
    return recall_at_k(data.ground_truth[:nq], ids, 10)


def check_gt_sample(torch, x, queries, saved, every=16):
    """The saved ground truth (L2 top-k ids, best first) of every
    ``every``-th query against a plain f32 ``torch.cdist`` over the rows
    ``x`` (on the card): ids equal at every rank whose squared distance is
    separated from its neighbours' by more than the f32 tolerance.  Returns
    (queries checked, separated ranks)."""
    qs = torch.from_numpy(np.ascontiguousarray(queries[::every])).to(x.device)
    d2 = torch.cdist(qs, x) ** 2
    s, ids = torch.topk(d2, saved.shape[1], dim=1, largest=False)
    got = torch.from_numpy(saved[::every].astype(np.int64)).to(x.device)
    x_sq_max = float(torch.linalg.vector_norm(x, dim=1).max()) ** 2
    _, sep = where_separated(torch, qs, x_sq_max, (ids.cpu().numpy(), s.cpu().numpy()),
                             (got.cpu().numpy(), d2.gather(1, got).cpu().numpy()),
                             "precompute-gt against torch.cdist")
    return qs.shape[0], sep


WRAPPERS = ("pq_scan_topk_fused", "pq_score_all", "packed_scan_topk")


@contextlib.contextmanager
def recording(calls: list):
    """Within the block, each call of a kernel wrapper (``WRAPPERS``) from
    another module of the port is appended to ``calls`` as (wrapper name,
    its arguments by name, defaults filled in), then runs as before (the
    wrapper counts its own launches).  The callers bind the wrappers by
    name at import, so each such binding is swapped for the block."""
    import importlib
    import inspect

    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.kernels import pq_scan as ps

    for name in ("kernels.adc", "methods.saq", "methods.rabitq", "methods.rankaware"):
        importlib.import_module(f"vq_tpu_torch.{name}")
    wrappers = {id(getattr(mod, name)): getattr(mod, name)
                for mod, name in ((ps, WRAPPERS[0]), (ps, WRAPPERS[1]), (pk, WRAPPERS[2]))}

    def shim(f):
        sig = inspect.signature(f)

        def call(*a, **kw):
            bound = sig.bind(*a, **kw)
            bound.apply_defaults()
            calls.append((f.__name__, dict(bound.arguments)))
            return f(*a, **kw)
        return call

    swapped = []
    for name, mod in list(sys.modules.items()):
        if not name.startswith("vq_tpu_torch.") or mod in (pk, ps):
            continue
        for attr, val in list(vars(mod).items()):
            if id(val) in wrappers and wrappers[id(val)] is val:
                swapped.append((mod, attr, val))
                setattr(mod, attr, shim(val))
    try:
        yield calls
    finally:
        for mod, attr, val in swapped:
            setattr(mod, attr, val)


def call_kernel(name, a) -> str:
    """The kernel a recorded wrapper call launches (``KERNELS``)."""
    if name == "packed_scan_topk" and a["tile_mask"] is not None:
        return "packed_scan_topk_gather"
    return name


def call_shape(name, a) -> str:
    """A recorded call's shapes and options; calls alike in these are
    checked once."""
    if name == "packed_scan_topk":
        segs = " ".join(f"({s.bits},{s.ln},{s.dequant})" for s in a["segs"])
        return (f"{call_kernel(name, a)} Q={a['q_cat'].shape[0]} D={a['q_cat'].shape[1]} "
                f"N={a['factors'].shape[1]} k={a['k']} {a['metric_kind']} {a['family']} "
                f"{'bf16' if a['use_bf16'] else 'f32'} prune={a['prune']} segments {segs}")
    m, kk, dsub = a["codebooks"].shape
    return (f"{name} Q={a['queries'].shape[0]} N={a['codes'].shape[0]} M={m} K={kk} "
            f"dsub={dsub} k={a.get('k', 0)} l2={a['l2']} limit={a.get('limit')} "
            f"{'bf16' if a['use_bf16'] else 'f32'}")


def check_call(torch, name, a, what) -> float:
    """One recorded wrapper call again, held against its plain version on
    the same inputs as phases 3, 6 and 9 hold the kernels: in f32, scores
    within the tolerance and ids equal where separated; in bf16 as called,
    PQ scores within the tolerance of the plain bf16 version's, packed
    recall@k ≥ BF16_MIN_RECALL against it.  Returns the largest f32 score
    error."""
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.kernels import pq_scan as ps

    def floor(s):  # -inf (fewer than k rows in reach) compares as a number
        return torch.clamp(s, min=-1e30)

    if name == "pq_score_all":
        q, codes, cb = a["queries"], a["codes"], a["codebooks"]
        tol = f32_tol(torch, q.float(), cb)
        return max(check_scores(torch, ps.pq_score_all(**{**a, "use_bf16": bf16}),
                                ps.pq_score_all_plain(q, codes, cb, a["l2"], bf16), tol,
                                f"{what} {'bf16' if bf16 else 'f32'}")
                   for bf16 in {False, a["use_bf16"]})
    if name == "pq_scan_topk_fused":
        q, codes, cb, k = a["queries"], a["codes"], a["codebooks"], a["k"]
        tol = f32_tol(torch, q.float(), cb)
        ks, ki = ps.pq_scan_topk_fused(**{**a, "use_bf16": False})
        rs, ri = ps.pq_scan_topk_fused_plain(q, codes, cb, k + 1, a["l2"], a["limit"], False)
        err = check_topk_f32(torch, floor(ks), ki, floor(rs), ri, k, tol, f"{what} f32")[0]
        if a["use_bf16"]:
            bs = ps.pq_scan_topk_fused(**a)[0]
            check_scores(torch, floor(bs), floor(ps.pq_scan_topk_fused_plain(**a)[0]), tol,
                         f"{what} bf16")
        return err
    k, mask = a["k"], a["tile_mask"]
    lim = min(a["factors"].shape[1], a["limit"] or a["factors"].shape[1])
    af = {**a, "use_bf16": False}
    ks, ki = pk.packed_scan_topk(**af)[:2]
    rs, ri = pk.packed_scan_topk_plain(**{**af, "k": k + 1})[:2]
    reach = torch.isfinite(ks)
    require(bool(((ki < lim) | ~reach).all()), f"{what}: ids past the limit")
    if mask is not None:
        require(bool(((mask[ki.long() // 512] != 0) | ~reach).all()),
                f"{what}: ids outside the masked-in tiles")
    err = check_topk_f32(torch, floor(ks), ki, floor(rs), ri, k, packed_tol(torch, af),
                         f"{what} f32")[0]
    if a["use_bf16"]:
        ki, pi = pk.packed_scan_topk(**a)[1].cpu(), pk.packed_scan_topk_plain(**a)[1].cpu()
        kk = min(k, lim)
        rec = recall(pi, ki, kk)
        require(rec >= BF16_MIN_RECALL, f"{what} bf16: recall@{kk} {rec} against the plain "
                                        f"bf16 version < {BF16_MIN_RECALL}")
    return err


def check_calls(torch, calls, got, results, what) -> str:
    """The wrapper calls a step made (``recording``): one per launch its
    counters saw (``got``), and each distinct ``call_shape`` held against
    its plain version (``check_call``), outside the step's count.  The
    largest f32 error joins the kernel's in ``results``.  Returns a line."""
    made = dict.fromkeys(KERNELS, 0)
    for name, a in calls:
        made[call_kernel(name, a)] += 1
    for kernel in KERNELS:
        require_launches(got[kernel], made[kernel], f"{what}: {kernel} launches vs its "
                                                    f"wrapper's recorded calls")
    seen, errs = {}, {}
    for name, a in calls:
        shape = call_shape(name, a)
        seen[shape] = seen.get(shape, 0) + 1
        if seen[shape] == 1:
            errs[shape] = check_call(torch, name, a, f"{what} {shape}")
            r = results.setdefault(call_kernel(name, a),
                                   {"max_abs_err": 0.0, "times": {}, "bounds": {}})
            r["max_abs_err"] = max(r["max_abs_err"], errs[shape])
    torch.cuda.synchronize()
    return "; ".join(f"{shape} called {seen[shape]}×, f32 max_abs_err {err:.3e}"
                     for shape, err in errs.items())


def phase_harness(torch, dev, results=None, n=1_000_000, d=1536, nq=1024, n_gate=100_000,
                  n_stream=262_144, n_sub=20_000, clusters=4096, nprobe=50,
                  plot=PLOT_ON_CARD, profile=True):
    """The harness and CLI (``vq_tpu_torch.cli.main``) in this process on
    ``dev``, step by step (``harness_steps``), each step's rows read back,
    its kernels required and every kernel call it made held against its
    plain version at the step's shapes (``check_calls``, its f32 errors
    joining ``results``); the sweep's PQ M=16 configuration run once more
    outside the CLI (``harness_profile``) and a FlatQuantizedIndex built
    on the same dataset without the harness (``direct_recall``), whose
    recall the logged ones must equal bit for bit; then ``python -m
    vq_tpu_torch`` in a subprocess.  Returns the launches of the CLI
    steps, by kernel."""
    import shutil

    from vq_tpu_torch.cli import main as cli
    from vq_tpu_torch.data.datasets import planted_arrays
    from vq_tpu_torch.data.io import write_fvecs
    from vq_tpu_torch.utils.run_logger import load_runs

    results = {} if results is None else results
    tmp, t0 = tempfile.mkdtemp(prefix="vq_harness_"), time.perf_counter()
    try:
        data, mets_profiled, x_dev = harness_profile(torch, dev, n, d, nq, profile)
        want_recall = direct_recall(torch, dev, data, nq)
        require(mets_profiled["recall@10"] == want_recall,
                f"phase 14: run_single_config's recall@10 {mets_profiled['recall@10']!r} != "
                f"the direct index's {want_recall!r}")
        log(f"[phase 14] direct FlatQuantizedIndex(PQ M=16) on {data.name}: recall@10 "
            f"{want_recall!r} = run_single_config's")
        xg, qg = planted_arrays(n_gate, d, PLANTED_QUERIES, device=dev)
        write_fvecs(os.path.join(tmp, "base.fvecs"), xg.cpu().numpy())
        write_fvecs(os.path.join(tmp, "query.fvecs"), qg.cpu().numpy())
        del xg, qg
        db = os.path.join(tmp, "runs.db")
        path, seen = {}, 0
        for name, argv, kernels in harness_steps(tmp, str(dev), n, d, nq, n_gate, n_stream,
                                                 clusters, nprobe, plot):
            calls = []
            with counting(path) as got, recording(calls):
                _, s = wall_s(torch, lambda: cli(argv))
            runs = load_runs(db_path=db) if os.path.exists(db) else []
            new, seen = runs[seen:], len(runs)
            if kernels:
                require_launched({k: got[k] for k in kernels}, f"phase 14 {name}: kernels")
            mets = [r["metrics"] for r in new]
            if name == "precompute-gt":
                saved = np.load(os.path.join(tmp, "gt.npy"))
                require(np.array_equal(saved, data.ground_truth),
                        "precompute-gt differs from the Dataset's ground truth")
                nq_gt, sep = check_gt_sample(torch, x_dev, data.queries, saved)
                del x_dev
                shown = (f"({saved.shape[0]}, {saved.shape[1]}) ids = the Dataset's; = "
                         f"torch.cdist's at {sep} separated ranks of {nq_gt} sampled queries")
            elif name.startswith("run") or name.startswith("sweep"):
                require(len(new) == (2 if name.startswith("sweep") else 1)
                        and all(r["dataset"].startswith("planted-") for r in new),
                        f"phase 14 {name}: rows {[(r['method'], r['dataset']) for r in new]}")
                require(all(np.isfinite(m["recall@10"]) and m["qps"] > 0 for m in mets),
                        f"phase 14 {name}: metrics")
                if "M=16" in name:  # the harness adds nothing to the direct build's result
                    require(mets[0]["recall@10"] == want_recall,
                            f"phase 14 {name}: logged recall@10 {mets[0]['recall@10']!r} != "
                            f"the direct index's {want_recall!r}")
                if name == f"run PQ M={d // 8}":
                    require(mets[0]["recall@10"] >= RECALL_GATE_PQ192_FLOOR,
                            f"recall gate {mets[0]['recall@10']} < {RECALL_GATE_PQ192_FLOOR}")
                shown = "; ".join(
                    f"{r['method']} {r['config']}: QPS {m['qps']:.1f}, recall@10 "
                    f"{m['recall@10']:.4f}" + (f", recall@100 {m['recall@100']:.4f}"
                                               if "recall@100" in m else "")
                    + f", MSE {m['mse']:.4e}, compression {m['compression_ratio']:.1f}x, "
                    f"fit {m['fit_time_s']:.3f} s, compress {m['compress_time_s']:.3f} s"
                    for r, m in zip(new, mets))
            elif name == "ivf-bench":
                rows = read_csv(os.path.join(tmp, "ivf"))
                require(len(rows) == 2 and all(r["error"] == "" for r in rows),
                        f"ivf-bench rows: {[(r['method'], r['error']) for r in rows]}")
                shown = "; ".join(
                    f"{r['method']} bpd {r['bpd']}: QPS {float(r['qps']):.1f}, recall@100 "
                    f"{float(r['recall@100']):.4f}, build {float(r['build_time_s']):.3f} s, "
                    f"{int(r['memory_bytes']) / 1e6:.1f} MB" for r in rows)
            elif name == "streaming-sweep":
                (m,) = mets
                require(new[0]["dataset"] == f"dummy-{n_stream}x{d}-streaming"
                        and m["streamed_vectors"] == n_stream and 0 < m["mse"] < np.inf,
                        f"streaming row: {new[0]['dataset']} {m}")
                shown = (f"pq {new[0]['config'] or 'defaults'}: {m['streamed_vectors']} rows, "
                         f"encode {m['encode_vecs_per_s']:.0f} rows/s, MSE {m['mse']:.4e}, "
                         f"compression {m['compression_ratio']:.1f}x, fit {m['fit_time_s']:.3f} s")
            elif name == "study":
                rows = read_csv(os.path.join(tmp, "study"))
                require(len(rows) == 6 and all(0 <= float(r["recall@10"]) <= 1 for r in rows),
                        f"study rows: {rows}")
                shown = "; ".join(f"{r['method']} bpd {r['bpd']}: recall@10 "
                                  f"{float(r['recall@10']):.4f}, MSE {float(r['mse']):.3e}, "
                                  f"{float(r['code_bytes']):.0f} code bytes" for r in rows)
            else:  # plot
                shown = f"{len(os.listdir(os.path.join(tmp, 'plots')))} files"
                require(shown == "7 files", f"plot wrote {shown}")
            log(f"[harness] {name}: {s:.3f} s; {shown}; launches {got}")
            if calls:
                t1 = time.perf_counter()
                line = check_calls(torch, calls, got, results, f"phase 14 {name}")
                log(f"[harness] {name}: kernels vs plain at the step's shapes "
                    f"({time.perf_counter() - t1:.3f} s, outside the step's count): {line}")
            del calls
        if not plot:
            log("[harness] plot: not run (matplotlib is not installed on this machine)")
        out, s = wall_s(torch, lambda: subprocess.run(
            [sys.executable, "-m", "vq_tpu_torch", "run", "--dataset", f"dummy-{n_sub}x128",
             "--method", "sq", "--num-queries", "100", "--db-path", os.path.join(tmp, "sub.db"),
             "--device", str(dev)], cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300))
        require(out.returncode == 0, f"python -m vq_tpu_torch: {out.stderr[-2000:]}")
        m = json.loads(out.stdout)
        log(f"[harness] python -m vq_tpu_torch run sq on dummy-{n_sub}x128 (subprocess): "
            f"{s:.3f} s; QPS {m['qps']:.1f}, recall@10 {m['recall@10']:.4f}, MSE "
            f"{m['mse']:.4e}, compression {m['compression_ratio']:.1f}x")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[phase 14] launches of the CLI steps: {path}; the phase took "
        f"{time.perf_counter() - t0:.1f} s")
    return path


# ---------------------------------------------------------------- phase 16
RANKS_TIMEOUT_S = 240.0  # a spawned group's waits, and the join of its ranks


def ranks_spec(torch, tmp, ctx4, ctx7, ctx10, nprobe=50) -> dict:
    """What phase 16 rebuilds in each of its processes: phases 4, 7 and 10's
    fits saved to ``tmp`` (the quantizers by ``save``, the coarse pass by
    ``torch.save``), their configurations and each corpus's maker."""
    ctx4["pq"].save(os.path.join(tmp, "pq.pkl"))
    ctx7["saq"].save(os.path.join(tmp, "saq7.pkl"))
    ctx10["saq"].save(os.path.join(tmp, "saq10.pkl"))
    torch.save({"cents": ctx10["cents"].cpu(), "asn": ctx10["asn"].cpu()},
               os.path.join(tmp, "coarse.pt"))
    ivf = ctx10["index"]
    # the ranks split host work over as many threads as this process, so
    # their CPU sums split alike
    return dict(tmp=tmp, device=str(ctx10["cents"].device), threads=torch.get_num_threads(),
                pq=(ctx4["pq"].cfg, ctx4["maker"], ctx4["index"].search_cfg),
                saq=(ctx7["saq"].cfg, ctx7["maker"], ctx7["index"].search_cfg),
                ivf=(ctx10["saq"].cfg, ctx10["maker"],
                     dataclasses.replace(ivf.ivf_cfg, nprobe=nprobe), ivf.search_cfg))


def ranks_program(torch, dev, spec, mesh, parts) -> dict:
    """Phase 16's work on ``mesh``, the same in the parent (one process) and
    in each rank: the parent's fits loaded, each index built by ``fit`` on
    its corpus remade from its seed, then searched.  Returns the results
    ({search: (ids, scores)}, and two dp_lloyd_step runs) and, by search,
    the launches of one search, its ms (median of 3, host clock, after the
    counted one), each index's footprint and the merge's ms (``_fold``:
    the all-gather and the ordered top-k, median of 5)."""
    from vq_tpu_torch.dist import ShardedFlatPQIndex, ShardedIvfPackedIndex
    from vq_tpu_torch.dist import ShardedPackedFlatIndex
    from vq_tpu_torch.dist.sharded import _fold, dp_lloyd_step
    from vq_tpu_torch.index.ivf import coarse_sample
    from vq_tpu_torch.methods.pq import PQ
    from vq_tpu_torch.methods.saq import SAQ

    tmp = spec["tmp"]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = dict(results={}, launches={}, ms={}, footprint={}, merge_ms={})

    def host_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    def searches(name, index, q, ks):
        out["footprint"][name] = index.memory_footprint()
        for k in ks:
            what = f"{name} k={k}"
            with counting({}) as got:
                out["results"][what] = index.search_with_scores(q, k)
            out["launches"][what] = got
            out["ms"][what] = host_ms(lambda: index.search_with_scores(q, k))

    if "pq" in parts:
        cfg, maker, search_cfg = spec["pq"]
        x, q = remake(torch, maker, dev)
        pq = PQ(cfg, device=dev).load(os.path.join(tmp, "pq.pkl"))
        searches("PQ M=16", ShardedFlatPQIndex(pq, search_cfg, mesh).fit(x), q, (10, 100, 256))
        for k in (10, 100):
            blocks = mesh.each(lambda p, k=k: (
                torch.randn((q.shape[0], k), device=dev),
                torch.randint(0, 1 << 20, (q.shape[0], k), device=dev, dtype=torch.int32)))
            _fold(mesh, None, blocks, k)
            out["merge_ms"][f"Q={q.shape[0]} k={k}"] = host_ms(
                lambda: _fold(mesh, None, blocks, k), reps=5)
        del x
    if "saq" in parts:
        cfg, maker, search_cfg = spec["saq"]
        x, q = remake(torch, maker, dev)
        saq = SAQ(cfg, device=dev).load(os.path.join(tmp, "saq7.pkl"))
        searches("SAQ bpd=2", ShardedPackedFlatIndex(saq, search_cfg, mesh).fit(x), q, (10, 100))
        del x
    if "ivf" in parts:
        cfg, maker, ivf_cfg, search_cfg = spec["ivf"]
        x, q = remake(torch, maker, dev)
        saq = SAQ(cfg, device=dev).load(os.path.join(tmp, "saq10.pkl"))
        coarse = torch.load(os.path.join(tmp, "coarse.pt"))
        cents, asn = coarse["cents"].to(dev), coarse["asn"].to(dev)
        index = ShardedIvfPackedIndex(saq, ivf_cfg, search_cfg, mesh).fit(x, coarse=(cents, asn))
        searches(f"IVF-packed SAQ nprobe={ivf_cfg.nprobe}", index, q, (100,))
        del index
        xs = coarse_sample(x, ivf_cfg.kmeans, cents.shape[0], dev)  # the coarse pass's rows
        xs = xs[: xs.shape[0] // mesh.size * mesh.size]
        out["results"]["dp_lloyd_step"] = tuple(dp_lloyd_step(mesh, xs, cents).cpu().numpy()
                                                for _ in range(2))
        del x, xs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def ranks_main(rank: int, world: int, spec: dict, backend: str, env: dict) -> None:
    """A spawned rank of phase 16: joins its group through
    ``maybe_init_distributed`` (gloo: a file rendezvous in the phase's
    directory; NCCL: ``env://`` from ``env``, card ``cuda:<rank>``), runs
    ``ranks_program`` on a mesh of its ``shards_per_rank`` shards on its
    device and saves what it returned, with the backend, the exchanges the
    mesh's collectives made through torch.distributed and the rank's
    shards."""
    import torch

    from vq_tpu_torch.dist import make_mesh, maybe_init_distributed

    os.environ.update(env, LOCAL_RANK=str(rank))  # VQ_DIST_INIT=1, the NCCL rendezvous
    torch.set_num_threads(spec["threads"])
    # gloo ranks share the card; NCCL refuses that, so an NCCL rank has its own
    dev = torch.device("cuda", rank) if backend == "nccl" else torch.device(spec["device"])
    maybe_init_distributed(backend, device=dev, rank=rank, world_size=world,
                           init_method=None if backend == "nccl" else
                           f"file://{spec['tmp']}/rendezvous-{backend}",
                           timeout_s=RANKS_TIMEOUT_S)
    mesh = make_mesh(devices=[dev] * spec["shards_per_rank"])
    out = ranks_program(torch, dev, spec, mesh, spec["parts"])
    out.update(backend=mesh.ranks.backend, exchanges=mesh.ranks.exchanges,
               local=mesh.local_shards)
    torch.save(out, os.path.join(spec["tmp"], f"{backend}-rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def spawn_ranks(torch, spec, world, backend, env) -> list:
    """``world`` ranks of ``ranks_main``, started by ``spawn`` and joined
    within RANKS_TIMEOUT_S; a rank still running then is killed, and the
    phase fails unless every rank ended with 0.  Returns what each saved."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ranks_main, args=(r, world, spec, backend, env))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join()
    require(not hung, f"phase 16 {backend} ranks {hung} still ran after {RANKS_TIMEOUT_S} s "
                      "(killed)")
    codes = [p.exitcode for p in procs]
    require(codes == [0] * world, f"phase 16 {backend} ranks' exit codes {codes}")
    return [torch.load(os.path.join(spec["tmp"], f"{backend}-rank{r}.pt"), weights_only=False)
            for r in range(world)]


def hold_ranks(one, ranks, shards, backend) -> dict:
    """Each rank's results against the one-process mesh's bit for bit, its
    footprints equal, its launches a search its share of the one-process
    search's (local shards of ``shards``), its collectives gone through
    torch.distributed; logs each search's ms beside the one-process mesh's.
    Returns the ranks' launches summed, by kernel."""
    total = dict.fromkeys(KERNELS, 0)
    for r, got in enumerate(ranks):
        tag = f"{backend} rank {r} of {len(ranks)} ({len(got['local'])} of {shards} shards)"
        require(got["backend"] == backend and got["exchanges"] > 0,
                f"{tag}: {got['exchanges']} exchanges through {got['backend']}")
        for what, want in one["results"].items():
            if what in got["results"]:
                res = got["results"][what]
                require(len(res) == len(want) and all(
                    a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(res, want)),
                    f"{tag}: {what} differs from the one-process mesh's")
        for name, nbytes in got["footprint"].items():
            require(nbytes == one["footprint"][name],
                    f"{tag}: {name} footprint {nbytes} != {one['footprint'][name]}")
        for what, counts in got["launches"].items():
            for kernel, n in counts.items():
                require_launches(n * shards, one["launches"][what][kernel] * len(got["local"]),
                                 f"{tag} {what} {kernel} (× {shards} shards / local shards)")
                total[kernel] += n
            log(f"[phase 16] {tag} {what}: {got['ms'][what]:.3f} ms/search (one process, "
                f"{shards} shards: {one['ms'][what]:.3f}); launches "
                f"{ {kernel: n for kernel, n in counts.items() if n} }")
        for what, ms in got["merge_ms"].items():
            log(f"[phase 16] {tag} merge (_fold) {what}: {ms:.3f} ms (one process: "
                f"{one['merge_ms'][what]:.3f}; host clock, median of 5)")
    return total


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_ranks(torch, dev, spec, shards=4, world=2) -> dict:
    """Phase 16 (module docstring) → the launches of the gloo ranks' and of
    the NCCL rank's searches, by path.  Runs last: the parent never joins a
    process group."""
    from vq_tpu_torch.dist import make_mesh

    t0 = time.perf_counter()
    one = ranks_program(torch, dev, spec, make_mesh(devices=[dev] * shards),
                        ("pq", "saq", "ivf"))
    want = {"PQ M=16 k=10": "pq_scan_topk_fused", "PQ M=16 k=100": "pq_scan_topk_fused",
            "PQ M=16 k=256": "pq_score_all", "SAQ bpd=2 k=10": "packed_scan_topk",
            "SAQ bpd=2 k=100": "packed_scan_topk"}
    want.update({what: "packed_scan_topk_gather" for what in one["launches"]
                 if what.startswith("IVF")})
    for what, kernel in want.items():
        require_launched({kernel: one["launches"][what][kernel]}, f"phase 16 one process {what}")
    lloyd = one["results"]["dp_lloyd_step"]
    require(np.array_equal(*lloyd), "phase 16: two dp_lloyd_step runs differ")
    log(f"[phase 16] one process, {shards} shards on {dev}: {sorted(one['results'])} "
        f"({time.perf_counter() - t0:.3f} s)")
    paths = {}
    t1 = time.perf_counter()
    gloo = spawn_ranks(torch, {**spec, "shards_per_rank": shards // world,
                               "parts": ("pq", "saq", "ivf")}, world, "gloo",
                       {"VQ_DIST_INIT": "1"})
    paths["phase 16 gloo ranks"] = hold_ranks(one, gloo, shards, "gloo")
    log(f"[phase 16] {world} gloo ranks on {dev}, {shards // world} shards each: ids, scores, "
        f"Lloyd centroids and footprints = the one-process mesh's bit for bit "
        f"({time.perf_counter() - t1:.3f} s)")
    if dev.type == "cuda":  # NCCL has no CPU route
        # one NCCL rank a card, as many as divide the shards (1 on one card)
        cards = torch.cuda.device_count()
        nranks = max(w for w in range(1, min(cards, shards) + 1) if shards % w == 0)
        t1 = time.perf_counter()
        nccl = spawn_ranks(torch, {**spec, "shards_per_rank": shards // nranks,
                                   "parts": ("pq", "saq")}, nranks, "nccl",
                           {"VQ_DIST_INIT": "1", "MASTER_ADDR": "127.0.0.1",
                            "MASTER_PORT": str(free_port()), "LOCAL_WORLD_SIZE": str(nranks)})
        paths["phase 16 NCCL ranks"] = hold_ranks(one, nccl, shards, "nccl")
        log(f"[phase 16] {nranks} NCCL rank(s) (env:// on 127.0.0.1), one a card, "
            f"{shards // nranks} shards each: = the one-process mesh bit for bit "
            f"({time.perf_counter() - t1:.3f} s)")
    log(f"[phase 16] launches of the ranks' searches: {paths}; phase 16 "
        f"{time.perf_counter() - t0:.3f} s")
    require_launched(paths["phase 16 gloo ranks"], "a kernel never launched in the gloo ranks")
    return paths


def main() -> int:
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import vq_tpu_torch  # noqa: F401  (sets TF32 off; fails outside a checkout)
    from vq_tpu_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)

    require(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
            "TF32 must be off")
    dev = torch.device("cuda", 0)
    log(f"[phase 1] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    # phase 2: build
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load_library()
    log(f"[phase 2] built {os.path.relpath(lib_path)} in {time.perf_counter() - t0:.3f} s")
    entry = ""  # the kernel each report line is about, from its mangled name
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1].split("_cu_")[-1][8:].lstrip("0123456789")
        elif "Used" in line or "spill" in line:
            log(f"[phase 2] ptxas {entry}: {line.strip()}")
    hmma = sass_hmma(lib_path)
    log(f"[phase 2] HMMA instructions in the scan kernels' SASS (cuobjdump -sass): {hmma}")
    require(hmma.get("bf16", 0) > 0, "the bf16 packed kernel does not reach the tensor cores")
    require(hmma.get("pq decode score_all", 0) > 0 and hmma.get("pq decode fused", 0) > 0,
            "the PQ decode route does not reach the tensor cores")

    results = {}
    phase_kernel_edges(torch, dev)
    phase_decode_edges(torch, dev)
    phase_kernels(torch, dev, results)
    phase_packed_kernels(torch, dev, results)
    # each path's launches, its counters read just after it: phases 4-14
    # each require their kernels to launch, the kernels line counts phase
    # 14's (the harness's CLI steps, the newest path) and lists every
    # path's beside it
    paths = {}
    paths["phase 4 PQ flat"], pq_ctx = phase_main(torch, dev)
    phase_gate(torch, dev)
    saq_launches, saq_ctx = phase_saq_main(torch, dev)
    paths["phase 7 SAQ flat"] = {"packed_scan_topk": saq_launches}
    paths["phase 8 RaBitQ flat"] = {"packed_scan_topk": phase_rabitq_main(torch, dev)}
    phase_gather_kernels(torch, dev, results)
    gather, ivf_ctx = phase_ivf_main(torch, dev)
    paths["phase 10 IVF-packed"] = {"packed_scan_topk_gather": gather}
    paths["phase 11 OPQ and RankAware flat"] = phase_quantizers(torch, dev)
    paths["phase 12 IVF-packed RankAware"] = {
        "packed_scan_topk_gather": phase_ivf_residual(torch, dev, ivf_ctx)}
    paths["phase 13 sharded serving"] = phase_sharded(torch, dev, pq_ctx, saq_ctx, ivf_ctx)
    # phase 15 runs here, while phases 4, 7 and 10's indexes are alive
    paths["phase 15 search options"] = phase_search_options(torch, dev, results, pq_ctx,
                                                            saq_ctx, ivf_ctx)
    with tempfile.TemporaryDirectory(prefix="vq_ranks_") as ranks_dir:
        spec = ranks_spec(torch, ranks_dir, pq_ctx, saq_ctx, ivf_ctx)
        del pq_ctx, saq_ctx, ivf_ctx
        torch.cuda.empty_cache()
        paths["phase 14 harness CLI"] = phase_harness(torch, dev, results)
        # phase 16, last: its ranks are processes of their own
        paths.update(phase_ranks(torch, dev, spec))
    log(f"[launches] by path: {json.dumps(paths)}")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "vq_tpu"))
    require(not leaked, f"JAX or JAX-package modules were imported: {leaked[:5]}")

    kernels = []
    for name, src, replaces in (
            ("pq_scan_topk_fused", "pq_scan.cu", "vq_tpu/kernels/pallas_scan.py:330"),
            ("pq_score_all", "pq_scan.cu", "vq_tpu/kernels/pallas_scan.py:120"),
            ("packed_scan_topk", "packed_scan.cu", "vq_tpu/kernels/pallas_packed.py:569"),
            ("packed_scan_topk_gather", "packed_scan.cu", "vq_tpu/kernels/pallas_packed.py:754")):
        # times at the first configuration measured; no single PyTorch call
        # decodes, scores and keeps a top-k, so there is no library time
        tag = next(iter(results[name]["times"]))
        tk, tp = results[name]["times"][tag]
        bms, bby = results[name]["bounds"][tag]
        kernels.append({"name": name, "route": "cuda", "source": f"vq_tpu_torch/csrc/{src}",
                        "replaces": replaces,
                        "launches": paths["phase 14 harness CLI"][name],
                        "launches_by_path": {p: n[name] for p, n in paths.items() if name in n},
                        "max_abs_err": results[name]["max_abs_err"], "ms": tk,
                        "plain_ms": tp, "bound_ms": bms, "bound_by": bby, "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
