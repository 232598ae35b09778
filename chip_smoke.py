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

Phases 6 and 9 hold a fifth configuration, RankAware bpd=2 (one segment
per bit width, "perdim" and "values", no per-row scale: scale_col −1), and
phase 6 its FFD packing once.

The line before the last is a JSON object of the kernels (launches in
phases 4 and 11 (fused), 7, 8 and 11 (packed), 10 and 12 (gather); errors
and times from phases 3, 6 and 9; each
kernel's bound, the least time the card could take for the timed call);
the card's name and power limit are printed before it, and the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
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


def packed_bound(torch, a):
    """The packed kernel's bound for ``packed_scan_topk`` arguments ``a``:
    the scanned rows' words and factors, the level tables, the queries (and
    the mask) read once, the (Q, k) top-k written once; 2·Q·D operations a
    scanned row, in the operands' type (bf16 in bf16 mode)."""
    fac = a["factors"]
    n_pad = fac.shape[1]
    mask = a.get("tile_mask")
    rows = scanned_rows(torch, n_pad, a["limit"], mask)
    per_row = (sum(w.numel() * w.element_size() for w in a["words"]) + fac.numel() * 4) / n_pad
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
    neighbourhoods, unit-normalized rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kc = n // csize
    a = torch.randn((rank, d), generator=g, device=dev)
    a = a * (1.0 + torch.arange(d, device=dev)) ** -0.5
    cents = torch.randn((kc, rank), generator=g, device=dev)
    z = cents[torch.arange(n, device=dev) % kc] + spread * torch.randn(
        (n, rank), generator=g, device=dev)
    qdoc = torch.randint(0, kc, (nq,), generator=g, device=dev)
    zq = cents[qdoc] + spread * torch.randn((nq, rank), generator=g, device=dev)
    x, q = z @ a, zq @ a
    return (x / torch.linalg.norm(x, dim=1, keepdim=True),
            q / torch.linalg.norm(q, dim=1, keepdim=True))


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
def profile_search(torch, index, q, ks=(10, 100, 256), tag="", reps: int = 5) -> None:
    """torch.profiler over `reps` searches at each k: wall and device-busy ms
    per search, idle share, device ms per kernel."""
    from torch.profiler import ProfilerActivity, profile

    for k in ks:
        index.search_with_scores(q, k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                index.search_with_scores(q, k)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / reps * 1e3
        per_kernel = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.device_time / reps / 1e3
        busy = sum(per_kernel.values())
        require(busy > 0, "torch.profiler recorded no device time")
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
    del x, q, index, pq
    torch.cuda.empty_cache()
    return launches


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
def timed_search(torch, index, q, k, gt, what):
    """Warm-up, then the median of 3 host-clock searches; checks the result
    and returns its ids."""
    index.search_with_scores(q, k)
    runs = [wall_s(torch, lambda: index.search_with_scores(q, k)) for _ in range(3)]
    ids, scores = runs[-1][0]
    t = float(np.median([r[1] for r in runs]))
    nq = q.shape[0]
    require(ids.shape == (nq, k) and scores.shape == (nq, k), f"{what} k={k} result shape")
    require(bool(np.isfinite(scores).all()) and int(ids.max()) < index.num_rows,
            f"{what} k={k} result values")
    require(bool((np.diff(scores, axis=1) >= 0).all()), f"{what} k={k} not ascending")
    recalls = ", ".join(f"recall@{r} {recall(gt, ids, r):.4f}" for r in sorted({10, k}))
    log(f"[{what}] search k={k}: {t * 1e3:.3f} ms/batch (median of 3, host clock), "
        f"QPS {nq / t:.1f}, {recalls}")
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
    del x, q, index, cache, gt_i
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
    return launches + banded


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
    from vq_tpu_torch._device import bf16_supported, make_generator
    from vq_tpu_torch.data.sampling import chunk_rows_for_bytes, host_sample_rows
    from vq_tpu_torch.index.ivf import chunked_assign
    from vq_tpu_torch.index.ivf_packed import IvfPackedFlatIndex, tile_mask_from_probes
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.kernels.adc import _finalize, exact_topk
    from vq_tpu_torch.kernels.kmeans import kmeans, pairwise_sqdist_xc
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
    cap = min(n, max(200_000, kmc.max_points_per_centroid * k_cl))
    def coarse_pass():
        return kmeans(make_generator(kmc.seed, dev), host_sample_rows(x, cap, kmc.seed), k_cl,
                      kmc)

    cents, t_km = wall_s(torch, coarse_pass)
    cents2, t_km2 = wall_s(torch, coarse_pass)
    require(torch.equal(cents, cents2), "two coarse passes from one seed gave different "
                                        "centroids")
    log(f"[phase 10] coarse k-means K={k_cl} run twice from seed {kmc.seed}: centroids "
        f"bit-equal; {t_km:.3f} s, {t_km2:.3f} s")
    del cents2
    asn, t_asn = wall_s(torch, lambda: chunked_assign(x, cents, chunk_rows_for_bytes(d)))
    pk.reset_launch_counts()
    saq = sq.SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True))  # no device: the corpus's
    _, t_qfit = wall_s(torch, lambda: saq.fit(host_sample_rows(x, 200_000, kmc.seed)))
    index = IvfPackedFlatIndex(saq, IVFConfig(k_cl, nprobes[0], kmc), SearchConfig(use_bf16=True))
    _, t_fit = wall_s(torch, lambda: index.fit(x, coarse=(cents, asn)))
    require(index.cache.factors.device == x.device and index.cache.perm is None,
            "the IVF cache left the card or lost the rows' order")
    nb = index.cache.factors.shape[1] // 512
    log(f"[phase 10] build: coarse k-means K={k_cl} on {min(cap, n)} rows {t_km:.3f} s; "
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
    del index, rindex
    torch.cuda.empty_cache()
    return launches["packed_scan_topk_gather"], dict(x=x, q=q, gt=gt, cents=cents, asn=asn,
                                                     kmc=kmc)


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
    ids_a, s_a = a
    ids_b, s_b = b
    xh = index.decompress(ids_a.reshape(-1).astype(np.int64))
    tol = F32_RTOL * (torch.sum(q * q, dim=1).cpu().numpy()[:, None]
                      + 2.0 * float(torch.max(torch.sum(xh * xh, dim=1))))
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
    launches = phase_main(torch, dev)
    phase_gate(torch, dev)
    launches["packed_scan_topk"] = phase_saq_main(torch, dev) + phase_rabitq_main(torch, dev)
    phase_gather_kernels(torch, dev, results)
    launches["packed_scan_topk_gather"], ivf_ctx = phase_ivf_main(torch, dev)
    for name, count in phase_quantizers(torch, dev).items():
        launches[name] += count
    launches["packed_scan_topk_gather"] += phase_ivf_residual(torch, dev, ivf_ctx)
    del ivf_ctx
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
                        "replaces": replaces, "launches": launches[name],
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
