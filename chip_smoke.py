#!/usr/bin/env python3
"""Drive the PyTorch port (``vq_tpu_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Device: the card's name and power limit (nvidia-smi), CUDA required,
   TF32 off.
2. Build the CUDA kernels of ``vq_tpu_torch/csrc`` from the checkout.
3. Each kernel against its plain PyTorch version on the card: edge cases
   at small shapes, then the main path's shapes (Q=1024, D=1536, N=100,000,
   M=16 / K=256 and M=192 / dsub=8), f32 mode on scores and ids, bf16 mode
   on recall against the plain f32 ids; kernel and plain times.
4. The main path — what ``vq_tpu/bench/sweep.py::run_single_config`` does:
   PQ(M=16, B=8) fit, FlatQuantizedIndex fit (encode), ground truth by
   ``exact_topk``, search at k=10 (fused kernel) and k=100 (score kernel +
   streaming top-k), on a seeded power-law corpus at N=1,000,000, D=1536.
   The kernels' launch counters must move during this phase.  The
   quantizer is built without a device and must follow the corpus onto
   the card.  Then where the time goes: wall and device-busy ms per
   search, the idle share and the device time per kernel (torch.profiler
   over 5 searches), and CUDA-event times of the fused kernel at k=100 and
   of the score kernel over the whole corpus.
5. Quality gate: PQ(M=192, B=8) on the planted-neighbourhood corpus
   (N=100k, D=1536), recall@10 ≥ 0.763.

The line before the last is a JSON object of the kernels (launches in
phase 4, errors and times from phase 3); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

RECALL_GATE_PQ192_FLOOR = 0.763  # bench.py:48
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


def phase_kernels(torch, dev, results, n=100_000, d=1536, nq=1024):
    from vq_tpu_torch.kernels import pq_scan as ps
    from vq_tpu_torch.kernels.topk import ordered_topk
    from vq_tpu_torch.methods.pq import encode_chunked

    k = 10
    x, q = powerlaw_corpus(torch, n, d, nq, seed=3, dev=dev)
    for m in (16, 192):
        cb = random_codebooks(torch, x, m, 256, seed=m)
        codes = encode_chunked(cb, x)
        tag = f"M={m} dsub={d // m}"
        # f32 mode
        tol = f32_tol(torch, q, cb)
        s_k = ps.pq_score_all(q, codes, cb, use_bf16=False)
        s_p = ps.pq_score_all_plain(q, codes, cb, True, False)
        err_score = check_scores(torch, s_k, s_p, tol, f"score_all f32 {tag}")
        ks, ki = ps.pq_scan_topk_fused(q, codes, cb, k, use_bf16=False)
        # both kernels sum the same table entries in the same order, so the
        # fused top-k must be exactly the top-k of the score kernel's scores
        ss, si = ordered_topk(s_k, k)
        require(torch.equal(ki, si) and torch.equal(ks, ss),
                f"fused {tag}: top-k differs from the score kernel's top-k")
        del s_k, s_p, ss, si
        rs, ri = ps.pq_scan_topk_fused_plain(q, codes, cb, k + 1, True, None, False)
        err_fused, n_sep, n_ord = check_topk_f32(torch, ks, ki, rs, ri, k, tol,
                                                  f"fused f32 {tag}")
        log(f"[phase 3] {tag} f32: score_all max_abs_err={err_score:.3e} fused "
            f"max_abs_err={err_fused:.3e}; fused ids = top-k of score kernel at {nq}/{nq} "
            f"queries; ids = plain at {n_sep}/{nq} separated queries ({n_ord} fully ordered)")
        # bf16 mode: kernel vs plain-bf16 scores, recall vs plain f32 ids
        s_k = ps.pq_score_all(q, codes, cb, use_bf16=True)
        check_scores(torch, s_k, ps.pq_score_all_plain(q, codes, cb, True, True), tol,
                     f"score_all bf16 {tag}")
        del s_k
        _, bi = ps.pq_scan_topk_fused(q, codes, cb, k, use_bf16=True)
        rec = recall(ri[:, :k].cpu(), bi.cpu(), k)
        log(f"[phase 3] {tag} bf16: fused recall@{k} vs plain f32 ids = {rec:.4f}")
        require(rec >= BF16_MIN_RECALL, f"bf16 recall {rec} < {BF16_MIN_RECALL}")
        # times, bf16 as the main path runs them
        t_fk = cuda_ms(torch, lambda: ps.pq_scan_topk_fused(q, codes, cb, k, use_bf16=True))
        t_fp = cuda_ms(torch, lambda: ps.pq_scan_topk_fused_plain(q, codes, cb, k, True, None,
                                                                  True))
        t_sk = cuda_ms(torch, lambda: ps.pq_score_all(q, codes, cb, use_bf16=True))
        t_sp = cuda_ms(torch, lambda: ps.pq_score_all_plain(q, codes, cb, True, True))
        log(f"[phase 3] {tag} times (ms, median of 5, bf16): fused kernel {t_fk:.3f} plain "
            f"{t_fp:.3f}; score_all kernel {t_sk:.3f} plain {t_sp:.3f}")
        for name, err, tk, tp in (("pq_scan_topk_fused", err_fused, t_fk, t_fp),
                                  ("pq_score_all", err_score, t_sk, t_sp)):
            r = results.setdefault(name, {"max_abs_err": 0.0, "times": {}})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["times"][tag] = (tk, tp)
        del codes, cb
    del x, q
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4
def profile_search(torch, index, q, reps: int = 5) -> None:
    """torch.profiler over `reps` searches at k=10 and k=100 (wall and
    device-busy ms per search, idle share, device ms per kernel), then
    CUDA-event times of the fused kernel at k=100 and of the score kernel
    over all rows (the k=100 route runs it over row tiles)."""
    from torch.profiler import ProfilerActivity, profile
    from vq_tpu_torch.kernels import pq_scan as ps

    for k in (10, 100):
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
        log(f"[profile] search k={k}: wall {wall_ms:.3f} ms/search, device busy {busy:.3f} "
            f"ms, idle share {1 - busy / wall_ms:.3f} (torch.profiler, {reps} searches)")
        for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
            log(f"[profile]   {ms:9.3f} ms/search  {name[:100]}")
    codes, cb = index.codes, index.quantizer.params.codebooks
    t_fused = cuda_ms(torch, lambda: ps.pq_scan_topk_fused(q, codes, cb, 100))
    t_score = cuda_ms(torch, lambda: ps.pq_score_all(q, codes, cb))
    log(f"[profile] N={codes.shape[0]} bf16 (CUDA events, median of 5): pq_scan_topk_fused "
        f"k=100 {t_fused:.3f} ms; pq_score_all over all rows {t_score:.3f} ms")


def phase_main(torch, dev, n=1_000_000, d=1536, nq=1024, profile=True):
    from vq_tpu_torch import KMeansConfig, PQConfig, SearchConfig
    from vq_tpu_torch.index.flat import FlatQuantizedIndex
    from vq_tpu_torch.kernels import pq_scan as ps
    from vq_tpu_torch.kernels.adc import exact_topk
    from vq_tpu_torch.methods.pq import PQ

    (x, q), t_gen = wall_s(torch, lambda: powerlaw_corpus(torch, n, d, nq, seed=0, dev=dev))
    log(f"[phase 4] corpus N={n} D={d} Q={nq} on {dev}: {t_gen:.3f} s "
        f"({x.numel() * 4 / 1e9:.2f} GB)")
    ps.reset_launch_counts()
    pq = PQ(PQConfig(num_subquantizers=16, num_bits=8, kmeans=KMeansConfig(iters=20)),
            seed=0)  # no device: the quantizer takes the corpus's
    _, t_fit = wall_s(torch, lambda: pq.fit(x))
    require(pq.device == x.device, f"quantizer on {pq.device}, corpus on {x.device}")
    index = FlatQuantizedIndex(pq, SearchConfig(use_bf16=True))
    _, t_enc = wall_s(torch, lambda: index.fit(x))
    require(index.codes.device == x.device and pq.params.codebooks.device == x.device,
            "index state left the corpus's device")
    (gt_s, gt_i), t_gt = wall_s(torch, lambda: exact_topk(q, x, 100))
    gt = gt_i.cpu().numpy()
    log(f"[phase 4] fit {t_fit:.3f} s; encode (index fit) {t_enc:.3f} s "
        f"({n / t_enc:.0f} rows/s); ground truth k=100 {t_gt:.3f} s")
    out = {}
    for k in (10, 100):
        index.search_with_scores(q, k)  # warm-up
        runs = [wall_s(torch, lambda: index.search_with_scores(q, k)) for _ in range(3)]
        ids, scores = runs[-1][0]
        t = float(np.median([r[1] for r in runs]))
        require(ids.shape == (nq, k) and scores.shape == (nq, k), f"k={k} result shape")
        require(bool(np.isfinite(scores).all()) and int(ids.max()) < n, f"k={k} result values")
        require(bool((np.diff(scores, axis=1) >= 0).all()), f"k={k} distances not ascending")
        out[k] = ids
        recalls = ", ".join(f"recall@{r} {recall(gt, ids, r):.4f}" for r in sorted({10, k}))
        log(f"[phase 4] search k={k}: {t * 1e3:.3f} ms/batch (median of 3, host clock), "
            f"QPS {nq / t:.1f}, {recalls}")
    launches = {"pq_scan_topk_fused": ps.pq_scan_topk_fused.launches,
                "pq_score_all": ps.pq_score_all.launches}
    log(f"[phase 4] launches during the main path: {launches}")
    require_launched(launches, "a kernel of the main path never launched")
    # both kernel routes score with the same tables: k=10 ids are k=100's head
    require(bool((out[10] == out[100][:, :10]).all()), "k=10 and k=100 searches disagree")
    # reference on a query subset: the plain version on the same codes
    sub = q[:64]
    _, ri = ps.pq_scan_topk_fused_plain(sub, index.codes, pq.params.codebooks, 10, True, None,
                                        True)
    rec = recall(ri.cpu(), out[10][:64], 10)
    log(f"[phase 4] kernel vs plain (64 queries, bf16) recall@10 = {rec:.4f}")
    require(rec >= BF16_MIN_RECALL, "main path disagrees with its plain reference")
    if profile:
        profile_search(torch, index, q)
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
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            log(f"[phase 2] ptxas: {line.strip()}")

    results = {}
    phase_kernel_edges(torch, dev)
    phase_kernels(torch, dev, results)
    launches = phase_main(torch, dev)
    phase_gate(torch, dev)
    jax_side = sorted(m for m in sys.modules if m.split(".")[0] == "jax" or m.startswith(
        ("vq_tpu.kernels", "vq_tpu.methods", "vq_tpu.index", "vq_tpu.data")))
    require(not jax_side, f"JAX modules were imported: {jax_side[:5]}")

    src = "vq_tpu_torch/csrc/pq_scan.cu"
    replaces = {"pq_scan_topk_fused": "vq_tpu/kernels/pallas_scan.py:330",
                "pq_score_all": "vq_tpu/kernels/pallas_scan.py:120"}
    kernels = []
    for name in ("pq_scan_topk_fused", "pq_score_all"):
        tk, tp = results[name]["times"]["M=16 dsub=96"]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces[name], "launches": launches[name],
                        "max_abs_err": results[name]["max_abs_err"], "ms": tk,
                        "plain_ms": tp})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
