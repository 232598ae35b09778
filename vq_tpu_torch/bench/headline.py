"""The port's headline benchmark — counterpart of the JAX system's
``bench.py``: the same sections, configurations and output fields, on one
CUDA card through the port's indexes, quantizers and hand-written kernels.

    python -m vq_tpu_torch.bench.headline [--n N] [--d D] [--q Q] [--tile T]
        [--fast] [--smoke] [--out PATH] [--device cuda|cpu]

Sections, one function each, each filling the record ``out`` with
``bench.py``'s fields for it:

  headline_pq        bench.py:61-173   PQ M=16 B=8 at D=1536, N=100,000,
                                       Q=1024, k=10: sustained QPS, spread,
                                       recall@10, encode rate, effective TFLOP/s
  recall_gate_pq192  bench.py:176-230  PQ M=192 on the planted corpus (the
                                       decode route); floor 0.763
  exactness_assert   bench.py:654-775  each hand-written kernel against its
                                       plain twin at N=4096, D=256, Q=16, f32
  packed_saq_1m      bench.py:248-380  SAQ bpd=2 + PCA, D=1024, N=1,048,576,
                                       Q=256; the banded prune rows
  packed_rabitq_1m   bench.py:385-438  RaBitQ B=2, same shape
  ivf_flagship       bench.py:478-651  N=1,048,576, D=1536, K=4096, Q=256:
                                       residual IVF (SAQ bpd 1/2/4, PQ M=192)
                                       and IVF-packed ladders, nprobe 50/200,
                                       batches 8/64/256 with query groups

The one deliberate difference from ``bench.py``: each section runs on its
own.  An exception in one goes into the record's ``errors`` (section →
message) and the others still report; the process exits 1 if any section
failed, ``assert_ok`` is false or the gate is under its floor.  The full
record goes to ``--out`` (default under the git-ignored ``results/``; the
JAX package's committed ``BENCH_SELF.json`` is never written), and the last
line of stdout is the compact record: ``bench.py``'s ``compact_keys`` plus
``errors`` and the card's name and power limit (``nvidia-smi``).

``--fast`` shrinks the 1M sections to N=131,072 and the IVF section to
K=1024 and two residual configurations, as ``VQ_BENCH_FAST=1`` does;
``--smoke`` runs every section and configuration at tiny sizes, so its
record has the full key set (``VQ_BENCH_SMOKE=1`` shrank only the IVF
section).  ``--n/--d/--q/--tile`` set the headline shape (bench.py's
``VQ_BENCH_N/D/Q/TILE``).

Times are host-clock windows around synchronised calls: ``sustained`` runs
``reps`` back-to-back calls and syncs once at the end of each of ``outer``
windows (bench.py's in-jit repetition loop).  The IVF-packed rows use the
index's ``sustained_search_s`` (CUDA events), as bench.py uses its own.
The entry point runs on the card unless ``--device cpu`` asks for the CPU,
where every kernel wrapper runs its plain version; without a card it
raises before any work.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from vq_tpu_torch._device import make_generator, resolve_device
from vq_tpu_torch.bench import corpora
from vq_tpu_torch.bench.tolerance import f32_tol, packed_tol, topk_agreement
from vq_tpu_torch.core.config import (
    IVFConfig,
    KMeansConfig,
    Metric,
    PQConfig,
    RaBitQConfig,
    SAQConfig,
    SearchConfig,
)
from vq_tpu_torch.kernels import kernel_launches
from vq_tpu_torch.metrics.recall import recall_at_k

RECALL_GATE_PQ192_FLOOR = 0.763  # bench.py:48
# the reference's single-core ADC rate (reference bench/ffd_speed.cpp:10-16):
# vs_baseline = QPS ÷ (2.4e6 / N)
BASELINE_ROWS_PER_S = 2.4e6
COMPACT_KEYS = (
    "metric", "value", "unit", "vs_baseline", "value_median",
    "recall_at_10", "recall_gate_pq192", "assert_ok", "assert_compiled",
    "saq_packed_qps", "ivfpk_saq_bpd2_np200_qps",
    "ivfpk_saq_bpd2_np200_recall100", "flat_saq_bpd2_qps",
    "flat_saq_bpd2_recall100",
)
ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass(frozen=True)
class Run:
    """One benchmark run: the device, the headline shape and the mode."""

    device: torch.device
    n: int = 100_000
    d: int = 1536
    nq: int = 1024
    tile: int = 16384
    fast: bool = False
    smoke: bool = False

    def size(self, full: int, fast: int, smoke: int) -> int:
        return smoke if self.smoke else (fast if self.fast else full)

    def reps(self, reps: int, outer: int):
        """(reps, outer) of a sustained time; one call in a smoke run."""
        return (1, 1) if self.smoke else (reps, outer)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sustained(fn, device, reps: int, outer: int):
    """(median, best) seconds per call of ``fn`` over ``outer`` windows of
    ``reps`` back-to-back calls, each window timed by the host clock from a
    synchronised start to a synchronised end, after one warm-up call."""
    fn()
    sync(device)
    times = []
    for _ in range(outer):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync(device)
        times.append((time.perf_counter() - t0) / reps)
    return float(np.median(times)), float(min(times))


def card(device):
    """(name, power limit) of a card as ``nvidia-smi --query-gpu=name,
    power.limit`` gives them; (None, None) on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None, None
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", f"--id={dev.index or 0}"],
                          capture_output=True, text=True, check=True).stdout.strip()
    name, limit = (s.strip() for s in line.splitlines()[0].rsplit(",", 1))
    return name, limit


# ---------------------------------------------------------------- sections
def headline_pq(out: dict, run: Run) -> None:
    """bench.py:61-173: PQ M=16 B=8 on the power-law corpus, sustained ADC
    QPS through the fused PQ kernel."""
    from vq_tpu_torch.kernels.adc import exact_topk, scan_codes_topk
    from vq_tpu_torch.methods import pq as pq_mod
    from vq_tpu_torch.utils.profiling import ScanStats

    dev, n, d, nq, k = run.device, run.n, run.d, run.nq, 10
    x, q = corpora.powerlaw(n, d, nq, seed=0, device=dev)
    pq = pq_mod.PQ(PQConfig(num_subquantizers=16, num_bits=8, kmeans=KMeansConfig(iters=20)),
                   seed=0, device=dev).fit(x)
    codes = pq.compress(x)
    cb = pq.params.codebooks
    gt = exact_topk(q, x, k, Metric.L2)[1]

    def scan():
        return scan_codes_topk(q, codes, cb, k, Metric.L2, tile_rows=run.tile, use_bf16=True)

    recall = recall_at_k(gt, scan()[1], k)
    med, best = sustained(scan, dev, *run.reps(10, 5))
    qps = nq / best
    n_enc = min(n, 100_000)
    xe = x[:n_enc]
    _, t_enc = sustained(lambda: pq_mod.encode(pq.params, xe), dev, *run.reps(3, 1))
    stats = ScanStats(num_rows=n, num_queries=nq, dim=d, code_bytes_per_row=16.0).report(best)
    out.update(
        metric="adc_qps_per_chip_pq16x8_d1536_n100k",
        value=qps,
        unit="queries/s/chip",
        vs_baseline=qps / (BASELINE_ROWS_PER_S / n),
        value_median=nq / med,
        value_spread=(med - best) / med,
        recall_at_10=recall,
        scan_wall_s=best,
        n=n,
        num_queries=nq,
        encode_vecs_per_s=n_enc / t_enc,
        effective_tflops=stats["effective_tflops"],
    )


def recall_gate_pq192(out: dict, run: Run) -> None:
    """bench.py:176-230: the bpd-matched quality gate, PQ M=192 B=8 at
    D=1536 (≈1 bit/dim) on the planted-neighbourhood corpus, through the
    fused kernel's decode route; ``main`` fails the run under the floor."""
    from vq_tpu_torch.kernels.adc import exact_topk, scan_codes_topk
    from vq_tpu_torch.methods.pq import PQ

    dev, k = run.device, 10
    n, d, nq = (2000, 128, 16) if run.smoke else (100_000, 1536, 1024)
    x, q = corpora.planted(n, d, nq, seed=0, device=dev)
    gt = exact_topk(q, x, k, Metric.L2)[1]
    pq = PQ(PQConfig(num_subquantizers=d // 8, num_bits=8, kmeans=KMeansConfig(iters=10)),
            seed=1, device=dev).fit(x)
    ids = scan_codes_topk(q, pq.compress(x), pq.params.codebooks, k, Metric.L2,
                          use_bf16=True)[1]
    out["recall_gate_pq192"] = recall_at_k(gt, ids, k)
    out["recall_gate_floor"] = RECALL_GATE_PQ192_FLOOR


def exactness_assert(out: dict, run: Run) -> None:
    """bench.py:654-775 on the port: each hand-written kernel against its
    plain PyTorch twin on the same inputs, at bench.py's shapes (N=4096,
    D=256, Q=16, k=10), f32 mode: SAQ uniform and lloyd at bpd=2 and lloyd
    at bpd=6 (the f32 value planes), prune off and on, NIP + prune; the
    gather mode (every tile = the dense kernel bit for bit, a partial mask
    against its plain version) and k=64; RaBitQ B=2 and B=8; PQ on the
    table route (f32, fused and score kernel) and the decode route (bf16
    only, held to the plain bf16 version).  Scores must agree within the
    f32 tolerance of ``bench/tolerance.py`` and ids where the scores are
    separated by more than it (chip_smoke.py's bar).  ``assert_compiled``:
    the kernels ran on CUDA (on the CPU both sides are the plain twin)."""
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.kernels import pq_scan as ps
    from vq_tpu_torch.methods import packed as pr
    from vq_tpu_torch.methods import rabitq as rb_mod
    from vq_tpu_torch.methods import saq as saq_mod
    from vq_tpu_torch.methods.pq import PQ

    dev = run.device
    before = kernel_launches()
    rng = np.random.default_rng(0)
    n, d, nq, k = 4096, 256, 16, 10
    x_np = (rng.standard_normal((n, d)) * (1.0 + np.arange(d))[::-1] ** 0.5).astype(np.float32)
    q_np = x_np[rng.integers(0, n, nq)] + 0.05 * rng.standard_normal((nq, d)).astype(np.float32)
    x, q = torch.from_numpy(x_np).to(dev), torch.from_numpy(q_np).to(dev)
    norms = torch.linalg.norm(x, dim=1)
    checks = []

    def hold(tag, a, kk=k):
        """The kernel call ``a`` against the plain version's top-(kk+1)."""
        got = pk.packed_scan_topk(**{**a, "k": kk})
        ref = pk.packed_scan_topk_plain(**{**a, "k": kk + 1, "prune": False,
                                           "tile_stats": None, "qprune": None})
        r = topk_agreement(got[0], got[1], ref[0], ref[1], kk, packed_tol(a))
        checks.append((tag, r["scores"] and r["sets"] and r["order"]))

    for codebook, bpd in (("uniform", 2.0), ("lloyd", 2.0), ("lloyd", 6.0)):
        m = saq_mod.SAQ(SAQConfig(bits_per_dim=bpd, codebook=codebook), device=dev).fit(x)
        cache = m.prepare_scan(m.compress(x), norms=norms)
        for prune in (False, True):
            hold(f"saq/{codebook}{bpd}/prune={prune}",
                 pr.packed_scan_args(m.packed_route(), q, cache, k, Metric.L2,
                                     use_bf16=False, prune=prune))
        if codebook == "uniform":
            hold("saq/nip_prune", pr.packed_scan_args(m.packed_route(), q, cache, k,
                                                      Metric.NIP, use_bf16=False,
                                                      prune=True))
            # the gather mode on the order-preserving layout
            tc = m.prepare_tile_cache(m.compress(x), norms=norms)
            a = pr.packed_scan_args(m.packed_route(), q, tc, k, Metric.L2, use_bf16=False)
            nb = tc.factors.shape[1] // pk.TILE
            ones = torch.ones((nb,), dtype=torch.int32, device=dev)
            dense, full = pk.packed_scan_topk(**a), pk.packed_scan_topk(**a, tile_mask=ones)
            checks.append(("gather/full", torch.equal(dense[0], full[0])
                           and torch.equal(dense[1], full[1])))
            part = (torch.arange(nb, device=dev) % 3 == 0).to(torch.int32)
            hold("gather/partial", {**a, "tile_mask": part})
            hold("mergefold/k64", a, kk=64)
    for bits in (2, 8):
        mb = rb_mod.RaBitQ(RaBitQConfig(num_bits=bits), device=dev).fit(x)
        cache = mb.prepare_scan(mb.compress(x))
        hold(f"rabitq{bits}", pr.packed_scan_args(mb.packed_route(), q, cache, k, Metric.L2,
                                                  use_bf16=False))
    pq = PQ(PQConfig(num_subquantizers=16, num_bits=8, kmeans=KMeansConfig(iters=5)),
            device=dev).fit(x)
    codes, cb = pq.compress(x), pq.params.codebooks
    tol = f32_tol(q, cb)
    for route, bf16 in (("table", False), ("decode", True)):  # pq_route at dsub 16
        got = ps.pq_scan_topk_fused(q, codes, cb, k, use_bf16=bf16)
        ref = ps.pq_scan_topk_fused_plain(q, codes, cb, k + 1, use_bf16=bf16)
        r = topk_agreement(got[0], got[1], ref[0], ref[1], k, tol)
        checks.append((f"pq/{route}", r["scores"] and r["sets"] and r["order"]))
    s = ps.pq_score_all(q, codes, cb, use_bf16=False)
    checks.append(("pq/score_all", bool(((s - ps.pq_score_all_plain(q, codes, cb, True, False))
                                         .abs() <= tol).all())))
    sync(dev)
    ran = {name: v - before[name] for name, v in kernel_launches().items()}
    ok = all(c[1] for c in checks)
    out["assert_ok"] = ok
    out["assert_compiled"] = dev.type == "cuda" and all(v > 0 for v in ran.values())
    if not ok:
        out["assert_detail"] = ";".join(f"{t}:{c}" for t, c in checks)


def packed_saq_1m(out: dict, run: Run) -> None:
    """bench.py:248-380: SAQ bpd=2 + PCA through the dense packed kernel at
    D=1024, N=1,048,576, Q=256, k=10; then the variance prune's showcase —
    a lognormal row-scale corpus, norm-ordered packing, a norm-banded query
    batch — with its staged counters (``utils/profiling.ScanStats``)."""
    from vq_tpu_torch.kernels import packed_scan as pk
    from vq_tpu_torch.kernels.adc import exact_topk
    from vq_tpu_torch.methods import packed as pr
    from vq_tpu_torch.methods import saq as saq_mod
    from vq_tpu_torch.utils.profiling import ScanStats

    dev = run.device
    n = run.size(1_048_576, 131_072, 4096)
    d, nq, k = (128, 16, 10) if run.smoke else (1024, 256, 10)
    m = saq_mod.SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True), device=dev)
    m.fit(corpora.packed_corpus(min(n, 131_072), d, 1, seed=7, device=dev)[0])
    plan, params = m.plan, m.params
    x, q, _ = corpora.packed_corpus(n, d, nq, seed=0, device=dev)
    codes = m.compress(x)
    cache = saq_mod.prepare_packed(plan, params, codes)
    gt = exact_topk(q, x, k, Metric.L2)[1]
    del x

    def scan():
        return saq_mod.scan_topk(plan, params, q, codes, k, Metric.L2, packed_cache=cache,
                                 use_packed=True)

    recall = recall_at_k(gt, scan()[1], k)
    med, best = sustained(scan, dev, *run.reps(5, 3))
    # the prune diagnostic: the share of the scan the variance stage let
    # through (tiles in the plain twin, (query block, tile) pairs on the card)
    units = pk.prune_units(nq, cache.factors.shape[1], dev)
    route = m.packed_route()
    scanned = pr.packed_scan(route, q, cache, k, Metric.L2, prune=True)[2]
    out.update(
        saq_packed_qps=nq / best,
        saq_packed_qps_median=nq / med,
        saq_packed_recall10=recall,
        saq_packed_n=n,
        saq_tiles_scanned_frac=int(scanned) / units,
        saq_code_bytes=int(plan.code_bytes),
    )
    del cache, codes

    x, _, sigma = corpora.packed_corpus(n, d, nq, seed=1, device=dev, lognormal=True)
    codes = m.compress(x)
    cache = saq_mod.prepare_packed(plan, params, codes, sort_rows=True)
    band = torch.argsort(torch.linalg.norm(x[:131_072], dim=1))[:nq]
    qb = x[band] + 0.05 * sigma * torch.randn((nq, d), generator=make_generator(5, dev),
                                              device=dev)
    del x
    best_prune = None
    for name, prune in (("saq_prune_banded", True), ("saq_dense_banded", False)):
        _, best_pr = sustained(
            lambda: saq_mod.scan_topk(plan, params, qb, codes, k, Metric.L2,
                                      packed_cache=cache, use_packed=True, prune_tiles=prune),
            dev, *run.reps(5, 3))
        out[f"{name}_qps"] = nq / best_pr
        if prune:
            best_prune = best_pr
    scanned = pr.packed_scan(route, qb, cache, k, Metric.L2, prune=True)[2]
    frac = int(scanned) / pk.prune_units(nq, cache.factors.shape[1], dev)
    out["saq_prune_tiles_frac"] = frac
    # the staged counters count whole tiles: the scanned share of them
    nb = cache.factors.shape[1] // pk.TILE
    staged = ScanStats(num_rows=nb * pk.TILE, num_queries=nq, dim=d,
                       code_bytes_per_row=float(plan.code_bytes)).report_staged(
        best_prune, round(frac * nb), nb)
    out["saq_prune_fast_bitsum"] = staged["fast_bitsum"]
    out["saq_prune_acc_bitsum"] = staged["acc_bitsum"]
    out["saq_prune_total_comp_cnt"] = staged["total_comp_cnt"]


def packed_rabitq_1m(out: dict, run: Run) -> None:
    """bench.py:385-438: RaBitQ B=2 through the dense packed kernel at
    D=1024, N=1,048,576, Q=256, k=10."""
    from vq_tpu_torch.kernels.adc import exact_topk
    from vq_tpu_torch.methods import rabitq as rb_mod

    dev = run.device
    n = run.size(1_048_576, 131_072, 4096)
    d, nq, k, bits = (128, 16, 10, 2) if run.smoke else (1024, 256, 10, 2)
    m = rb_mod.RaBitQ(RaBitQConfig(num_bits=bits), device=dev)
    m.fit(corpora.packed_corpus(min(n, 65_536), d, 1, seed=9, device=dev)[0])
    x, q, _ = corpora.packed_corpus(n, d, nq, seed=2, device=dev)
    codes = m.compress(x)
    cache = rb_mod.prepare_packed(m.params, codes, bits)
    gt = exact_topk(q, x, k, Metric.L2)[1]
    del x

    def scan():
        return rb_mod.scan_topk(m.params, q, codes, k, Metric.L2, bits, packed_cache=cache,
                                use_packed=True)

    recall = recall_at_k(gt, scan()[1], k)
    med, best = sustained(scan, dev, *run.reps(5, 3))
    out.update(
        rabitq_packed_qps=nq / best,
        rabitq_packed_qps_median=nq / med,
        rabitq_packed_recall10=recall,
        rabitq_packed_n=n,
    )


def ivf_flagship(out: dict, run: Run) -> None:
    """bench.py:478-651: IVF at the reference's flagship operating point
    (N=1,048,576, D=1536, K=4096, k=100) on the planted full-rank corpus.
    One coarse pass shared by every configuration; the residual IVF index
    with SAQ bpd 1/2/4 and PQ M=192, nprobe 50/200 (recall@1/10/100, QPS,
    build time); the IVF-packed ladder SAQ bpd 1/2/4 + RaBitQ B=2 at nprobe
    50/200 and K (= the dense flat packed scan at the same geometry, the
    ``flat_*`` rows); and on the bpd=2 IVF-packed index a batch size ×
    query groups sweep (Q = 8, 64, 256; groups Q/16 at Q ≥ 64).  ``--fast``:
    N=131,072, K=1024, the residual SAQ bpd=2 and PQ M=192, the bpd=2
    ladder."""
    from vq_tpu_torch.data.sampling import chunk_rows_for_bytes
    from vq_tpu_torch.index.ivf import IvfQuantizedIndex, chunked_assign, coarse_pass
    from vq_tpu_torch.index.ivf_packed import IvfPackedFlatIndex
    from vq_tpu_torch.kernels.adc import exact_topk
    from vq_tpu_torch.methods.pq import PQ
    from vq_tpu_torch.methods.rabitq import RaBitQ
    from vq_tpu_torch.methods.saq import SAQ

    dev = run.device
    n = run.size(1_048_576, 131_072, 8192)
    d, nq = (128, 256) if run.smoke else (1536, 256)
    kcl = run.size(4096, 1024, 64)
    m_pq = d // 8  # 192 at D=1536
    xg, qg = corpora.fullrank(n, d, nq, seed=11, device=dev)
    gt = exact_topk(qg, xg, 100, Metric.L2)[1].cpu().numpy()
    # coarse k-means on a max(200k, 64·K)-row sample, random-row init at
    # K=4096 (kernels/kmeans.py), shared by every configuration
    kmc = KMeansConfig(iters=10, max_points_per_centroid=64)
    t0 = time.perf_counter()
    cents = coarse_pass(xg, IVFConfig(num_clusters=kcl, nprobe=200, kmeans=kmc), dev)
    asn = chunked_assign(xg, cents, chunk_rows_for_bytes(d))
    sync(dev)
    out["ivf_coarse_s"] = time.perf_counter() - t0

    def saq(bpd):
        return lambda: SAQ(SAQConfig(bits_per_dim=bpd, use_pca=True), device=dev)

    configs = [("saq_bpd1", saq(1.0)), ("saq_bpd2", saq(2.0)), ("saq_bpd4", saq(4.0)),
               ("pq_m192", lambda: PQ(PQConfig(num_subquantizers=m_pq, num_bits=8,
                                               kmeans=KMeansConfig(iters=10)), device=dev))]
    if run.fast:
        configs = [configs[1], configs[3]]
    reps = 1 if run.smoke else 3
    for name, make in configs:
        idx = IvfQuantizedIndex(make(), IVFConfig(num_clusters=kcl, nprobe=200, kmeans=kmc))
        t0 = time.perf_counter()
        idx.fit(xg, coarse=(cents, asn))
        sync(dev)
        out[f"ivf_{name}_build_s"] = time.perf_counter() - t0
        for nprobe in (50, 200):
            idx.ivf_cfg = dataclasses.replace(idx.ivf_cfg, nprobe=nprobe)
            ids, _ = idx.search_with_scores(qg, k=100)  # warm-up
            times = []
            for _ in range(reps):  # each search ends in its result's host copy
                t0 = time.perf_counter()
                ids, _ = idx.search_with_scores(qg, k=100)
                times.append(time.perf_counter() - t0)
            pre = f"ivf_{name}_np{nprobe}"
            out[f"{pre}_qps"] = nq / min(times)
            for kk in (1, 10, 100):
                out[f"{pre}_recall{kk}"] = recall_at_k(gt, ids, kk)
        del idx

    ladder = [("saq_bpd1", saq(1.0)), ("saq_bpd2", saq(2.0)), ("saq_bpd4", saq(4.0)),
              ("rabitq_b2", lambda: RaBitQ(RaBitQConfig(num_bits=2), device=dev))]
    if run.fast:
        ladder = [ladder[1]]
    nb_total = -(-n // 512)
    mk_bpd2 = None
    for lname, lmake in ladder:
        mk = IvfPackedFlatIndex(lmake(), IVFConfig(num_clusters=kcl, nprobe=200, kmeans=kmc),
                                SearchConfig(use_bf16=True))
        t0 = time.perf_counter()
        mk.fit(xg, coarse=(cents, asn))
        sync(dev)
        out[f"ivfpk_{lname}_build_s"] = time.perf_counter() - t0
        # nprobe = K masks every tile in: the dense flat packed scan at the
        # flagship geometry, the "should a user use IVF here?" row
        for nprobe, pre in ((50, f"ivfpk_{lname}_np50"), (200, f"ivfpk_{lname}_np200"),
                            (kcl, f"flat_{lname}")):
            mk.ivf_cfg = dataclasses.replace(mk.ivf_cfg, nprobe=nprobe)
            ids, _ = mk.search_with_scores(qg, k=100)
            tiles = mk.last_tiles_scanned
            wall = mk.sustained_search_s(qg, k=100, reps=reps, outer=reps)
            out[f"{pre}_qps"] = nq / wall
            out[f"{pre}_tiles_frac"] = tiles / nb_total
            for kk in (1, 10, 100):
                out[f"{pre}_recall{kk}"] = recall_at_k(gt, ids, kk)
        if lname == "saq_bpd2":
            mk_bpd2 = mk
        del mk

    # batch size × probe-coherent groups on the bpd=2 index: QPS, the
    # masked-in tile share summed over the groups, recall@100 against the
    # batch's ground truth
    for bs in (8, 64, 256):
        qb, gtb = qg[:bs], gt[:bs]
        cells = [("flat", kcl, 1), ("np50", 50, 1), ("np200", 200, 1)]
        if bs >= 64:
            cells += [("np50", 50, bs // 16), ("np200", 200, bs // 16)]
        for cname, nprobe, ng in cells:
            mk_bpd2.ivf_cfg = dataclasses.replace(mk_bpd2.ivf_cfg, nprobe=nprobe)
            ids, _ = mk_bpd2.search_with_scores(qb, k=100, query_groups=ng)
            tiles = mk_bpd2.last_tiles_scanned
            wall = mk_bpd2.sustained_search_s(qb, k=100, query_groups=ng, reps=reps,
                                              outer=reps)
            pre = f"ivfpk_bs{bs}_{cname}" + (f"_g{ng}" if ng > 1 else "")
            out[f"{pre}_qps"] = bs / wall
            out[f"{pre}_tiles_frac"] = tiles / nb_total
            out[f"{pre}_recall100"] = recall_at_k(gtb, ids, 100)


SECTIONS = ("headline_pq", "recall_gate_pq192", "exactness_assert", "packed_saq_1m",
            "packed_rabitq_1m", "ivf_flagship")


# -------------------------------------------------------------------- main
def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m vq_tpu_torch.bench.headline",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, help="headline rows (default 100,000; smoke 2,048)")
    p.add_argument("--d", type=int, help="headline width (default 1536; smoke 128)")
    p.add_argument("--q", type=int, help="headline queries (default 1024; smoke 16)")
    p.add_argument("--tile", type=int, default=16384, help="scan_codes_topk tile_rows")
    p.add_argument("--fast", action="store_true", help="the 1M sections at N=131,072")
    p.add_argument("--smoke", action="store_true", help="every section at tiny sizes")
    p.add_argument("--out", help="the full record's path (default results/headline*.json)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Run every section, each on its own; write the full record, print the
    compact one last → 0, or 1 when a section failed, the exactness assert
    is false or the gate is under its floor."""
    a = parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(a.device)  # raises without a card unless --device cpu
    run = Run(device=dev, n=a.n or (2048 if a.smoke else 100_000),
              d=a.d or (128 if a.smoke else 1536), nq=a.q or (16 if a.smoke else 1024),
              tile=a.tile, fast=a.fast, smoke=a.smoke)
    out, errors = {}, {}
    try:
        out["card_name"], out["card_power_limit"] = card(dev)
    except (OSError, subprocess.CalledProcessError) as e:
        out["card_name"] = out["card_power_limit"] = None
        errors["card"] = f"{type(e).__name__}: {e}"
    for name in SECTIONS:
        t0 = time.perf_counter()
        try:
            globals()[name](out, run)
        except Exception as e:  # noqa: BLE001 — recorded, and the exit code is 1
            errors[name] = f"{type(e).__name__}: {e}"
            traceback.print_exc()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        print(f"[headline] {name}: {time.perf_counter() - t0:.3f} s"
              + (f" FAILED {errors[name]}" if name in errors else ""), file=sys.stderr,
              flush=True)
    out["errors"] = errors
    mode = "_smoke" if a.smoke else ("_fast" if a.fast else "")
    path = Path(a.out) if a.out else ROOT / "results" / f"headline{mode}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"full results ({len(out)} fields) -> {path}", file=sys.stderr)
    compact = {k: out[k] for k in COMPACT_KEYS if k in out}
    compact.update(errors=errors, card_name=out["card_name"],
                   card_power_limit=out["card_power_limit"], full_results=str(path))
    print(json.dumps(compact), flush=True)
    gate = out.get("recall_gate_pq192")
    if errors:
        print(f"FATAL: sections failed: {sorted(errors)}", file=sys.stderr)
        return 1
    if not out.get("assert_ok"):
        print("FATAL: kernel exactness assert failed: " + out.get("assert_detail", ""),
              file=sys.stderr)
        return 1
    if gate is None or gate < RECALL_GATE_PQ192_FLOOR:
        print(f"FATAL: recall gate pq192 {gate} < {RECALL_GATE_PQ192_FLOOR}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
