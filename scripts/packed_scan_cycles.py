#!/usr/bin/env python3
"""Where the packed kernel's bf16 time goes, in SM cycles, on one CUDA card.

    python3 scripts/packed_scan_cycles.py [--big]

Builds a copy of ``vq_tpu_torch/csrc`` into a temporary directory with
``clock64()`` counters added to ``packed_scan_bf16_kernel`` (thread 0 of
each block's consumers and lane 0 of its producer warp, summed over blocks
with atomics; the repository's sources are not touched) and runs the kernel
through ``packed_scan_topk`` on two shapes of the benchmark's SAQ cells,
made from seeded random words with the 53M cell's segment plan ((64, 5),
(64, 4), (320, 3), (256, 2) bits, uniform, 704 dims, L2): 4,194,304 rows at
Q=64 with the prune on (the 53M cell's call, a 64-query tile) and 1,048,576
rows at Q=1024 through a 98.5% tile mask (the IVF cell's, 128-query tiles),
both at k=10; the RaBitQ cell's shape (seeded random words of one "shared"
segment of 1024 dims at B=4, a 16-level table, α and c2 factors, 4,194,304
rows, Q=64, k=10, L2: the shared-table dequant); then chip_smoke.py's
phase-6 corpus (N=100,000 lognormal rows, D=1024, Q=256, the five
configurations, k=10 and 100).  With ``--big`` also its phase-7 SAQ corpus
(N=1,048,576, norm-ordered and order-preserving).

For each call it prints, for each consumer warpgroup, per pass (256 rows
of a tile for one query tile): the waits for a stage's words (the
producers behind), the dequantization, the wgmma issue and wait (the tensor
cores behind), the waits at a pass's start, the cuts (the once-a-tile
update with the published k-th), the scores and admission, the appends,
the barrier after them (the other warps' lag) and the folds; per group
(one m64 tile's k-step) the dequant and wgmma cycles; per stage of the
producers: the waits for a free slot (the consumers behind) and the
copies' issue; and the call's CUDA-event time (median of 5) with the
counters in.

The counters are inserted at source lines this script names; it fails if
one is missing, so it has to follow edits of those lines.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _add(i: int, what: str) -> str:
    """Add `what` to consumer counter i of thread 0 (warpgroup 0) or 128
    (warpgroup 1), kept 16 apart, in the block's shared copy."""
    return (f"if (threadIdx.x == 0 || threadIdx.x == 128) "
            f"s_cyc[{i} + 16 * (threadIdx.x >> 7)] += (unsigned long long)({what});")


def _prod(i: int, what: str) -> str:
    """Add `what` to producer counter i (thread 0 of the producers)."""
    return f"if (threadIdx.x == kCThreads) s_cyc[{i}] += (unsigned long long)({what});"


def _flush(lo: int, hi: int, who: str) -> str:
    """Add the block's counters [lo, hi) to the totals (one thread)."""
    return (f"if ({who}) for (int c = {lo}; c < {hi}; ++c) "
            f"atomicAdd(&g_cyc[c], s_cyc[c]);")


# consumer counters, per warpgroup: 0 pass-start waits, 1 stage waits, 2
# dequant, 3 wgmma (per m64 tile's group), 4 the cuts, 5 scores and
# admission, 6 appends, 7 passes, 8 groups, 9 passes in which some thread
# appended, 10 whole passes, 11 the barrier after the appends and the
# folds; producers: 32 slot waits, 33 copy issue, 34 stages, 35 factor
# waits.  Each block sums them in shared memory, one thread a counter
# range, and adds them to the totals as it ends.
_EDITS = [
    ("namespace {\n\nconstexpr int kTile",
     "__device__ unsigned long long g_cyc[40];\n__shared__ unsigned long long s_cyc[40];\n"
     "namespace {\n\nconstexpr int kTile"),
    ("constexpr size_t kSmemCap = 232448;",  # room for the counters' static shared memory
     "constexpr size_t kSmemCap = 232448 - 1024;"),
    ("  if (tid == 0) {\n    for (int i = 0; i < kMaxStages; ++i) {",
     "  if (tid == 0) for (int c = 0; c < 40; ++c) s_cyc[c] = 0;\n"
     "  if (tid == 0) {\n    for (int i = 0; i < kMaxStages; ++i) {"),
    ("    p.cand_i[o] = fi[j * kbuf + r];\n  }\n}\n",
     "    p.cand_i[o] = fi[j * kbuf + r];\n  }\n  " + _flush(0, 16, "tid == 0") + "\n  "
     + _flush(16, 32, "tid == 128") + "\n}\n"),
    ("    mbar_arrive(full + slot);\n    return;\n  }",
     "    mbar_arrive(full + slot);\n    " + _flush(32, 40, "tid == kCThreads") + "\n    return;\n  }"),
    ("  const KWords<W, KIND, BEFF> kw(v, ws, c);",
     "  long long t_k = clock64();\n  const KWords<W, KIND, BEFF> kw(v, ws, c);"),
    ("    dequant_tile<W, KIND, BEFF>(v, kw, sg, lv, dim0, mt, a);",
     "    dequant_tile<W, KIND, BEFF>(v, kw, sg, lv, dim0, mt, a);\n    "
     + _add(2, "clock64() - t_k") + " " + _add(8, "1") + "\n    t_k = clock64();"),
    ("    wgmma_wait<1>();\n    fence_regs(other);",
     "    wgmma_wait<1>();\n    fence_regs(other);\n    " + _add(3, "clock64() - t_k")
     + "\n    t_k = clock64();"),
    ("    mbar_wait(full + slot, (ps.it / p.stages) & 1);",
     "    long long t_w = clock64();\n    mbar_wait(full + slot, (ps.it / p.stages) & 1);\n    "
     + _add(1, "clock64() - t_w")),
    ("    mbar_wait(full + slot0, (ps.it / S) & 1);",
     "    long long t_top = clock64();\n    mbar_wait(full + slot0, (ps.it / S) & 1);"),
    ("    if (pass == 0 && p.fac_smem) mbar_wait(ffull + fsl, (nt >> 1) & 1);",
     "    if (pass == 0 && p.fac_smem) mbar_wait(ffull + fsl, (nt >> 1) & 1);\n    "
     + _add(0, "clock64() - t_top")),
    ("    if (refresh) cut[tid] = fmaxf(cut[tid], pub);",
     "    long long t_ep = clock64();\n    " + _add(7, "1")
     + "\n    if (refresh) cut[tid] = fmaxf(cut[tid], pub);\n    " + _add(4, "clock64() - t_ep")
     + "\n    t_ep = clock64();"),
    ("    bool any = false;",
     "    " + _add(5, "clock64() - t_ep") + "\n    t_ep = clock64();\n    bool any = false;"),
    ("    if (named_sync_or(kBarConsumer, kCThreads, any)) {",
     "    " + _add(6, "clock64() - t_ep") + "\n    t_ep = clock64();\n"
     "    if (named_sync_or(kBarConsumer, kCThreads, any)) {"),
    ("      fold(kFoldAt);\n      named_sync(kBarConsumer, kCThreads);\n    }\n",
     "      fold(kFoldAt);\n      named_sync(kBarConsumer, kCThreads);\n      " + _add(9, "1")
     + "\n    }\n    " + _add(11, "clock64() - t_ep") + "\n"),
    ("    if (++pass == kPasses) {",
     "    " + _add(10, "clock64() - t_top") + "\n    if (++pass == kPasses) {"),
    ("            mbar_wait(empty + slot, ((it / S) & 1) ^ 1);",
     "            long long t_e = clock64();\n            mbar_wait(empty + slot, ((it / S) & 1) ^ 1);\n"
     "            " + _prod(32, "clock64() - t_e") + " " + _prod(34, "1")
     + "\n            t_e = clock64();"),
    ("            cp_async_mbar_arrive(full + slot);\n",
     "            cp_async_mbar_arrive(full + slot);\n            " + _prod(33, "clock64() - t_e") + "\n"),
    ("        mbar_wait(fempty + fs, ((nt >> 1) & 1) ^ 1);",
     "        long long t_fe = clock64();\n        mbar_wait(fempty + fs, ((nt >> 1) & 1) ^ 1);\n        "
     + _prod(35, "clock64() - t_fe")),
    ('extern "C" {\n',
     'extern "C" {\nint vq_cycles_read(unsigned long long* out) { cudaDeviceSynchronize(); '
     'int e = cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc)); unsigned long long z[40] = {}; '
     'cudaMemcpyToSymbol(g_cyc, z, sizeof(z)); return e; }\n'),
]


def build_counted(tmp: Path):
    """Copy the sources, add the counters, build, and return the reader."""
    from vq_tpu_torch.kernels import _build

    src = tmp / "csrc"
    shutil.copytree(_build.CSRC, src)
    f = src / "packed_scan.cu"
    s = f.read_text()
    for anchor, new in _EDITS:
        if s.count(anchor) != 1:
            raise SystemExit(f"packed_scan_cycles: source line not found once: {anchor!r}")
        s = s.replace(anchor, new)
    f.write_text(s)
    _build.CSRC, _build.BUILD_DIR = src, tmp / "build"
    _build.load_library.cache_clear()
    fn = _build.load_library().vq_cycles_read
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    return fn


def report(torch, cs, read, tag, args) -> None:
    from vq_tpu_torch.kernels import packed_scan as pk

    buf = (ctypes.c_ulonglong * 40)()
    for _ in range(2):  # the second call's counters
        pk.packed_scan_topk(**args)
        torch.cuda.synchronize()
        if read(buf) != 0:
            raise RuntimeError("reading the cycle counters failed")
    v = list(buf)
    ms = cs.cuda_ms(torch, lambda: pk.packed_scan_topk(**args))
    width = pk.scan_width(args["q_cat"].shape[0])
    parts = []
    for wg in (0, 1):
        c = v[16 * wg:16 * wg + 16]
        ps, ks = max(c[7], 1), max(c[8], 1)
        parts.append(
            f"warpgroup {wg} per pass: {c[10] / ps:.0f} in all = stage waits {c[1] / ps:.0f} + "
            f"dequant {c[2] / ps:.0f} + wgmma {c[3] / ps:.0f} + pass-start waits "
            f"{c[0] / ps:.0f} + cuts {c[4] / ps:.0f} + scores {c[5] / ps:.0f} + appends "
            f"{c[6] / ps:.0f} + barrier and folds {c[11] / ps:.0f} ({c[9] / ps:.2f} with a "
            f"candidate) + the rest; per group "
            f"dequant {c[2] / ks:.0f}, wgmma {c[3] / ks:.0f}")
    st = max(v[34], 1)
    print(f"{tag} (width {width}, {v[7]} passes, {v[8]} groups): " + "; ".join(parts)
          + f"; producer per stage: slot waits {v[32] / st:.0f}, copy issue {v[33] / st:.0f}, "
          f"factor waits per tile {2 * v[35] / max(v[7], 1):.0f}; "
          f"{ms:.3f} ms with "
          f"the counters (CUDA events, median of 5)", flush=True)


def cell_corpus(torch, dev, n, seed=5):
    """Seeded random words of the 53M cell's segment plan over n rows, its
    factor layout (4 scales, 4 shifts, a norm) and tile stats that never
    prune; and a maker of packed_scan_topk arguments for nq queries."""
    from vq_tpu_torch.kernels import packed_scan as pk

    g = torch.Generator(device=dev).manual_seed(seed)
    plan = ((5, 64), (4, 64), (3, 320), (2, 256))
    segs = tuple(pk.make_segspec(b, ln, "uniform", s) for s, (b, ln) in enumerate(plan))
    words = tuple(torch.randint(-2**31, 2**31 - 1, (n // sp.u, sp.ln), generator=g, device=dev,
                                dtype=torch.int32) for sp in segs)
    fac = torch.rand((9, n), generator=g, device=dev) * 0.1 + 0.02
    stats = torch.zeros((n // 512, 5), device=dev)
    stats[:, 1] = 1e3
    stats[:, 3] = stats[:, 4] = 1.0

    def args(nq, k, prune=False, tile_mask=None):
        q = torch.randn((nq, 704), generator=g, device=dev) * 0.05
        qp = torch.stack([torch.full((nq,), 1e6, device=dev), torch.ones((nq,), device=dev)], 1)
        return dict(q_cat=q, qa=torch.randn((nq,), generator=g, device=dev), words=words,
                    factors=fac, lv_tables=(), segs=segs, k=k, family="seg", metric_kind="l2",
                    norm_col=8, r2_cols=(4, 5, 6, 7), limit=None, use_bf16=True, prune=prune,
                    tile_stats=stats if prune else None, qprune=qp if prune else None,
                    tile_mask=tile_mask)
    return args


def rabitq_corpus(torch, dev, n, seed=7):
    """Seeded random words of the RaBitQ cell's layout over n rows (one
    "shared" segment of 1024 dims at B=4, a sorted 16-level table, the α
    and c2 factor rows); and a maker of packed_scan_topk arguments for nq
    queries (L2, no prune)."""
    from vq_tpu_torch.kernels import packed_scan as pk

    g = torch.Generator(device=dev).manual_seed(seed)
    seg = pk.make_segspec(4, 1024, "shared", 0)
    words = torch.randint(-2**31, 2**31 - 1, (n // seg.u, seg.ln), generator=g, device=dev,
                          dtype=torch.int32)
    lv = torch.sort(torch.randn((16,), generator=g, device=dev)).values.reshape(1, 16)
    fac = torch.rand((2, n), generator=g, device=dev) * 0.1 + 0.02

    def args(nq, k):
        return dict(q_cat=torch.randn((nq, 1024), generator=g, device=dev) * 0.05,
                    qa=torch.randn((nq,), generator=g, device=dev), words=(words,),
                    factors=fac, lv_tables=(lv,), segs=(seg,), k=k, family="rabitq",
                    metric_kind="l2", norm_col=-1, r2_cols=(1,), limit=None, use_bf16=True,
                    prune=False, tile_stats=None, qprune=None, tile_mask=None)
    return args


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("packed_scan_cycles: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vq_tpu_torch import Metric, SAQConfig
    from vq_tpu_torch.bench import corpora
    from vq_tpu_torch.methods import packed as pr
    from vq_tpu_torch.methods import saq as sq

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        read = build_counted(Path(tmp))
        args = rabitq_corpus(torch, dev, 1 << 22)
        report(torch, cs, read, "N=4194304 RaBitQ B=4 shared Q=64 L2 k=10", args(64, 10))
        del args
        args = cell_corpus(torch, dev, 1 << 22)
        report(torch, cs, read, "N=4194304 53M plan Q=64 L2 k=10 prune", args(64, 10, prune=True))
        del args
        args = cell_corpus(torch, dev, 1 << 20)
        g = torch.Generator(device=dev).manual_seed(6)
        mask = (torch.rand((2048,), generator=g, device=dev) < 0.985).to(torch.int32)
        report(torch, cs, read, "N=1048576 53M plan Q=1024 L2 k=10 98.5% tile mask",
               args(1024, 10, tile_mask=mask))
        del args
        torch.cuda.empty_cache()
        x, q, _ = corpora.packed_corpus(100_000, 1024, 256, seed=11, device=dev, lognormal=True)
        for tag, args, _, _, _ in cs.packed_configs(torch, x, q, torch.linalg.norm(x, dim=1)):
            for k in (10, 100):
                report(torch, cs, read, f"N=100000 {tag} Q=256 L2 k={k}",
                       args(Metric.L2, k, True, False))
        del x, q
        if "--big" in sys.argv:
            x, q, _ = corpora.packed_corpus(1_048_576, 1024, 256, 0, dev)
            saq = sq.SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True)).fit(x)
            codes, norms = saq.compress(x), torch.linalg.norm(x, dim=1)
            del x
            for name, cache in (("norm-ordered", sq.prepare_packed(saq.plan, saq.params, codes,
                                                                    norms=norms, sort_rows=True)),
                                ("order-preserving", saq.prepare_tile_cache(codes, norms=norms))):
                for nq, k in ((256, 10), (256, 100), (8, 100)):
                    report(torch, cs, read, f"N=1048576 SAQ {name} Q={nq} L2 k={k}",
                           pr.packed_scan_args(saq.packed_route(), q[:nq], cache, k, Metric.L2))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
