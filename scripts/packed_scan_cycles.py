#!/usr/bin/env python3
"""Where the packed kernel's time goes, in SM cycles, on one CUDA card.

    python3 scripts/packed_scan_cycles.py [--big]

Builds a copy of ``vq_tpu_torch/csrc`` into a temporary directory with
``clock64()`` counters added to ``packed_scan_kernel`` (thread 0 of each
block, summed over blocks with atomics; the repository's sources are not
touched) and runs the kernel through ``packed_scan_topk`` on chip_smoke.py's
phase-6 corpus (N=100,000 lognormal rows, D=1024, Q=256, L2, the four
configurations, k=10 and 100, bf16 and f32); with ``--big`` also on its
phase-7 SAQ corpus (N=1,048,576, norm-ordered and order-preserving caches).
For each call it prints, per 128-row row tile, the cycles of the stage loop
(dequantization and products), the epilogue (scores and admission) and the
fold; per stage, the work and the barrier; the folds a row tile and their
mean candidate count; and the call's CUDA-event time (median of 5) with the
counters in.  The counters add a few percent to the kernel's time.

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

# (anchor, replacement) pairs; ``_P(i, t)`` adds the cycles since t to counter
# i and restarts t
_DECL = ("namespace {\n\nconstexpr int kThreads",
         "__device__ unsigned long long g_cyc[16];\nnamespace {\n\nconstexpr int kThreads")


def _P(i: int, t: str) -> str:
    return (f"if (tid == 0) atomicAdd(&g_cyc[{i}], (unsigned long long)(clock64() - {t})); "
            f"{t} = clock64();")


_EDITS = [
    _DECL,
    ("      // the row terms' loads stay",
     "      long long t_rt = clock64();\n      // the row terms' loads stay"),
    ("      while (true) {", "      long long t_s = clock64();\n      while (true) {"),
    ("        if (ahead && tid < kTR) scale_s[(ns + 1) & 1][tid] = sc;\n        __syncthreads();",
     "        if (ahead && tid < kTR) scale_s[(ns + 1) & 1][tid] = sc;\n        " + _P(12, "t_s")
     + "\n        __syncthreads();\n        " + _P(13, "t_s")
     + "\n        if (tid == 0) atomicAdd(&g_cyc[14], 1ull);"),
    ("      if (tid < kTR) term_s[tid] = term;",
     "      " + _P(2, "t_rt") + "\n      if (tid < kTR) term_s[tid] = term;"),
    ("      for (int j = warp; j < nq; j += kWarps) {",
     "      " + _P(3, "t_rt") + "\n      for (int j = warp; j < nq; j += kWarps) {"),
    ("        if (nc > 0) {\n          const float kth = warp_merge_sorted(",
     "        if (nc > 0) {\n          if (lane == 0) { atomicAdd(&g_cyc[0], (unsigned long long)nc);"
     " atomicAdd(&g_cyc[1], 1ull); }\n          const float kth = warp_merge_sorted("),
    ("      __syncthreads();\n    }\n  }\n  const int chunks = gridDim.y;",
     "      __syncthreads();\n      if (tid == 0) { atomicAdd(&g_cyc[4], (unsigned long long)"
     "(clock64() - t_rt)); atomicAdd(&g_cyc[6], 1ull); }\n    }\n  }\n"
     "  const int chunks = gridDim.y;"),
    ('extern "C" {\n',
     'extern "C" {\nint vq_cycles_read(unsigned long long* out) { cudaDeviceSynchronize(); '
     'int e = cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc)); unsigned long long z[16] = {}; '
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

    buf = (ctypes.c_ulonglong * 16)()
    for _ in range(2):  # the second call's counters
        pk.packed_scan_topk(**args)
        torch.cuda.synchronize()
        if read(buf) != 0:
            raise RuntimeError("reading the cycle counters failed")
    v = list(buf)
    rt, st, folds = max(v[6], 1), max(v[14], 1), max(v[1], 1)
    ms = cs.cuda_ms(torch, lambda: pk.packed_scan_topk(**args))
    print(f"{tag}: cycles per row tile: stages {v[2] / rt:.0f}, epilogue {v[3] / rt:.0f}, "
          f"fold {v[4] / rt:.0f}; per stage: work {v[12] / st:.0f}, barrier {v[13] / st:.0f}; "
          f"{v[1] / rt:.1f} folds a row tile, mean {v[0] / folds:.1f} candidates; "
          f"{v[6]} row tiles; {ms:.3f} ms with the counters (CUDA events, median of 5)",
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("packed_scan_cycles: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vq_tpu_torch import Metric, SAQConfig
    from vq_tpu_torch.bench import corpora
    from vq_tpu_torch.methods import saq as sq

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        read = build_counted(Path(tmp))
        x, q, _ = corpora.packed_corpus(100_000, 1024, 256, seed=11, device=dev, lognormal=True)
        for tag, args, _, _, _ in cs.packed_configs(torch, x, q, torch.linalg.norm(x, dim=1)):
            for k in (10, 100):
                for bf16 in (True, False):
                    report(torch, cs, read, f"N=100000 {tag} L2 k={k} {'bf16' if bf16 else 'f32'}",
                           args(Metric.L2, k, bf16, False))
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
                    report(torch, cs, read, f"N=1048576 SAQ {name} Q={nq} L2 k={k} bf16",
                           sq.packed_scan_args(saq.plan, saq.params, q[:nq], cache, k, Metric.L2))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
