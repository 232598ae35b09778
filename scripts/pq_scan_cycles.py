#!/usr/bin/env python3
"""Where the PQ decode kernel's time goes, in SM cycles, on one CUDA card.

    python3 scripts/pq_scan_cycles.py [--n N]

Builds a copy of ``vq_tpu_torch/csrc`` into a temporary directory with
``clock64()`` counters added to ``decode_scan_kernel``, the wgmma kernel of
Q > 64 (the producer warpgroup's thread 0 and the consumers' thread 0 of
each block, summed over blocks with atomics; the repository's sources are
not touched) and runs the fused kernel on the headline's corpus
(``bench/corpora.py::powerlaw``, N=1,000,000 rows of D=1536 by default)
coded by PQ M=192 (dsub 8, K=256, codebooks of random corpus rows), L2,
bf16: Q=1024 at k=10 and 100.  For each call it prints, per 128-row row
tile, the producer's cycles (the tile's codes; per stage the wait for a
free slot, issuing the gathers and the query tile's copy, and the wait for
the last stage's gathers to land) and the consumers' (the wait for a full
slot, the wgmma products, the epilogue: each query's cut and the scores,
the fold); the folds a row tile, the queries merged a fold and their mean
candidate count; and the call's CUDA-event time (median of 5) with the
counters in.  The counters add a few percent to the kernel's time.

The counters are inserted at source lines this script names; it fails if
one is missing, so it has to follow edits of those lines.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# counters: producer 0 codes, 1 slot wait, 2 gather, 3 land wait, 4
# stages, 5 tiles; consumer 7 cuts, 8 full wait, 9 products, 10 scores, 11
# fold, 12 tiles, 13 folds, 14 merges (warps), 15 candidates merged
_NAMES = {0: "codes", 1: "slot wait", 2: "gather", 3: "land wait", 7: "cuts", 8: "full wait",
          9: "products", 10: "scores", 11: "fold"}
_DECL = ("namespace {\n\nconstexpr int kThreads",
         "__device__ unsigned long long g_cyc[16];\nnamespace {\n\nconstexpr int kThreads")


def _P(who: str, i: int, t: str) -> str:
    """Add the cycles since t to counter i (thread `who` only), restart t."""
    return (f"if ({who}) atomicAdd(&g_cyc[{i}], (unsigned long long)(clock64() - {t})); "
            f"{t} = clock64();")


_PT, _CT = "pt == 0", "tid == 0"
_EDITS = [
    _DECL,
    # producer
    ("      const uint8_t* tile_codes = p.codes + (size_t)row0 * p.M;\n",
     "      const uint8_t* tile_codes = p.codes + (size_t)row0 * p.M;\n"
     "      long long tp = clock64();\n"
     f"      if ({_PT}) atomicAdd(&g_cyc[5], 1ull);\n"),
    ("      auto code = [&](int r, int m) -> int {",
     "      " + _P(_PT, 0, "tp") + "\n      auto code = [&](int r, int m) -> int {"),
    ("        mbar_wait(empty + slot, ((it / S) & 1) ^ 1);\n",
     "        mbar_wait(empty + slot, ((it / S) & 1) ^ 1);\n        " + _P(_PT, 1, "tp") + "\n"
     f"        if ({_PT}) atomicAdd(&g_cyc[4], 1ull);\n"),
    ("        cp_async_commit();\n        if (pending >= 0) {\n          cp_async_wait<1>();\n"
     "          announce();\n        }\n",
     "        cp_async_commit();\n        " + _P(_PT, 2, "tp") + "\n        if (pending >= 0) {\n"
     "          cp_async_wait<1>();\n          announce();\n        }\n        "
     + _P(_PT, 3, "tp") + "\n"),
    # consumers
    ("      for (int s = 0; s < p.nst; ++s, ++it) {\n        const int slot = it % S;\n"
     "        mbar_wait(full + slot, (it / S) & 1);\n",
     "      long long tc = clock64();\n"
     f"      if ({_CT}) atomicAdd(&g_cyc[12], 1ull);\n"
     "      for (int s = 0; s < p.nst; ++s, ++it) {\n        const int slot = it % S;\n"
     "        " + _P(_CT, 9, "tc") + "\n"
     "        mbar_wait(full + slot, (it / S) & 1);\n        " + _P(_CT, 8, "tc") + "\n"),
    ("      if (lane == 0) release((it - 1) % S);\n      if (!SCORE_ALL) {",
     "      if (lane == 0) release((it - 1) % S);\n      " + _P(_CT, 9, "tc")
     + "\n      if (!SCORE_ALL) {"),
    ("        if (named_sync_or(kBarConsumer, kConsumers, any)) {\n          fold(kFoldAt);\n"
     "          named_sync(kBarConsumer, kConsumers);\n        }\n",
     "        const bool any_ = named_sync_or(kBarConsumer, kConsumers, any);\n        "
     + _P(_CT, 10, "tc") + "\n        if (any_) {\n"
     f"          if ({_CT}) atomicAdd(&g_cyc[13], 1ull);\n"
     "          fold(kFoldAt);\n          named_sync(kBarConsumer, kConsumers);\n          "
     + _P(_CT, 11, "tc") + "\n        }\n"),
    ("        if (nc < max(at, 1)) continue;\n",
     "        if (nc < max(at, 1)) continue;\n        if (lane == 0) { atomicAdd(&g_cyc[14], 1ull); "
     "atomicAdd(&g_cyc[15], (unsigned long long)nc); }\n"),
    ("        named_sync(kBarConsumer, kConsumers);\n      }\n      // epilogue",
     "        named_sync(kBarConsumer, kConsumers);\n        " + _P(_CT, 7, "tc")
     + "\n      }\n      // epilogue"),
    ('extern "C" {\n',
     'extern "C" {\nint vq_cycles_read(unsigned long long* out) { cudaDeviceSynchronize(); '
     'int e = cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc)); unsigned long long z[16] = {}; '
     'cudaMemcpyToSymbol(g_cyc, z, sizeof(z)); return e; }\n'),
]


def build_counted(tmp: Path, csrc: Path):
    """Copy the sources, add the counters, build, and return the reader."""
    from vq_tpu_torch.kernels import _build

    src = tmp / "csrc"
    shutil.copytree(csrc, src)
    f = src / "pq_scan.cu"
    s = f.read_text()
    for anchor, new in _EDITS:
        if s.count(anchor) != 1:
            raise SystemExit(f"pq_scan_cycles: source line not found once: {anchor!r}")
        s = s.replace(anchor, new)
    f.write_text(s)
    _build.CSRC, _build.BUILD_DIR = src, tmp / "build"
    _build.load_library.cache_clear()
    fn = _build.load_library().vq_cycles_read
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    return fn


def report(torch, cs, read, tag, call) -> None:
    buf = (ctypes.c_ulonglong * 16)()
    for _ in range(2):  # the second call's counters
        call()
        torch.cuda.synchronize()
        if read(buf) != 0:
            raise RuntimeError("reading the cycle counters failed")
    v = list(buf)
    pt, ct, st = max(v[5], 1), max(v[12], 1), max(v[4], 1)
    prod = ", ".join(f"{_NAMES[i]} {v[i] / pt:.0f}" for i in range(4))
    cons = ", ".join(f"{_NAMES[i]} {v[i] / ct:.0f}" for i in (8, 9, 7, 10, 11))
    ms = cs.cuda_ms(torch, call)
    print(f"{tag}: cycles a row tile, producer: {prod}; consumers: {cons}; "
          f"{st / pt:.0f} stages a tile; {v[13] / ct:.2f} folds a row tile, "
          f"{v[14] / max(v[13], 1):.1f} queries merged a fold, mean {v[15] / max(v[14], 1):.1f} "
          f"candidates; {v[12]} row tiles; {ms:.3f} ms with the counters (CUDA events, "
          f"median of 5)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("pq_scan_cycles: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vq_tpu_torch.bench import corpora
    from vq_tpu_torch.kernels import _build
    from vq_tpu_torch.kernels import pq_scan as ps
    from vq_tpu_torch.methods.pq import encode_chunked

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        read = build_counted(Path(tmp), _build.CSRC)
        x, q = corpora.powerlaw(args.n, 1536, 1024, seed=0, device=dev)
        cb = cs.random_codebooks(torch, x, 192, 256, seed=192)
        codes = encode_chunked(cb, x)
        del x
        for nq, k in ((1024, 10), (1024, 100)):
            report(torch, cs, read, f"N={args.n} M=192 Q={nq} k={k} L2 bf16",
                   lambda: ps.pq_scan_topk_fused(q[:nq], codes, cb, k))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
