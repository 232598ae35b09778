"""Build and load the port's CUDA kernels (``vq_tpu_torch/csrc/*.cu``, with
the shared device code of ``csrc/*.cuh``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ctypes.  The build happens at first
use, from the sources in the package only, into ``vq_tpu_torch/_build/``
(git-ignored); the library's name carries a hash of the sources and
headers, so an edited source or header is rebuilt and an unchanged one is
loaded as it is.  A missing ``nvcc`` or a failed compile raises: there is
no fallback.

The grid rule both scan wrappers (``pq_scan.py``, ``packed_scan.py``) size
their launches by lives here too, beside the library whose merge cap
(``vq_merge_cap``) it takes: ``grid_chunks`` and ``merge_groups``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_CUDA_HOME_DEFAULT = "/usr/local/cuda"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _headers():
    return sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    """``nvcc`` from PATH, else ``$CUDA_HOME/bin``, else /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or _CUDA_HOME_DEFAULT
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of vq_tpu_torch cannot be built"
    )


def build_library() -> Path:
    """Compile the sources if their hash has no library yet; return its path.

    One ``nvcc`` per source, all started together, then one link.  The
    compilers' reports (``-Xptxas -v``: registers, shared memory and spills
    per kernel) are kept beside the library as ``<name>.log``.
    """
    srcs = _sources()
    digest = hashlib.sha256()
    for s in srcs + _headers():
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    lib = BUILD_DIR / f"libvq_tpu_torch_{digest.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile into a temporary directory and rename the library: a
    # concurrent build never loads a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{s.stem}.o" for s in srcs]
        cmds = [[nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-o", str(o), str(s)] for s, o in zip(srcs, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        outs = [p.communicate() for p in procs]
        tmp = Path(tmpdir) / lib.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        failed = [(c, o) for c, p, o in zip(cmds, procs, outs) if p.returncode != 0]
        log = "".join(" ".join(c) + "\n" + out + err for c, (out, err) in zip(cmds, outs))
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log += " ".join(link) + "\n" + proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed = [(link, (proc.stdout, proc.stderr))]
        lib.with_suffix(".log").write_text(log)
        if failed:
            cmd, (_, err) = failed[0]
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{err[-4000:]}")
        os.replace(tmp, lib)
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "vq_merge_cap": [],
    "vq_pq_decode_tile_rows": [],
    "vq_pq_decode_stage_dims": [],
    "vq_pq_decode_fold_slots": [_I],
    "vq_pq_table_step_rows": [],
    "vq_pq_table_group": [],
    "vq_pq_table_blocks_per_sm": [_I] * 6,
    "vq_pq_decode_slots": [_I] * 5,
    "vq_pq_decode_scan": [_P] * 15 + [_I] * 11 + [_P],
    "vq_pq_table_scan": [_P] * 10 + [_I] * 12 + [_P],
    "vq_packed_queries_per_block": [],
    "vq_packed_max_segments": [],
    "vq_ordered_neg_inf": [],
    "vq_packed_blocks_per_sm": [_P, _I, _I, _I, _I, _I],
    "vq_packed_stage_dims": [],
    "vq_packed_fold_slots": [],
    "vq_packed_register_table": [_I, _I, _I],
    "vq_packed_scan_topk": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                            _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P],
}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernels' library, with every C
    function's argtypes declared (pointers and the stream as c_void_p)."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


_WAVES = 4  # kernel blocks per resident block slot the chunking aims for


def grid_chunks(slots: int, qblocks: int, nb: int, merge_cap: int, k: int) -> int:
    """Tile chunks per query block of a (qblocks, chunks) grid over ``slots``
    resident blocks (SMs × blocks per SM): one when the query blocks alone
    fill the slots; else enough blocks for _WAVES waves and at most one
    chunk per tile; beyond one wave, rounded down to whole waves (a last,
    partial wave leaves most SMs idle while it runs).  A merge launch sorts
    at most ``merge_cap`` candidates a query, g = merge_cap // k chunk
    lists.  Where g chunks a query block cannot fill the slots (few
    queries, large k), the lists merge in groups of g first
    (``merge_groups``): chunks is then a multiple of g, at most g²."""
    if qblocks >= slots:
        return 1
    g = merge_cap // k
    cap = g if qblocks * g >= slots else g * g
    chunks = max(1, min(-(-_WAVES * slots // qblocks), nb, cap))
    if qblocks * chunks > slots:
        chunks = max(1, qblocks * chunks // slots * slots // qblocks)
    return chunks // g * g if chunks > g else chunks


def merge_groups(chunks: int, merge_cap: int, k: int) -> int:
    """First-level merges a query (0: the chunk lists merge in one launch)."""
    g = merge_cap // k
    return chunks // g if chunks > g else 0
