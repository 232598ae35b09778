"""Native host-side programs of the port (C++ via ctypes) — its own copy of
``vq_tpu/native``: the greedy and DP bit allocators and the exact 1-D
codebook DP (``allocator.cpp``).

The library is built with ``g++`` at first use into ``vq_tpu_torch/_build/``
(git-ignored), never beside the source; its name carries a hash of the
source, and a build goes through a temporary file and a rename, so
concurrent processes never load a half-written library.  Without ``g++``
(or when the build fails) ``available()`` is False and every entry point
returns None: the callers (``methods/saq.py``) then run the port's NumPy
allocators and its own Lloyd.  This is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "allocator.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


def _build() -> Path:
    """Compile the source if its hash has no library yet; raise on failure."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libvq_native_{digest}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir) / lib.name
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-march=native", str(_SRC),
               "-o", str(tmp)]
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if out.returncode != 0:
            raise RuntimeError(out.stderr[-2000:])
        os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None  # no compiler, or it failed: the NumPy fallbacks run
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.vq_allocate_greedy.argtypes = [f64p, i64p, ctypes.c_int64, ctypes.c_int32,
                                       ctypes.c_int64, i64p]
    lib.vq_allocate_dp.argtypes = lib.vq_allocate_greedy.argtypes
    lib.vq_codebook_exact.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32, f32p]
    lib.vq_codebook_exact.restype = ctypes.c_int32
    return lib


def available() -> bool:
    return _load() is not None


def _allocate(fn_name: str, block_mse, block_lens, budget_bits: int,
              max_bits: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    mse = np.ascontiguousarray(block_mse, dtype=np.float64)
    lens = np.ascontiguousarray(block_lens, dtype=np.int64)
    out = np.zeros(len(lens), dtype=np.int64)
    getattr(lib, fn_name)(mse, lens, len(lens), max_bits, budget_bits, out)
    return out


def allocate_greedy_native(block_mse: np.ndarray, block_lens: np.ndarray, budget_bits: int,
                           max_bits: int) -> Optional[np.ndarray]:
    """Native greedy marginal-gain allocator; None without the library."""
    return _allocate("vq_allocate_greedy", block_mse, block_lens, budget_bits, max_bits)


def allocate_dp_native(block_mse: np.ndarray, block_lens: np.ndarray, budget_bits: int,
                       max_bits: int) -> Optional[np.ndarray]:
    """Native exact DP allocator; None without the library."""
    return _allocate("vq_allocate_dp", block_mse, block_lens, budget_bits, max_bits)


def codebook_exact(samples: np.ndarray, num_levels: int, sample_cap: int = 65536,
                   seed: int = 0) -> Optional[np.ndarray]:
    """Exact optimal 1-D k-means levels of ≤ sample_cap samples (the same
    seeded subsample as the JAX package's), by the divide-and-conquer DP;
    None without the library or when the DP refuses the input."""
    lib = _load()
    if lib is None:
        return None
    x = np.asarray(samples, dtype=np.float32).ravel()
    if len(x) > sample_cap:
        x = np.random.default_rng(seed).choice(x, sample_cap, replace=False)
    x = np.ascontiguousarray(np.sort(x))
    out = np.zeros(num_levels, dtype=np.float32)
    if lib.vq_codebook_exact(x, len(x), num_levels, out) != 0:
        return None
    return out
