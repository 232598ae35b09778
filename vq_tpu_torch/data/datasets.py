"""Dataset container and loaders — counterpart of ``vq_tpu/data/datasets.py``.

A ``Dataset`` holds numpy vectors, queries and ground truth, as the JAX
package's does.  Ground truth is the port's exact scan
(``kernels/adc.py::exact_topk``) on ``device`` — the card unless the
caller asks for the CPU.  ``load_dummy_dataset`` draws from numpy's
generator, so its rows are bit-equal to the JAX package's;
``load_planted_dataset`` is generated on the device from a
``torch.Generator`` (the same algorithm as the JAX package's, other
numbers).  Real embedding sets are read from pre-materialised .npy /
.fvecs files; HuggingFace streaming loaders sit behind a soft import in
``data/hf_loaders.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vq_tpu_torch._device import as_f32, device_of, make_generator, resolve_device
from vq_tpu_torch.core.config import Metric
from vq_tpu_torch.data.io import load_fvecs, load_ivecs


@dataclass
class Dataset:
    """Vectors + queries + ground truth (numpy on the host); the ground
    truth, when not given, is computed on ``device``."""

    name: str
    vectors: np.ndarray  # (N, D) float32
    queries: np.ndarray  # (nq, D) float32
    ground_truth: Optional[np.ndarray] = None  # (nq, k) int — best-first ids
    metric: Metric = Metric.L2
    gt_k: int = 100
    device: Optional[str] = None

    def __post_init__(self):
        self.vectors = np.asarray(self.vectors, dtype=np.float32)
        self.queries = np.asarray(self.queries, dtype=np.float32)
        if self.ground_truth is None and len(self.vectors) and len(self.queries):
            self.ground_truth = compute_ground_truth(
                self.vectors, self.queries, k=min(self.gt_k, len(self.vectors)),
                metric=self.metric, device=self.device,
            )

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def num_vectors(self) -> int:
        return self.vectors.shape[0]


def compute_ground_truth(
    vectors,
    queries,
    k: int = 100,
    metric: Metric = Metric.L2,
    batch_queries: int = 1024,
    device=None,
) -> np.ndarray:
    """Exact brute-force k-NN on ``device`` (default: a tensor corpus's
    device, the card for numpy).  The corpus goes to the device once;
    queries are batched so the scores buffer stays bounded."""
    from vq_tpu_torch.kernels.adc import exact_topk

    dev = device_of(vectors, device)
    xs = as_f32(vectors, dev)
    out = np.empty((len(queries), k), dtype=np.int32)
    for start in range(0, len(queries), batch_queries):
        qb = as_f32(queries[start : start + batch_queries], dev)
        _, idx = exact_topk(qb, xs, k, metric=metric)
        out[start : start + len(qb)] = idx.cpu().numpy()
    return out


def load_dummy_dataset(
    num_vectors: int = 10000,
    dim: int = 128,
    num_queries: int = 100,
    seed: int = 0,
    metric: Metric = Metric.L2,
    normalized: bool = False,
    device=None,
) -> Dataset:
    """Synthetic seeded Gaussian data, drawn on the host as the JAX
    package draws it (bit-equal rows)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((num_vectors, dim), dtype=np.float32)
    q = rng.standard_normal((num_queries, dim), dtype=np.float32)
    if normalized:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return Dataset(name=f"dummy-{num_vectors}x{dim}", vectors=x, queries=q, metric=metric,
                   device=device)


def planted_arrays(num_vectors: int, dim: int, num_queries: int, rank: int = 32,
                   cluster_size: int = 10, spread: float = 0.5, seed: int = 0,
                   device=None):
    """(x (N, D), q (nq, D)) f32 tensors on ``device`` (default: the card):
    a rank-`rank` manifold in `dim` dimensions, N/cluster_size "documents"
    × cluster_size variants, unit-normalized rows; queries are fresh
    variants of random documents."""
    dev = resolve_device(device)
    g = make_generator(seed, dev)
    kc = max(1, num_vectors // cluster_size)
    a = torch.randn((rank, dim), generator=g, device=dev)
    a = a * (1.0 + torch.arange(dim, device=dev)) ** -0.5
    cents = torch.randn((kc, rank), generator=g, device=dev)
    z = cents[torch.arange(num_vectors, device=dev) % kc] + spread * torch.randn(
        (num_vectors, rank), generator=g, device=dev)
    qdoc = torch.randint(0, kc, (num_queries,), generator=g, device=dev)
    zq = cents[qdoc] + spread * torch.randn((num_queries, rank), generator=g, device=dev)
    x, q = z @ a, zq @ a
    return (x / torch.linalg.norm(x, dim=1, keepdim=True),
            q / torch.linalg.norm(q, dim=1, keepdim=True))


def load_planted_dataset(
    num_vectors: int = 100_000,
    dim: int = 1536,
    num_queries: int = 1024,
    rank: int = 32,
    cluster_size: int = 10,
    spread: float = 0.5,
    seed: int = 0,
    metric: Metric = Metric.L2,
    device=None,
) -> Dataset:
    """Low-intrinsic-dimension corpus with planted near-duplicate
    neighborhoods (``planted_arrays``), generated on ``device`` and kept
    as numpy: the structure real embedding sets have, where
    dbpedia-level recall (~0.8 at 1 bit/dim) is reachable.  Bit-stable for
    a given (shape, seed, device)."""
    x, q = planted_arrays(num_vectors, dim, num_queries, rank, cluster_size, spread, seed,
                          device)
    return Dataset(
        name=f"planted-{num_vectors}x{dim}",
        vectors=x.cpu().numpy(),
        queries=q.cpu().numpy(),
        metric=metric,
        device=device,
    )


def load_npy_dataset(
    base_path: str,
    query_path: Optional[str] = None,
    gt_path: Optional[str] = None,
    name: Optional[str] = None,
    num_queries: int = 1000,
    metric: Metric = Metric.L2,
    device=None,
) -> Dataset:
    """.npy corpus (+ optional queries/GT).  Without a query file the last
    `num_queries` rows are split off as queries."""
    base = np.load(base_path, mmap_mode="r")
    if query_path:
        queries = np.load(query_path)
        vectors = np.asarray(base, dtype=np.float32)
    else:
        vectors = np.asarray(base[:-num_queries], dtype=np.float32)
        queries = np.asarray(base[-num_queries:], dtype=np.float32)
    gt = np.load(gt_path) if gt_path else None
    return Dataset(
        name=name or os.path.basename(base_path),
        vectors=vectors,
        queries=np.asarray(queries, dtype=np.float32),
        ground_truth=gt,
        metric=metric,
        device=device,
    )


def load_fvecs_dataset(
    base_path: str,
    query_path: str,
    gt_path: Optional[str] = None,
    name: Optional[str] = None,
    metric: Metric = Metric.NIP,
    device=None,
) -> Dataset:
    """fvecs base/query pair — the study pipeline's input format."""
    vectors = load_fvecs(base_path)
    queries = load_fvecs(query_path)
    gt = load_ivecs(gt_path) if gt_path else None
    return Dataset(
        name=name or os.path.basename(base_path),
        vectors=vectors,
        queries=queries,
        ground_truth=gt,
        metric=metric,
        device=device,
    )


# Registry of named datasets. Entries resolve lazily; real datasets look
# for pre-materialised files under $VQ_DATA_DIR.
def get_dataset(name: str, data_dir: Optional[str] = None, device=None, **kw) -> Dataset:
    data_dir = data_dir or os.environ.get("VQ_DATA_DIR", "data")
    kw["device"] = device
    if name in ("dummy", "demo_sweep"):
        return load_dummy_dataset(**kw)
    if name.startswith("dummy-"):  # e.g. dummy-20000x256
        n, d = name.split("-", 1)[1].split("x")
        return load_dummy_dataset(num_vectors=int(n), dim=int(d), **kw)
    if name.startswith("planted-"):  # e.g. planted-100000x1536
        n, d = name.split("-", 1)[1].split("x")
        return load_planted_dataset(num_vectors=int(n), dim=int(d), **kw)
    # dbpedia-100k / dbpedia-1m / dbpedia-3072 / msmarco-* resolve to files
    candidates = [
        (os.path.join(data_dir, f"{name}_base.npy"), os.path.join(data_dir, f"{name}_query.npy")),
        (os.path.join(data_dir, name, "base.npy"), os.path.join(data_dir, name, "query.npy")),
        (os.path.join(data_dir, name, "base.fvecs"), os.path.join(data_dir, name, "query.fvecs")),
    ]
    for base, query in candidates:
        if os.path.exists(base):
            q = query if os.path.exists(query) else None
            gt_npy = base.replace("base", "gt").replace(".fvecs", ".npy")
            gt = gt_npy if os.path.exists(gt_npy) else None
            if base.endswith(".fvecs"):
                return load_fvecs_dataset(base, query, gt_path=gt, name=name, **kw)
            return load_npy_dataset(base, query_path=q, gt_path=gt, name=name, **kw)
    raise FileNotFoundError(
        f"dataset {name!r}: no files found under {data_dir} "
        f"(expected {name}_base.npy / {name}/base.npy / {name}/base.fvecs); "
        f"use scripts to pre-materialise, or the 'dummy' datasets"
    )
