"""Streaming (out-of-core) sweep — counterpart of ``vq_tpu/bench/streaming.py``.

Train the quantizer on a bounded subset, then stream the full corpus in
batches through compress on ``device`` (the card unless the caller asks
for the CPU), accumulating batch-weighted MSE — the 53M-corpus path that
never materializes the dataset in RAM.  Each batch's squared error is
summed on the device in f32 and accumulated in Python floats, as the JAX
package does; compress is timed to the codes' copy to the host
(``metrics.performance.time_compress``), so the encode rate never counts
work the card has not finished.

Source of batches: a memory-mapped .npy file per host (or seeded dummy
rows, bit-equal to the JAX package's); HuggingFace streaming sits behind a
soft import in ``data/hf_loaders.py``.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from vq_tpu_torch._device import as_f32
from vq_tpu_torch.bench.registry import build_quantizer
from vq_tpu_torch.core.config import Metric
from vq_tpu_torch.metrics.performance import time_compress
from vq_tpu_torch.utils.run_logger import log_run


def iterate_batches(
    source, batch_size: int, max_vectors: Optional[int] = None
) -> Iterator[np.ndarray]:
    """Batches from an (mmap-able) array-like of shape (N, D)."""
    n = len(source) if max_vectors is None else min(len(source), max_vectors)
    for start in range(0, n, batch_size):
        yield np.asarray(source[start : min(start + batch_size, n)], dtype=np.float32)


def open_streaming_source(dataset: str, data_dir: Optional[str] = None):
    """Resolve a dataset name to a mmap'd row source."""
    data_dir = data_dir or os.environ.get("VQ_DATA_DIR", "data")
    if dataset.startswith("dummy"):
        n, d = 200_000, 64
        if "-" in dataset:
            n, d = (int(v) for v in dataset.split("-", 1)[1].split("x"))
        rng = np.random.default_rng(0)
        return rng.standard_normal((n, d)).astype(np.float32)
    for cand in (
        os.path.join(data_dir, f"{dataset}_base.npy"),
        os.path.join(data_dir, dataset, "base.npy"),
    ):
        if os.path.exists(cand):
            return np.load(cand, mmap_mode="r")
    raise FileNotFoundError(f"streaming dataset {dataset!r} not found under {data_dir}")


def streaming_sweep(
    dataset: str = "dummy",
    methods: Iterable[str] = ("pq",),
    train_size: int = 1_000_000,
    batch_size: int = 100_000,
    max_vectors: Optional[int] = None,
    db_path: Optional[str] = None,
    metric: Metric = Metric.L2,
    data_dir: Optional[str] = None,
    method_params: Optional[Dict[str, Dict]] = None,
    device=None,
) -> List[Dict]:
    source = open_streaming_source(dataset, data_dir)
    d = source.shape[1]
    train = np.asarray(source[: min(train_size, len(source))], dtype=np.float32)

    results = []
    for method in methods:
        params = dict((method_params or {}).get(method, {}))
        model = build_quantizer(method, d, device=device, **params)
        t0 = time.perf_counter()
        model.fit(train)
        fit_time = time.perf_counter() - t0

        sq_err_sum = 0.0
        elem_count = 0
        vec_count = 0
        encode_time = 0.0
        for batch in iterate_batches(source, batch_size, max_vectors):
            codes, dt = time_compress(model, batch)
            encode_time += dt
            rec = model.decompress(codes)
            diff = as_f32(batch, model.device) - rec
            sq_err_sum += float(torch.sum(diff * diff))
            elem_count += diff.numel()
            vec_count += len(batch)

        metrics = {
            "fit_time_s": fit_time,
            "streamed_vectors": vec_count,
            "mse": sq_err_sum / max(elem_count, 1),
            "distortion": sq_err_sum / max(vec_count, 1),
            "encode_vecs_per_s": vec_count / max(encode_time, 1e-9),
            "compression_ratio": model.get_compression_ratio(train[:1]),
        }
        log_run(
            method=method,
            dataset=f"{dataset}-streaming",
            metrics=metrics,
            config=params,
            db_path=db_path,
        )
        print(f"[streaming] {method}: {metrics}", flush=True)
        results.append({"method": method, "metrics": metrics})
    return results
