"""IVF benchmark runner → timestamped CSV — counterpart of
``vq_tpu/bench/ivf_bench.py``.

Method-keyed runners over a dataset at several bits-per-dim budgets on
``device`` (the card unless the caller asks for the CPU), recall/QPS/memory
per row, per-method exception isolation (a runner that raises leaves its
message in the row's ``error`` column and the sweep goes on; the reference
ivf_benchmark.py:418-435), bpd→M conversion for PQ.
"""

from __future__ import annotations

import csv
import os
import time
import traceback
from typing import Dict, Iterable, List, Optional

from vq_tpu_torch.bench.registry import bpd_to_pq_m
from vq_tpu_torch.core.config import (
    IVFConfig,
    KMeansConfig,
    Metric,
    OPQConfig,
    PQConfig,
    RaBitQConfig,
    SAQConfig,
    SearchConfig,
    SQConfig,
)
from vq_tpu_torch.data.datasets import Dataset, get_dataset
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.index.ivf import IvfQuantizedIndex
from vq_tpu_torch.metrics.performance import measure_qps
from vq_tpu_torch.metrics.recall import recall_at_k


def timestamped_output_path(path: str) -> str:
    """Never clobber existing results (reference run_benchmarks.py:104-115)."""
    base, ext = os.path.splitext(path)
    return f"{base}_{time.strftime('%Y%m%d_%H%M%S')}{ext or '.csv'}"


def _build_index(method: str, d: int, bpd: float, num_clusters: int, nprobe: int,
                 metric: Metric, device=None):
    km = KMeansConfig(iters=20)
    ivf = IVFConfig(num_clusters=num_clusters, nprobe=nprobe, kmeans=km)
    sc = SearchConfig(metric=metric)
    if method == "pq_flat":
        from vq_tpu_torch.methods.pq import PQ

        m = bpd_to_pq_m(bpd, d, 8)
        return FlatQuantizedIndex(PQ(PQConfig(m, 8, km), device=device), sc)
    if method == "sq_flat":
        from vq_tpu_torch.methods.sq import SQ

        bits = 4 if bpd <= 4 else (8 if bpd <= 8 else 16)
        return FlatQuantizedIndex(SQ(SQConfig(bits), device=device), sc)
    if method == "opq_flat":
        from vq_tpu_torch.methods.opq import OPQ

        m = bpd_to_pq_m(bpd, d, 8)
        return FlatQuantizedIndex(OPQ(OPQConfig(m, 8, kmeans=km), device=device), sc)
    if method == "rabitq":
        from vq_tpu_torch.methods.rabitq import RaBitQ

        return FlatQuantizedIndex(RaBitQ(RaBitQConfig(max(1, int(round(bpd)))), device=device),
                                  sc)
    if method == "rabitq_ivf":
        from vq_tpu_torch.methods.rabitq import RaBitQ

        return IvfQuantizedIndex(RaBitQ(RaBitQConfig(max(1, int(round(bpd)))), device=device),
                                 ivf, sc)
    if method == "ivf_pq":
        from vq_tpu_torch.methods.pq import PQ

        m = bpd_to_pq_m(bpd, d, 8)
        return IvfQuantizedIndex(PQ(PQConfig(m, 8, km), device=device), ivf, sc)
    if method == "saq":
        from vq_tpu_torch.methods.saq import SAQ

        return IvfQuantizedIndex(SAQ(SAQConfig(bits_per_dim=bpd), device=device), ivf, sc)
    if method == "saq_flat":
        from vq_tpu_torch.methods.saq import SAQ

        return FlatQuantizedIndex(SAQ(SAQConfig(bits_per_dim=bpd), device=device), sc)
    if method == "saq_ivf_packed":
        # probed-TILE packed IVF (index/ivf_packed.py): IVF routing as a
        # tile mask over the packed kernel's gather mode.  Reference
        # runner-table parity: benchmarks/ivf_benchmark.py:351-359.
        from vq_tpu_torch.index.ivf_packed import IvfPackedFlatIndex
        from vq_tpu_torch.methods.saq import SAQ

        return IvfPackedFlatIndex(SAQ(SAQConfig(bits_per_dim=bpd), device=device), ivf, sc)
    if method == "rabitq_ivf_packed":
        from vq_tpu_torch.index.ivf_packed import IvfPackedFlatIndex
        from vq_tpu_torch.methods.rabitq import RaBitQ

        return IvfPackedFlatIndex(
            RaBitQ(RaBitQConfig(max(1, int(round(bpd)))), device=device), ivf, sc
        )
    raise ValueError(f"unknown ivf-bench method {method!r}")


METHOD_RUNNERS = (
    "pq_flat", "sq_flat", "opq_flat", "rabitq", "rabitq_ivf", "ivf_pq",
    "saq", "saq_flat", "saq_ivf_packed", "rabitq_ivf_packed",
)


def ivf_benchmark(
    dataset: str = "dummy",
    methods: Iterable[str] = ("ivf_pq",),
    k: int = 10,
    bpd: Iterable[float] = (1.0, 2.0, 4.0),
    num_clusters: int = 1024,
    nprobe: int = 32,
    output: str = "ivf_bench_results.csv",
    data_dir: Optional[str] = None,
    data: Optional[Dataset] = None,
    metric: Metric = Metric.L2,
    device=None,
) -> List[Dict]:
    if data is None:
        data = get_dataset(dataset, data_dir=data_dir, device=device)
    out_path = timestamped_output_path(output)
    rows: List[Dict] = []
    for method in methods:
        for b in bpd:
            row: Dict = {
                "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
                "dataset": data.name, "method": method, "bpd": b, "k": k,
                "num_clusters": num_clusters, "nprobe": nprobe,
            }
            try:
                idx = _build_index(method, data.dim, b, num_clusters, nprobe, metric, device)
                t0 = time.perf_counter()
                idx.fit(data.vectors)
                row["build_time_s"] = time.perf_counter() - t0
                ids = idx.search(data.queries, k=k)
                row[f"recall@{k}"] = recall_at_k(data.ground_truth, ids, k)
                row.update(measure_qps(idx, data.queries, k=k))
                row["memory_bytes"] = idx.memory_footprint()
                row["error"] = ""
            except Exception as e:  # per-method isolation, keep sweeping
                row["error"] = f"{type(e).__name__}: {e}"
                traceback.print_exc()
            rows.append(row)
            print({k_: v for k_, v in row.items() if k_ != "timestamp"}, flush=True)

    keys: List[str] = sorted({k_ for r in rows for k_ in r})
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {len(rows)} rows to {out_path}")
    return rows
