"""Parameter-sweep harness — counterpart of ``vq_tpu/bench/sweep.py``.

Grid over method hyperparameters on one dataset, fit → compress →
decompress → metrics → SQLite.  Recall / rank-distortion / QPS all come
from ONE search pass on ``device`` (the card unless the caller asks for
the CPU): the flat index's scan, through the port's kernels on the card.
The codes stay on the device; the host metrics get numpy.
"""

from __future__ import annotations

import itertools
import time
import uuid
from typing import Any, Dict, Iterable, List, Optional

from vq_tpu_torch.bench.registry import build_quantizer
from vq_tpu_torch.core.config import Metric, SearchConfig
from vq_tpu_torch.data.datasets import Dataset, get_dataset
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.metrics.distortion import compute_distortion, reconstruction_mse
from vq_tpu_torch.metrics.pairwise import compute_pairwise_distortion
from vq_tpu_torch.metrics.performance import measure_qps, time_compress, time_decompress
from vq_tpu_torch.metrics.rank import compute_rank_distortion
from vq_tpu_torch.metrics.recall import recall_at_k
from vq_tpu_torch.utils.run_logger import log_run


def generate_configs(method: str, grid: Optional[Dict[str, Iterable]] = None) -> List[Dict[str, Any]]:
    """Expand a hyperparameter grid for one method.

    Defaults mirror the reference's generators (sweep.py:221-305):
    PQ/OPQ M∈{8,16,32}×B=8, SQ bits∈{4,8,16}, RaBitQ bits∈{1},
    extended_rabitq bits∈{2,4}, SAQ bpd∈{1,2,4}, rankaware bpd∈{1,2,4}.
    """
    defaults: Dict[str, Dict[str, Iterable]] = {
        "pq": {"M": [8, 16, 32], "B": [8]},
        "opq": {"M": [8, 16, 32], "B": [8]},
        "sq": {"bits": [4, 8, 16]},
        "rabitq": {"bits": [1]},
        "extended_rabitq": {"bits": [2, 4]},
        "saq": {"bpd": [1.0, 2.0, 4.0]},
        "lvq": {"bits": [4, 8]},
        "rankaware": {"bpd": [1.0, 2.0, 4.0]},
        "perdim_mse": {"bpd": [1.0, 2.0, 4.0]},
    }
    g = dict(defaults.get(method, {}))
    if grid:
        g.update(grid)
    if not g:
        return [{}]
    keys = sorted(g)
    return [dict(zip(keys, vals)) for vals in itertools.product(*(g[k] for k in keys))]


def run_single_config(
    data: Dataset,
    method: str,
    params: Dict[str, Any],
    k: int = 10,
    num_queries: int = 100,
    metric: Metric = Metric.L2,
    mse_sample: int = 10000,
    db_path: Optional[str] = None,
    sweep_id: Optional[str] = None,
    log: bool = True,
    use_bf16: bool = True,
    device=None,
) -> Dict[str, Any]:
    """Fit one (method, params) cell on ``device`` and compute the full
    metric set (reference _run_single_config, sweep.py:390-517)."""
    t0 = time.perf_counter()
    model = build_quantizer(method, data.dim, device=device, **dict(params))
    model.fit(data.vectors)
    fit_time = time.perf_counter() - t0

    codes, compress_time = time_compress(model, data.vectors)
    sample = min(mse_sample, len(data.vectors))
    rec_sample, decompress_time = time_decompress(model, codes[:sample])
    xs = data.vectors[:sample]

    index = FlatQuantizedIndex(model, SearchConfig(metric=metric, use_bf16=use_bf16))
    index.fit(data.vectors)

    queries = data.queries[:num_queries]
    gt = data.ground_truth[:num_queries]
    kmax = min(max(k, 100), data.num_vectors, gt.shape[1])
    ids, _ = index.search_with_scores(queries, k=kmax)

    qps = measure_qps(index, queries, k=k)

    metrics: Dict[str, Any] = {
        "fit_time_s": fit_time,
        "compress_time_s": compress_time,
        "decompress_time_s": decompress_time,
        "distortion": compute_distortion(xs, rec_sample),
        "mse": reconstruction_mse(xs, rec_sample),
        "pairwise_distortion": compute_pairwise_distortion(xs, rec_sample)["mean"],
        "rank_distortion": compute_rank_distortion(gt, ids, k=k),
        "recall@10": recall_at_k(gt, ids, 10),
        "compression_ratio": model.get_compression_ratio(data.vectors),
        "code_bytes_per_vector": model.code_bytes_per_vector(),
        **qps,
    }
    if gt.shape[1] >= 100 and kmax >= 100:
        metrics["recall@100"] = recall_at_k(gt, ids, 100)

    if log:
        log_run(
            method=method,
            dataset=data.name,
            metrics=metrics,
            config=dict(params),
            sweep_id=sweep_id,
            db_path=db_path,
        )
    return metrics


def sweep(
    dataset: str = "dummy",
    methods: Iterable[str] = ("pq",),
    grid: Optional[Dict[str, Dict[str, Iterable]]] = None,
    k: int = 10,
    num_queries: int = 100,
    metric: Metric = Metric.L2,
    db_path: Optional[str] = None,
    data: Optional[Dataset] = None,
    use_bf16: bool = True,
    verbose: bool = True,
    device=None,
) -> List[Dict[str, Any]]:
    """Run the full grid for several methods on one dataset.

    sweep_id format `sweep_{ts}_{uuid8}` for plot filtering (reference
    sweep.py:111)."""
    if data is None:
        data = get_dataset(dataset, device=device)
    sweep_id = f"sweep_{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:8]}"
    results = []
    for method in methods:
        for params in generate_configs(method, (grid or {}).get(method)):
            if verbose:
                print(f"[{sweep_id}] {method} {params} ...", flush=True)
            m = run_single_config(
                data, method, params, k=k, num_queries=num_queries,
                metric=metric, db_path=db_path, sweep_id=sweep_id,
                use_bf16=use_bf16, device=device,
            )
            if verbose:
                print(
                    f"  recall@10={m['recall@10']:.4f} mse={m['mse']:.3e} "
                    f"comp={m['compression_ratio']:.1f}x qps={m['qps']:.0f}",
                    flush=True,
                )
            results.append({"method": method, "params": params, "metrics": m})
    return results
