"""Quantizer benchmark study — counterpart of ``vq_tpu/bench/study.py``.

YAML StudyConfig → per (method, bpd) cell: fit → exact search over
reconstructions under the normalized-IP metric q·x̂/‖x‖ → recall@ks vs
exact GT + reconstruction MSE → DataFrame → timestamped CSV (the
reference's quantizer_study.py:37-146).

On ``device`` (the card unless the caller asks for the CPU): GT and the
per-method search are ONE scan each; the codes stay on the device, and the
packed methods (SAQ, RaBitQ, RankAware) scan through the packed kernel's
NIP path over a norm-ordered cache.

Compression accounting matches the reference adapter: +4 bytes/vector norm
side-channel on top of the method's code bytes
(benchmarks/quantizer_adapters.py:17 NORM_SIDECHANNEL_BYTES).  pandas, yaml
and matplotlib are soft imports.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from vq_tpu_torch._device import as_f32, resolve_device
from vq_tpu_torch.bench.registry import build_quantizer
from vq_tpu_torch.core.config import Metric
from vq_tpu_torch.data.io import load_fvecs
from vq_tpu_torch.kernels.adc import exact_topk
from vq_tpu_torch.metrics.distortion import reconstruction_mse
from vq_tpu_torch.metrics.recall import recall_at_ks

NORM_SIDECHANNEL_BYTES = 4  # reference quantizer_adapters.py:17

# study method aliases → registry method + params
# (reference method_registry_saq.py:20-74's study methods: saq_paper =
# CAQ + DP + uniform grid; ours = CAQ + greedy + derived Lloyd codebooks;
# ours_exact = ours with exact-DP codebooks; rankaware family defaults to
# Lloyd codebooks + FFD packing, *_exact variants use the optimal-DP
# codebook)
STUDY_METHODS: Dict[str, Tuple[str, Dict]] = {
    "pq": ("pq", {}),
    "opq": ("opq", {}),
    "sq": ("sq", {}),
    "rabitq": ("extended_rabitq", {}),
    "lvq": ("lvq", {}),
    "saq_paper": ("saq", {"allocator": "dp", "codebook": "uniform"}),
    "ours": ("saq", {"allocator": "greedy", "codebook": "lloyd"}),
    "ours_exact": ("saq", {"allocator": "greedy", "codebook": "exact"}),
    "rankaware": (
        "rankaware", {"alpha": 0.5, "codebook": "lloyd", "packing": "ffd"}
    ),
    "perdim_mse": (
        "rankaware", {"alpha": 0.0, "codebook": "lloyd", "packing": "ffd"}
    ),
    "rankaware_exact": (
        "rankaware", {"alpha": 0.5, "codebook": "exact", "packing": "ffd"}
    ),
    "perdim_mse_exact": (
        "rankaware", {"alpha": 0.0, "codebook": "exact", "packing": "ffd"}
    ),
}


@dataclass
class StudyConfig:
    """YAML-bound study configuration (reference study_config.py:14-35)."""

    base_path: str = ""
    query_path: str = ""
    dataset: str = "study"
    methods: Sequence[str] = ("pq", "ours", "saq_paper")
    bpd: Sequence[float] = (1.0, 2.0, 4.0)
    ks: Sequence[int] = (1, 10, 100)
    chunk_size: int = 100_000
    mse_sample: int = 10_000
    output_dir: str = "results"
    plot: bool = False


def load_study_config(path: str) -> StudyConfig:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    known = {f.name for f in StudyConfig.__dataclass_fields__.values()}
    return StudyConfig(**{k: v for k, v in raw.items() if k in known})


def _study_params(method: str, bpd: float, dim: int) -> Tuple[str, Dict]:
    base, extra = STUDY_METHODS.get(method, (method, {}))
    params = dict(extra)
    if base in ("pq", "opq"):
        params.setdefault("bpd", bpd)
    elif base == "sq":
        params.setdefault("bits", 4 if bpd <= 4 else (8 if bpd <= 8 else 16))
    elif base in ("rabitq", "extended_rabitq", "lvq"):
        params.setdefault("bits", max(1, min(8, int(round(bpd)))))
    else:  # saq / rankaware families take a real-valued bpd
        params.setdefault("bpd", bpd)
    return base, params


def run_study_arrays(
    x: np.ndarray,
    queries: np.ndarray,
    methods: Sequence[str],
    bpds: Sequence[float],
    ks: Sequence[int] = (1, 10, 100),
    mse_sample: int = 10_000,
    verbose: bool = True,
    device=None,
) -> "pd.DataFrame":
    """The study loop (reference quantizer_study.py:37-93) on ``device``."""
    import pandas as pd

    dev = resolve_device(device)
    x = np.asarray(x, dtype=np.float32)
    queries = np.asarray(queries, dtype=np.float32)
    n, d = x.shape
    kmax = max(ks)

    norms = np.maximum(np.linalg.norm(x, axis=1), 1e-12).astype(np.float32)
    xd = as_f32(x, dev)
    qd = as_f32(queries, dev)
    norms_d = as_f32(norms, dev)
    _, gt = exact_topk(qd, xd, k=min(kmax, n), metric=Metric.NIP, norms=norms_d)
    gt = gt.cpu().numpy()

    rows = []
    for method in methods:
        for bpd in bpds:
            t0 = time.perf_counter()
            base, params = _study_params(method, bpd, d)
            model = build_quantizer(base, d, device=dev, **params)
            model.fit(x)
            codes = model.compress(x)
            # packed scan cache (norm-ordered, real norms baked in): the
            # SAQ/RaBitQ/RankAware rows run the packed kernel's NIP path
            # on the card — the same path serving uses; methods without a
            # packed layout return None and take the plain scan
            # (reference exact_search.py:4-8 is always the dense path)
            cache = model.prepare_scan(codes, norms=norms_d,
                                       num_queries=len(queries))
            _, ids = model.scan_topk(
                qd, codes, min(kmax, n), Metric.NIP, norms=norms_d,
                cache=cache,
            )
            recalls = recall_at_ks(gt, ids.cpu().numpy(), ks)
            sample = min(mse_sample, n)
            rec = model.decompress(codes[:sample])
            mse = reconstruction_mse(x[:sample], rec)
            code_bytes = model.code_bytes_per_vector() + NORM_SIDECHANNEL_BYTES
            row = {
                "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
                "method": method,
                "bpd": bpd,
                "mse": mse,
                "compression": d * 4.0 / code_bytes,
                "code_bytes": code_bytes,
                "fit_s": time.perf_counter() - t0,
            }
            for k, r in recalls.items():
                row[f"recall@{k}"] = r
            rows.append(row)
            if verbose:
                rs = " ".join(f"R@{k}={v:.4f}" for k, v in recalls.items())
                print(f"[study] {method} bpd={bpd}: {rs} mse={mse:.3e}", flush=True)
    return pd.DataFrame(rows)


def run_study(cfg: StudyConfig, x: Optional[np.ndarray] = None,
              queries: Optional[np.ndarray] = None, device=None) -> str:
    """Load fvecs, run the grid on ``device``, write results_{ts}.csv,
    optionally plot."""
    if x is None:
        x = load_fvecs(cfg.base_path)
    if queries is None:
        queries = load_fvecs(cfg.query_path)
    df = run_study_arrays(
        x, queries, cfg.methods, cfg.bpd, ks=tuple(cfg.ks),
        mse_sample=cfg.mse_sample, device=device,
    )
    os.makedirs(cfg.output_dir, exist_ok=True)
    out = os.path.join(
        cfg.output_dir, f"results_{time.strftime('%Y%m%d_%H%M%S')}.csv"
    )
    df.to_csv(out, index=False)
    print(f"wrote {len(df)} rows to {out}")
    if cfg.plot:
        pareto_curves(df, os.path.join(cfg.output_dir, "pareto.png"), cfg.ks)
    return out


def pareto_curves(df, out_path: str, ks: Sequence[int] = (1, 10, 100)) -> str:
    """recall@k-vs-compression + MSE-vs-compression panels
    (reference benchmarks/study_plots.py:12-42)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ks = [k for k in ks if f"recall@{k}" in df.columns]
    fig, axes = plt.subplots(1, len(ks) + 1, figsize=(4.5 * (len(ks) + 1), 4))
    for ax, k in zip(axes[:-1], ks):
        for method, g in df.groupby("method"):
            g = g.sort_values("compression")
            ax.plot(g["compression"], g[f"recall@{k}"], "o-", label=method)
        ax.set_xlabel("compression ×")
        ax.set_ylabel(f"recall@{k}")
        ax.set_xscale("log")
        ax.grid(alpha=0.3)
    axes[0].legend(fontsize=7)
    ax = axes[-1]
    for method, g in df.groupby("method"):
        g = g.sort_values("compression")
        ax.plot(g["compression"], g["mse"], "o-", label=method)
    ax.set_xlabel("compression ×")
    ax.set_ylabel("reconstruction MSE")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
