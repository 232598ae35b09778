"""Plot suite over the SQLite runs database — a copy of
``vq_tpu/viz/plot.py`` over the port's ``load_runs``.

Parity with the reference's visualization/plot.py:14-727 seven outputs:
compression-vs-distortion, pairwise distortion, rank distortion, recall
curves (combined + per-method), comparison table, Pareto frontier with
dominance test, and a radar chart.  Reads the same `runs` schema the logger
writes (utils/run_logger.py), filterable by sweep_id.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from vq_tpu_torch.utils.run_logger import load_runs


def _by_method(runs: List[Dict]) -> Dict[str, List[Dict]]:
    out: Dict[str, List[Dict]] = {}
    for r in runs:
        out.setdefault(r["method"], []).append(r)
    return out


def _scatter_by_method(ax, runs, xkey, ykey, logy=False):
    for method, rs in sorted(_by_method(runs).items()):
        xs = [r["metrics"].get(xkey) for r in rs]
        ys = [r["metrics"].get(ykey) for r in rs]
        pts = [(x, y) for x, y in zip(xs, ys) if x is not None and y is not None]
        if not pts:
            continue
        pts.sort()
        ax.plot(*zip(*pts), "o-", label=method, alpha=0.8)
    ax.set_xlabel(xkey)
    ax.set_ylabel(ykey)
    if logy:
        ax.set_yscale("log")
    ax.grid(alpha=0.3)
    ax.legend(fontsize=7)


def pareto_frontier(points: List[tuple]) -> List[tuple]:
    """Non-dominated subset for (maximize x, maximize y) pairs
    (reference plot.py:545-627 dominance test)."""
    out = []
    for p in points:
        if not any(
            (q[0] >= p[0] and q[1] >= p[1] and q != p) for q in points
        ):
            out.append(p)
    return sorted(out)


def plot(
    db_path: Optional[str] = None,
    output_dir: str = "plots",
    sweep_id: Optional[str] = None,
) -> List[str]:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    runs = load_runs(db_path=db_path, sweep_id=sweep_id)
    if not runs:
        print("no runs found")
        return []
    os.makedirs(output_dir, exist_ok=True)
    written = []

    # 1. compression vs distortion / 2. pairwise / 3. rank distortion
    for ykey, fname, logy in (
        ("mse", "compression_vs_distortion.png", True),
        ("pairwise_distortion", "pairwise_distortion.png", False),
        ("rank_distortion", "rank_distortion.png", False),
    ):
        fig, ax = plt.subplots(figsize=(7, 5))
        _scatter_by_method(ax, runs, "compression_ratio", ykey, logy=logy)
        ax.set_title(f"{ykey} vs compression" + (f" [{sweep_id}]" if sweep_id else ""))
        p = os.path.join(output_dir, fname)
        fig.savefig(p, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(p)

    # 4. recall curves
    fig, ax = plt.subplots(figsize=(7, 5))
    _scatter_by_method(ax, runs, "compression_ratio", "recall@10")
    ax.set_ylim(0, 1.02)
    ax.set_title("recall@10 vs compression")
    p = os.path.join(output_dir, "recall_curves.png")
    fig.savefig(p, dpi=120, bbox_inches="tight")
    plt.close(fig)
    written.append(p)

    # 5. comparison table (text, reference's _generate_comparison_table)
    lines = [
        f"{'method':<16} {'config':<28} {'comp':>7} {'recall@10':>9} "
        f"{'mse':>11} {'qps':>10}"
    ]
    for r in runs:
        m = r["metrics"]
        lines.append(
            f"{r['method']:<16} {str(r['config'])[:28]:<28} "
            f"{m.get('compression_ratio', 0):>7.1f} {m.get('recall@10', 0):>9.4f} "
            f"{m.get('mse', 0):>11.3e} {m.get('qps', 0):>10.1f}"
        )
    p = os.path.join(output_dir, "comparison_table.txt")
    with open(p, "w") as f:
        f.write("\n".join(lines) + "\n")
    written.append(p)

    # 6. Pareto frontier (compression↑, recall↑)
    fig, ax = plt.subplots(figsize=(7, 5))
    pts = []
    for r in runs:
        m = r["metrics"]
        if "compression_ratio" in m and "recall@10" in m:
            pts.append((m["compression_ratio"], m["recall@10"], r["method"]))
    if pts:
        front = pareto_frontier([(x, y) for x, y, _ in pts])
        for x, y, name in pts:
            dom = (x, y) in front
            ax.scatter([x], [y], c="tab:red" if dom else "tab:gray",
                       s=40 if dom else 15)
            if dom:
                ax.annotate(name, (x, y), fontsize=7)
        if front:
            ax.plot(*zip(*front), "r--", alpha=0.5)
    ax.set_xlabel("compression_ratio")
    ax.set_ylabel("recall@10")
    ax.set_title("Pareto frontier")
    ax.grid(alpha=0.3)
    p = os.path.join(output_dir, "pareto_frontier.png")
    fig.savefig(p, dpi=120, bbox_inches="tight")
    plt.close(fig)
    written.append(p)

    # 7. radar chart over normalized metrics per method
    metrics_keys = ["recall@10", "compression_ratio", "qps"]
    inv_keys = ["mse"]
    by_m = _by_method(runs)
    labels = metrics_keys + inv_keys
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, polar=True)
    angles = np.linspace(0, 2 * np.pi, len(labels), endpoint=False).tolist()
    maxima = {
        k: max((r["metrics"].get(k, 0) or 0) for r in runs) or 1.0
        for k in metrics_keys + inv_keys
    }
    for method, rs in sorted(by_m.items()):
        best = max(rs, key=lambda r: r["metrics"].get("recall@10", 0))
        vals = [
            (best["metrics"].get(k, 0) or 0) / maxima[k] for k in metrics_keys
        ] + [
            1.0 - min(1.0, (best["metrics"].get(k, 0) or 0) / maxima[k])
            for k in inv_keys
        ]
        ax.plot(angles + angles[:1], vals + vals[:1], label=method, alpha=0.7)
    ax.set_xticks(angles)
    ax.set_xticklabels(labels, fontsize=8)
    ax.legend(fontsize=7, loc="lower right")
    p = os.path.join(output_dir, "radar_chart.png")
    fig.savefig(p, dpi=120, bbox_inches="tight")
    plt.close(fig)
    written.append(p)

    print(f"wrote {len(written)} outputs to {output_dir}")
    return written
