"""A copy of the benchmark at tiny sizes, for runs on the CPU.

``tiny_root`` copies ``BENCHMARK.json`` and ``vqbench/`` into a temporary
checkout and shrinks each configuration and mix in place (same keys, same
system, reference and metrics), so a cell runs end to end through the
program's plain paths in a second or two.  ``run_cell`` drives one run the
way ``run.py`` does, with the look for a card skipped."""

from __future__ import annotations

import io
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_CONFIGS = {
    "dbpedia1m-pq192": {"n": 4096, "d": 64, "num_queries": 64,
                        "quantizer": {"num_subquantizers": 8},
                        "kmeans": {"iters": 3, "max_points_per_centroid": 16}},
    "msmarco1m-ivfsaq2": {"n": 8192, "d": 64, "num_queries": 64,
                          "ivf": {"num_clusters": 16}, "kmeans": {"iters": 3},
                          "quantizer": {"block_dims": 16}},
}
TINY_MIXES = {"k100-b1024": {"batch": 48, "k": 20, "passes": 4},
              "k10-b8": {"batch": 8, "k": 10, "passes": 2},
              "np50-k10-b1024": {"batch": 32, "k": 10, "nprobe": 4, "passes": 4,
                                 "judge_batches": 3},
              "np50-k10-b8": {"batch": 8, "k": 10, "nprobe": 4, "passes": 2,
                              "judge_batches": 5}}
# the tiny cells' limits: the program's plain paths compute in f32 on the
# CPU, and the CPU's eigensolver is not bit-reproducible
TINY_LIMITS = {"dbpedia1m-pq192": {"fit": 1e-5, "codes": 1e-5, "score_err": 1e-4, "gap": 1e-4},
               "msmarco1m-ivfsaq2": {"centroids": 1e-5, "fit": 1e-5, "layout": 1e-5,
                                     "words": 1e-5, "factors": 1e-5, "score_err": 1e-4,
                                     "gap": 1e-4}}
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def make_tiny_root(dst: Path) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "vqbench", dst / "vqbench",
                    ignore=shutil.ignore_patterns("__pycache__", "results", "tests"))
    for name, small in TINY_CONFIGS.items():
        p = dst / "vqbench" / "configs" / f"{name}.json"
        cfg = json.loads(p.read_text())
        for key, val in small.items():
            if key == "kmeans":
                (cfg["ivf"] if "ivf" in cfg else cfg["quantizer"])["kmeans"].update(val)
            elif isinstance(val, dict):
                cfg[key].update(val)
            else:
                cfg[key] = val
        cfg["limits"] = TINY_LIMITS[name]
        p.write_text(json.dumps(cfg))
    for name, small in TINY_MIXES.items():
        p = dst / "vqbench" / "traffic" / f"{name}.json"
        p.write_text(json.dumps({**json.loads(p.read_text()), **small}))
    return dst


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)


def run_cell(root: Path, cell: str, trace: int = 0, seed: int = 2**31 + 11,
             seconds: float = 0.3):
    """→ (exit code, the result line as a dict or None)."""
    from vqbench import harness

    out = io.StringIO()
    rc = harness.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)], root=root, device="cpu", out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.fixture
def card():
    """Skips the test without a CUDA card (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
