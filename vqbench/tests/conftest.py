"""A copy of the benchmark at tiny sizes, for runs on the CPU.

``tiny_root`` copies ``BENCHMARK.json`` and ``vqbench/`` into a temporary
checkout and shrinks each configuration and mix in place (same keys, same
system, reference and metrics), so a cell runs end to end through the
program's plain paths in a second or two.  ``run_cell`` drives one run the
way ``run.py`` does, with the look for a card skipped.

The tiny sizes are files found by name, so a new configuration or mix
brings its own beside it and no file here changes:

    vqbench/tests/tiny/configs/<config>.json   keys to override, ``limits``
    vqbench/tests/tiny/traffic/<mix>.json      the mix's keys to override

A configuration's overrides replace its top-level numbers and update its
groups; ``kmeans`` goes into ``ivf``'s k-means where the configuration has
an IVF, else into ``quantizer``'s; ``limits`` replaces the limits whole
(the tiny cells' limits: the program's plain paths compute in f32 on the
CPU, and the CPU's eigensolver is not bit-reproducible).  A cell whose
configuration or mix has no tiny file stops the copy at once, before any
run, with the missing path in the error."""

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

TINY = Path("vqbench") / "tests" / "tiny"
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def copy_root(dst: Path, src: Path = REPO, tests: bool = True) -> Path:
    """``BENCHMARK.json`` and ``vqbench/`` of ``src`` copied to ``dst``."""
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(src / "BENCHMARK.json", dst / "BENCHMARK.json")
    skip = ("__pycache__", "results") + (() if tests else ("tests",))
    shutil.copytree(src / "vqbench", dst / "vqbench", ignore=shutil.ignore_patterns(*skip))
    return dst


def make_tiny_root(dst: Path, src: Path = REPO) -> Path:
    """The benchmark of ``src`` (without its tests) at ``dst``, each
    configuration and mix shrunk by its tiny file under ``src``."""
    bench = json.loads((src / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        for kind, what in (("configs", "config"), ("traffic", "traffic")):
            path = src / TINY / kind / f"{w[what]}.json"
            if not path.is_file():
                raise FileNotFoundError(f"{path}: no CPU-rehearsal sizes for the {what} "
                                        f"{w[what]!r} of cell {w['name']!r}")
    copy_root(dst, src, tests=False)
    for c in bench["configs"]:
        p = dst / c["file"]
        cfg = json.loads(p.read_text())
        small = json.loads((src / TINY / "configs" / f"{c['name']}.json").read_text())
        for key, val in small.items():
            if key == "kmeans":
                (cfg["ivf"] if "ivf" in cfg else cfg["quantizer"])["kmeans"].update(val)
            elif isinstance(val, dict) and key != "limits":
                cfg[key].update(val)
            else:
                cfg[key] = val
        p.write_text(json.dumps(cfg))
    for small in sorted((src / TINY / "traffic").glob("*.json")):
        p = dst / "vqbench" / "traffic" / small.name
        p.write_text(json.dumps({**json.loads(p.read_text()), **json.loads(small.read_text())}))
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
