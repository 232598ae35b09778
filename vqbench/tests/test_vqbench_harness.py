"""The harness on the CPU at tiny sizes: every cell end to end, the result
line's shape, the import guard, what is found by name, the no-card exit."""

from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest
from conftest import CELLS, REPO, run_cell

from vqbench import harness

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearsed_end_to_end(tiny_root, cell, trace):
    rc, res = run_cell(tiny_root, cell, trace)
    assert rc == 0 and res is not None
    keys = list(res)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    e2e, layer = harness.cell_metrics(bench, cell)
    if trace:
        assert "busy_s" in res["device"] and "window_s" in res["device"]
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU has no device trace: only the counters and spans read here
        names = {m["name"] for m in layer if m["source"] != "device_trace"}
        assert names <= set(res["metrics"]) <= {m["name"] for m in layer}
    else:
        assert set(res["metrics"]) == {m["name"] for m in e2e}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell in CELLS:
        e2e, layer = harness.cell_metrics(bench, cell)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        for m in layer:
            assert m["moves"] in names


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vq_tpu_torch_lookalike", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "vq_tpuish.sub", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vq_tpu.kernels", types.ModuleType("vq_tpu.kernels"))
    assert harness.forbidden_modules() == ["vq_tpu"]
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax", "vq_tpu"]


def test_a_run_refuses_when_the_jax_package_was_loaded(tiny_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "vq_tpu", types.ModuleType("vq_tpu"))
    rc, res = run_cell(tiny_root, CELLS[0])
    assert rc == 3 and res is None


def test_a_cell_run_loads_the_port_and_not_the_jax_package(tiny_root):
    """In a fresh interpreter: a whole run, then the guard's view."""
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "from conftest import run_cell\nfrom pathlib import Path\n"
            "rc, res = run_cell(Path(%r), %r)\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(rc, res['correct'], 'vq_tpu_torch' in tops, "
            "sorted(tops & {'jax', 'jaxlib', 'flax', 'vq_tpu'}))"
            % (str(REPO), str(REPO / "vqbench" / "tests"), str(tiny_root), CELLS[0]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "0 True True []", out.stderr[-2000:]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import vqbench.reference.common, vqbench.reference.kmeans\n"
            "import vqbench.reference.saq, vqbench.reference.flat_pq\n"
            "import vqbench.reference.ivf_packed_saq, vqbench.corpora.fullrank\n"
            "import vqbench.costs.pq_scan, vqbench.costs.packed_scan\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'vq_tpu_torch', 'vq_tpu', 'jax', 'jaxlib', 'flax'}))"
            % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_a_new_config_mix_and_metric_are_files_found_by_name(tiny_root):
    """A configuration, a traffic mix and a per-layer metric added as new
    files, with entries added to BENCHMARK.json: no file that was there is
    edited, and the new cell runs and reports the new metric."""
    vq = tiny_root / "vqbench"
    before = {p: p.read_bytes() for p in vq.rglob("*") if p.is_file()}
    cfg = json.loads((vq / "configs" / "dbpedia1m-pq192.json").read_text())
    cfg.update(n=2048, d=32)
    cfg["quantizer"]["num_subquantizers"] = 4
    (vq / "configs" / "tiny-pq4.json").write_text(json.dumps(cfg))
    (vq / "traffic" / "k5-b16.json").write_text(json.dumps(
        {"batch": 16, "k": 5, "nprobe": None, "loop": "closed", "passes": 2,
         "judge_batches": None}))
    (vq / "layer_metrics" / "search.batches_traced.py").write_text(
        "def read(ctx):\n    return ctx.trace['batches']\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-pq4", "source": "https://example.org/tiny",
                             "file": "vqbench/configs/tiny-pq4.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny-pq4.k5-b16", "config": "tiny-pq4",
                               "traffic": "k5-b16", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "search.batches_traced", "unit": "batches",
                               "better": "higher", "source": "device_trace", "layer": "index",
                               "moves": "qps", "workloads": ["tiny-pq4.k5-b16"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())
    rc, res = run_cell(tiny_root, "tiny-pq4.k5-b16", trace=1)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["search.batches_traced"]["value"] >= 3
    rc, res = run_cell(tiny_root, "tiny-pq4.k5-b16", trace=0)
    assert rc == 0 and set(res["metrics"]) == {"qps", "recall", "build_s", "setup_s"}


def test_run_py_without_a_card_exits_non_zero_and_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files (no program), and in the repository: without a card, no line."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "vqbench", tmp_path / "vqbench",
                    ignore=shutil.ignore_patterns("__pycache__", "results"))
    for root in (tmp_path, REPO):
        out = subprocess.run([sys.executable, "vqbench/run.py", "--workload", CELLS[0],
                              "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                             cwd=root, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card, tiny_root):
    """A tiny cell through the card's kernels, with the look for a card."""
    import io

    from vqbench import harness as h

    out = io.StringIO()
    rc = h.run(["--workload", CELLS[1], "--seed", "7", "--seconds", "1", "--trace", "1"],
               root=tiny_root, out=out)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
