"""The harness on the CPU at tiny sizes: every cell end to end, the result
line's shape, the import guard, what is found by name, the no-card exit."""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types

import pytest
from conftest import CELLS, REPO, copy_root, make_tiny_root, run_cell

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


def add_cell(root, tiny: bool):
    """A configuration, a traffic mix and a per-layer metric added to the
    benchmark at ``root`` as new files at full size, with entries added to
    BENCHMARK.json, and with ``tiny`` their CPU-rehearsal sizes as new
    files too."""
    vq = root / "vqbench"
    cfg = json.loads((vq / "configs" / "dbpedia1m-pq192.json").read_text())
    cfg["quantizer"]["num_subquantizers"] = 96
    (vq / "configs" / "new-pq96.json").write_text(json.dumps(cfg))
    (vq / "traffic" / "k5-b512.json").write_text(json.dumps(
        {"batch": 512, "k": 5, "nprobe": None, "loop": "closed", "passes": 64,
         "judge_batches": None}))
    (vq / "layer_metrics" / "search.batches_traced.py").write_text(
        "def read(ctx):\n    return ctx.trace['batches']\n")
    if tiny:
        (vq / "tests" / "tiny" / "configs" / "new-pq96.json").write_text(json.dumps(
            {"n": 2048, "d": 32, "num_queries": 64, "quantizer": {"num_subquantizers": 4},
             "kmeans": {"iters": 3, "max_points_per_centroid": 16},
             "limits": {"fit": 1e-5, "codes": 1e-5, "score_err": 1e-4, "gap": 1e-4}}))
        (vq / "tests" / "tiny" / "traffic" / "k5-b512.json").write_text(json.dumps(
            {"batch": 16, "k": 5, "passes": 2}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new-pq96", "source": "https://example.org/new",
                             "file": "vqbench/configs/new-pq96.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "new-pq96.k5-b512", "config": "new-pq96",
                               "traffic": "k5-b512", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "search.batches_traced", "unit": "batches",
                               "better": "higher", "source": "device_trace", "layer": "index",
                               "moves": "qps", "workloads": ["new-pq96.k5-b512"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_new_config_mix_and_metric_are_files_found_by_name(tmp_path):
    """A cell added as new files, its CPU-rehearsal sizes among them: no
    file under vqbench/ that was there (its tests included) is edited,
    and the new cell is rehearsed end to end at its tiny sizes and reports
    the new metric."""
    src = copy_root(tmp_path / "src")
    before = {p: p.read_bytes() for p in (src / "vqbench").rglob("*") if p.is_file()}
    assert any(p.parent.name == "tests" for p in before)
    add_cell(src, tiny=True)
    assert all(p.read_bytes() == b for p, b in before.items())
    root = make_tiny_root(tmp_path / "tiny", src)
    _, _, cfg, mix = harness.load_cell(root, "new-pq96.k5-b512")
    assert (cfg["n"], cfg["d"], cfg["quantizer"]["num_subquantizers"]) == (2048, 32, 4)
    assert (mix["batch"], mix["k"], mix["passes"]) == (16, 5, 2)
    rc, res = run_cell(root, "new-pq96.k5-b512", trace=1)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["search.batches_traced"]["value"] >= 3
    rc, res = run_cell(root, "new-pq96.k5-b512", trace=0)
    assert rc == 0 and set(res["metrics"]) == {"qps", "recall", "build_s", "setup_s"}


def test_a_cell_without_tiny_sizes_fails_its_rehearsal_at_once(tmp_path):
    """No tiny file for a cell's configuration, then none for its mix: the
    copy stops before any run, naming the missing file."""
    src = copy_root(tmp_path / "src")
    add_cell(src, tiny=False)
    t0 = time.perf_counter()
    with pytest.raises(FileNotFoundError, match="tiny/configs/new-pq96.json"):
        make_tiny_root(tmp_path / "tiny", src)
    (src / "vqbench" / "tests" / "tiny" / "configs" / "new-pq96.json").write_text(
        json.dumps({"n": 2048, "d": 32}))
    with pytest.raises(FileNotFoundError, match="tiny/traffic/k5-b512.json"):
        make_tiny_root(tmp_path / "tiny", src)
    assert time.perf_counter() - t0 < 10 and not (tmp_path / "tiny").exists()


def test_run_py_without_a_card_exits_non_zero_and_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files (no program), and in the repository: without a card, no line."""
    copy_root(tmp_path)
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
