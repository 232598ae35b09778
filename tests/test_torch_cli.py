"""The port's CLI (``vq_tpu_torch/cli.py``, ``python -m vq_tpu_torch``)
against the JAX package's.

* The parsers offer the same subcommands and options, defaults included;
  the port adds ``--device`` (default ``cuda``) to every subcommand that
  computes, and only that.
* ``main([... "--device", "cpu"])`` runs each subcommand end to end on tiny
  data.
* Without ``--device`` and without a card every computing subcommand raises
  before it does any work: it never runs on the CPU unasked.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vq_tpu import cli as jcli
from vq_tpu_torch import cli as tcli
from vq_tpu_torch.data.io import write_fvecs
from vq_tpu_torch.utils.run_logger import load_runs

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
COMPUTING = ("run", "sweep", "precompute-gt", "streaming-sweep", "ivf-bench", "study")


def _subparsers(parser):
    (sub,) = [a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction"]
    return sub.choices


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.choices, a.required,
                     a.type, a.__class__.__name__, a.help)
            for a in parser._actions if a.dest != "help"}


def test_parsers_offer_jax_subcommands_and_options_plus_device():
    jsub, tsub = _subparsers(jcli.build_parser()), _subparsers(tcli.build_parser())
    assert list(tsub) == list(jsub) == ["run", "sweep", "precompute-gt", "streaming-sweep",
                                        "ivf-bench", "study", "plot"]
    for name in jsub:
        want, got = _options(jsub[name]), _options(tsub[name])
        if name in COMPUTING:
            device = got.pop("device")
            assert device[:2] == (("--device",), "cuda") and not device[4]
        assert got == want, name


def _tiny(tmp_path):
    rng = np.random.default_rng(0)
    write_fvecs(str(tmp_path / "b.fvecs"), rng.standard_normal((600, 16)).astype(np.float32))
    write_fvecs(str(tmp_path / "q.fvecs"), rng.standard_normal((12, 16)).astype(np.float32))
    db = str(tmp_path / "runs.db")
    return {
        "run": ["run", "--dataset", "dummy-600x16", "--method", "pq", "--param", "M=4",
                "--param", "B=4", "--param", "kmeans_iters=3", "--num-queries", "10",
                "--db-path", db, "--no-bf16"],
        "sweep": ["sweep", "--dataset", "dummy-600x16", "--methods", "pq", "sq", "saq",
                  "--pq-subquantizers", "4", "--pq-bits", "4", "--sq-bits", "4,8",
                  "--bpd", "2", "--k", "5", "--num-queries", "8", "--db-path", db],
        "precompute-gt": ["precompute-gt", "--dataset", "dummy-300x8", "--k", "7",
                          "--output", str(tmp_path / "gt.npy")],
        "streaming-sweep": ["streaming-sweep", "--dataset", "dummy-3000x16", "--methods", "sq",
                            "--train-size", "1000", "--batch-size", "1000", "--db-path", db],
        "ivf-bench": ["ivf-bench", "--dataset", "dummy-800x16", "--methods", "saq_ivf_packed",
                      "sq_flat", "--bpd", "2", "--num-clusters", "8", "--nprobe", "3",
                      "--k", "5", "--output", str(tmp_path / "ivf" / "ivf.csv")],
        "study": ["study", "--base", str(tmp_path / "b.fvecs"), "--queries",
                  str(tmp_path / "q.fvecs"), "--methods", "sq", "ours", "--bpd", "2,4",
                  "--output-dir", str(tmp_path / "results")],
        "plot": ["plot", "--db-path", db, "--output-dir", str(tmp_path / "plots")],
    }


def _check(name, tmp_path, out):
    db = str(tmp_path / "runs.db")
    if name == "run":
        metrics = json.loads(out)
        assert 0.0 <= metrics["recall@10"] <= 1.0
        assert load_runs(db_path=db)[0]["metrics"] == pytest.approx(metrics)
    elif name == "sweep":
        runs = load_runs(db_path=db)
        assert [(r["method"], r["config"]) for r in runs] == [
            ("pq", {"B": 4, "M": 4}), ("sq", {"bits": 4}), ("sq", {"bits": 8}),
            ("saq", {"bpd": 2.0})]
    elif name == "precompute-gt":
        gt = np.load(tmp_path / "gt.npy")
        assert gt.shape == (100, 7) and "saved (100, 7)" in out
    elif name == "streaming-sweep":
        (run,) = load_runs(db_path=db)
        assert run["dataset"] == "dummy-3000x16-streaming"
        assert run["metrics"]["streamed_vectors"] == 3000
    elif name == "ivf-bench":
        (csv_name,) = os.listdir(tmp_path / "ivf")
        text = (tmp_path / "ivf" / csv_name).read_text()
        assert text.count("\n") == 3 and ",," not in text.split("\n")[0]
    elif name == "study":
        (csv_name,) = os.listdir(tmp_path / "results")
        assert (tmp_path / "results" / csv_name).read_text().count("\n") == 5
    else:
        assert "wrote 7 outputs" in out and len(os.listdir(tmp_path / "plots")) == 7


@pytest.mark.parametrize("name", ["run", "sweep", "precompute-gt", "streaming-sweep",
                                  "ivf-bench", "study", "plot"])
def test_each_subcommand_runs_end_to_end_on_the_cpu(tmp_path, capsys, name):
    argv = _tiny(tmp_path)[name] + (["--device", "cpu"] if name in COMPUTING else [])
    if name == "plot":  # the rows a sweep on the CPU logs
        pytest.importorskip("matplotlib")
        assert tcli.main(_tiny(tmp_path)["sweep"] + ["--device", "cpu"]) == 0
    assert tcli.main(argv) == 0
    _check(name, tmp_path, capsys.readouterr().out)


@pytest.mark.parametrize("name", COMPUTING)
def test_without_a_device_and_a_card_each_subcommand_raises(tmp_path, monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(_tiny(tmp_path)[name])
    assert not (tmp_path / "runs.db").exists() and not (tmp_path / "gt.npy").exists()


def test_module_entry_prints_the_metrics_json(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "vq_tpu_torch", "run", "--dataset", "dummy-500x8", "--method",
         "sq", "--num-queries", "5", "--db-path", str(tmp_path / "r.db"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout)["compression_ratio"] == 4.0


@pytest.mark.parametrize("pairs,want", [(["M=16", "B=8"], {"M": 16, "B": 8}),
                                        (["bpd=1.5", "codebook=lloyd"],
                                         {"bpd": 1.5, "codebook": "lloyd"}), (None, {})])
def test_param_pairs_parse_as_jax(pairs, want):
    assert tcli._parse_kv(pairs) == jcli._parse_kv(pairs) == want
