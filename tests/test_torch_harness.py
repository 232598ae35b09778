"""The port's sweep harness (``vq_tpu_torch/bench``: registry, sweep,
streaming, ivf_bench; ``utils/run_logger``) against the JAX package's on the
CPU, on the same seeded data.

Tolerances and their reasons:
* SQ and LVQ fit deterministically (min/max, a mean), so both packages
  encode the same codes; the logged distortion and MSE are f32 sums of the
  same decoded values in other orders: within 1e-5 relative.  Pairwise
  distortion is a mean of |ratio − 1| with ratios near 1 (6e-4 for LVQ
  8-bit), so f32 rounding of the decoded rows (~1e-6 of a ratio) shows
  against the ratio, not the result: within 1e-5 absolute.  Compression
  and code bytes are exact.  Recall and rank distortion are equal: the
  scores are separated on these data (a Gaussian corpus; no two rows tie
  to 1e-5).
* PQ and SAQ fit from different PRNGs: compared on quality, recall@10
  within 0.1 of JAX's (at D=32, M=8, B=8 and bpd=2 recall@10 is 0.5-0.7 and
  moves by ±0.05 from seed to seed on either side).
* Streaming MSE: the same codes' errors summed in f32 by torch and numpy in
  other orders: within 1e-5 relative.
"""

import csv
import os
import sqlite3

import numpy as np
import pytest
import torch

from vq_tpu.bench import ivf_bench as jivf
from vq_tpu.bench import registry as jreg
from vq_tpu.bench import streaming as jstream
from vq_tpu.bench import sweep as jsweep
from vq_tpu.data.datasets import load_dummy_dataset as jax_dummy
from vq_tpu.utils import run_logger as jlog
from vq_tpu_torch import convert
from vq_tpu_torch.bench import ivf_bench as tivf
from vq_tpu_torch.bench import registry as treg
from vq_tpu_torch.bench import streaming as tstream
from vq_tpu_torch.bench import sweep as tsweep
from vq_tpu_torch.data.datasets import load_dummy_dataset as port_dummy
from vq_tpu_torch.utils import run_logger as tlog

torch.set_num_threads(1)

CPU = dict(device="cpu")
EXACT_KEYS = ("compression_ratio", "code_bytes_per_vector", "recall@10", "recall@100",
              "rank_distortion")
CLOSE_KEYS = ("distortion", "mse")
TIME_KEYS = ("fit_time_s", "compress_time_s", "decompress_time_s", "qps", "qps_mean",
             "qps_std", "avg_query_latency_ms", "latency_ms_std")


@pytest.fixture(scope="module")
def data():
    kw = dict(num_vectors=2000, dim=32, num_queries=30, seed=0)
    return jax_dummy(**kw), port_dummy(**kw, **CPU)


# ------------------------------------------------------------- registry
REGISTRY_CASES = [
    ("pq", {}), ("pq", {"M": 8, "B": 6, "kmeans_iters": 3, "seed": 2}),
    ("pq", {"bpd": 2.0}), ("sq", {}), ("sq", {"bits": 4}), ("sq", {"B": 16}),
    ("opq", {"M": 4, "opq_iters": 2}), ("rabitq", {}), ("extended_rabitq", {}),
    ("xrabitq", {"bits": 3}), ("saq", {}), ("saq_paper", {"allocator": "dp"}),
    ("ours", {"codebook": "lloyd", "bpd": 2.0}), ("caq", {"caq_rounds": 2, "use_pca": False}),
    ("lvq", {}), ("lvq", {"bits": 4}), ("rankaware", {}),
    ("perdim_mse", {"packing": "ffd", "codebook": "exact"}),
]


@pytest.mark.parametrize("method,kw", REGISTRY_CASES)
def test_registry_builds_the_configs_jax_builds(method, kw):
    j = jreg.build_quantizer(method, 32, **dict(kw))
    t = treg.build_quantizer(method, 32, **dict(kw), **CPU)
    assert t.name == j.name and type(t).__name__ == type(j).__name__
    assert t.cfg == convert.config_from_jax(j.cfg)
    assert getattr(t, "seed", None) == getattr(j, "seed", None)
    assert t.device == torch.device("cpu")


def test_registry_covers_every_jax_method_and_raises_as_jax():
    assert treg.ALL_METHODS == jreg.ALL_METHODS
    for method in treg.ALL_METHODS:
        assert treg.build_quantizer(method, 64, **CPU).cfg == convert.config_from_jax(
            jreg.build_quantizer(method, 64).cfg)
    with pytest.raises(TypeError, match="unknown kwargs"):
        treg.build_quantizer("pq", 32, M=4, codebook="lloyd")
    with pytest.raises(ValueError, match="unknown method"):
        treg.build_quantizer("nope", 32)
    assert treg.build_quantizer("pq", 32).device is None  # bound to the card at fit


@pytest.mark.parametrize("d,target", [(1536, 16), (30, 7), (7, 3), (64, 100)])
def test_divisors_and_bpd_to_m_equal_jax(d, target):
    assert treg.largest_divisor_leq(d, target) == jreg.largest_divisor_leq(d, target)
    for bpd in (0.5, 1.0, 2.0):
        assert treg.bpd_to_pq_m(bpd, d, 8) == jreg.bpd_to_pq_m(bpd, d, 8)


@pytest.mark.parametrize("method,grid", [(m, None) for m in jreg.ALL_METHODS + ["nope"]]
                         + [("pq", {"M": [4, 8], "B": [4, 8]}), ("sq", {"bits": [8]})])
def test_generate_configs_equals_jax(method, grid):
    assert tsweep.generate_configs(method, grid) == jsweep.generate_configs(method, grid)


# ------------------------------------------------------------- sweep rows
def _both_single(data, tmp_path, method, params, **kw):
    dj, dt = data
    mj = jsweep.run_single_config(dj, method, dict(params), k=10, num_queries=30,
                                  db_path=str(tmp_path / "j.db"), **kw)
    mt = tsweep.run_single_config(dt, method, dict(params), k=10, num_queries=30,
                                  db_path=str(tmp_path / "t.db"), **kw, **CPU)
    return mj, mt


@pytest.mark.parametrize("method,params", [("sq", {"bits": 8}), ("lvq", {"bits": 8})])
def test_run_single_config_logs_jax_metrics_for_deterministic_fits(data, tmp_path, method,
                                                                   params):
    mj, mt = _both_single(data, tmp_path, method, params)
    assert set(mt) == set(mj)
    for key in EXACT_KEYS:
        assert mt[key] == mj[key], key
    for key in CLOSE_KEYS:
        assert mt[key] == pytest.approx(mj[key], rel=1e-5), key
    assert mt["pairwise_distortion"] == pytest.approx(mj["pairwise_distortion"], abs=1e-5)
    assert all(mt[key] > 0 for key in TIME_KEYS if key not in ("qps_std", "latency_ms_std"))
    runs = tlog.load_runs(db_path=str(tmp_path / "t.db"))
    assert len(runs) == 1 and runs[0]["metrics"] == pytest.approx(mt)
    assert runs[0]["config"] == params and runs[0]["method"] == method


@pytest.mark.parametrize("method,params", [("pq", {"M": 8, "B": 8, "kmeans_iters": 10}),
                                           ("saq", {"bpd": 2.0})])
def test_run_single_config_quality_matches_jax(data, tmp_path, method, params):
    mj, mt = _both_single(data, tmp_path, method, params)
    assert set(mt) == set(mj)
    assert mt["recall@10"] == pytest.approx(mj["recall@10"], abs=0.1)
    assert mt["mse"] == pytest.approx(mj["mse"], rel=0.1)
    for key in ("compression_ratio", "code_bytes_per_vector"):
        assert mt[key] == mj[key]
    assert mt["rank_distortion"] == pytest.approx(1 - mt["recall@10"])


def test_sweep_runs_the_grid_and_logs_one_sweep(data, tmp_path):
    _, dt = data
    db = str(tmp_path / "runs.db")
    res = tsweep.sweep(methods=["pq", "sq"], grid={"pq": {"M": [4], "B": [4]},
                                                   "sq": {"bits": [4, 8]}},
                       k=5, num_queries=10, db_path=db, data=dt, verbose=False, **CPU)
    assert [(r["method"], r["params"]) for r in res] == [
        ("pq", {"B": 4, "M": 4}), ("sq", {"bits": 4}), ("sq", {"bits": 8})]
    runs = tlog.load_runs(db_path=db)
    assert len(runs) == 3 and len({r["sweep_id"] for r in runs}) == 1
    assert runs[0]["sweep_id"].startswith("sweep_")
    assert tlog.load_runs(db_path=db, sweep_id=runs[0]["sweep_id"]) == runs


# --------------------------------------------------------------- sqlite
def test_sqlite_schema_equals_jax(tmp_path):
    cols = {}
    for name, mod in (("j", jlog), ("t", tlog)):
        db = str(tmp_path / f"{name}.db")
        mod.log_run("pq", "dummy", {"recall@10": 0.5}, {"M": 8}, "sweepX", db_path=db)
        con = sqlite3.connect(db)
        cols[name] = [tuple(r) for r in con.execute("PRAGMA table_info(runs)")]
        con.close()
    assert cols["t"] == cols["j"]


@pytest.mark.parametrize("writer,reader", [(tlog, jlog), (jlog, tlog)])
def test_a_logged_row_reads_back_identically_in_both_packages(tmp_path, writer, reader,
                                                              monkeypatch):
    db = str(tmp_path / "nested" / "runs.db")
    metrics = {"recall@10": 0.25, "qps": np.float32(10.5), "n": np.int64(3),
               "v": np.arange(3), "t": (1, 2)}
    writer.log_run("sq", "dummy-10x2", metrics, {"bits": 8}, "s1", db_path=db, host_rank=2)
    writer.log_run("pq", "dummy-10x2", {"recall@10": 0.1}, None, None, db_path=db)
    got, want = reader.load_runs(db_path=db), writer.load_runs(db_path=db)
    assert got == want and len(got) == 2
    assert got[0]["metrics"] == {"recall@10": 0.25, "qps": 10.5, "n": 3, "v": [0, 1, 2],
                                 "t": [1, 2]}
    assert got[0]["host_rank"] == 2 and got[1]["config"] == {} and got[1]["sweep_id"] is None
    assert got[0]["package_version"] == "0.1.0"
    monkeypatch.setenv("DB_PATH", db)
    assert reader.load_runs(sweep_id="s1") == got[:1]


def test_git_info_tolerates_a_copy_without_git(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GIT_DIR", str(tmp_path / "no-git"))
    assert tlog._git_info() == jlog._git_info() == ("unknown", "unknown")


# ------------------------------------------------------------ ivf bench
def _csv_rows(directory):
    (path,) = [os.path.join(directory, f) for f in os.listdir(directory) if f.endswith(".csv")]
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_ivf_benchmark_csv_columns_equal_jax(data, tmp_path):
    dj, dt = data
    kw = dict(methods=["sq_flat", "pq_flat", "not_a_method"], k=5, bpd=[2.0],
              num_clusters=8, nprobe=4)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    rj = jivf.ivf_benchmark(data=dj, output=str(tmp_path / "j" / "ivf.csv"), **kw)
    rt = tivf.ivf_benchmark(data=dt, output=str(tmp_path / "t" / "ivf.csv"), **kw, **CPU)
    cj, ct = _csv_rows(tmp_path / "j"), _csv_rows(tmp_path / "t")
    assert list(ct[0]) == list(cj[0]) and len(ct) == len(cj) == 3
    assert [r["error"] for r in rt] == [r["error"] for r in rj]
    assert rt[0]["error"] == "" and "unknown ivf-bench method" in rt[2]["error"]
    assert rt[0]["recall@5"] == rj[0]["recall@5"]  # SQ 4-bit: deterministic fit
    assert rt[0]["memory_bytes"] == rj[0]["memory_bytes"]
    assert tivf.METHOD_RUNNERS == jivf.METHOD_RUNNERS


@pytest.mark.parametrize("method", ["ivf_pq", "saq_ivf_packed", "rabitq_ivf_packed",
                                    "opq_flat", "saq_flat", "rabitq", "rabitq_ivf", "saq"])
def test_every_ivf_runner_builds_and_searches(data, tmp_path, method):
    rows = tivf.ivf_benchmark(data=data[1], methods=[method], k=5, bpd=[2.0],
                              num_clusters=8, nprobe=4, output=str(tmp_path / "ivf.csv"),
                              **CPU)
    assert rows[0]["error"] == "" and rows[0]["recall@5"] > 0.2, rows[0]
    assert rows[0]["memory_bytes"] > 0 and rows[0]["qps"] > 0


def test_timestamped_output_path_keeps_the_stem():
    assert tivf.timestamped_output_path("out/r.csv").startswith("out/r_")
    assert tivf.timestamped_output_path("out/r").endswith(".csv")


# ------------------------------------------------------------ streaming
def test_streaming_sweep_mse_equals_jax_for_sq(tmp_path):
    kw = dict(dataset="dummy-6000x24", methods=["sq"], train_size=2500, batch_size=1700)
    (want,) = jstream.streaming_sweep(db_path=str(tmp_path / "j.db"), **kw)
    (got,) = tstream.streaming_sweep(db_path=str(tmp_path / "t.db"), **kw, **CPU)
    mj, mt = want["metrics"], got["metrics"]
    assert set(mt) == set(mj) and mt["streamed_vectors"] == mj["streamed_vectors"] == 6000
    assert mt["compression_ratio"] == mj["compression_ratio"]
    for key in ("mse", "distortion"):
        assert mt[key] == pytest.approx(mj[key], rel=1e-5), key
    (run,) = tlog.load_runs(db_path=str(tmp_path / "t.db"))
    assert run["dataset"] == "dummy-6000x24-streaming" and run["metrics"] == pytest.approx(mt)


def test_streaming_source_and_batches_equal_jax():
    np.testing.assert_array_equal(tstream.open_streaming_source("dummy-300x5"),
                                  jstream.open_streaming_source("dummy-300x5"))
    src = np.arange(50, dtype=np.float32).reshape(25, 2)
    got = list(tstream.iterate_batches(src, 10, max_vectors=22))
    want = list(jstream.iterate_batches(src, 10, max_vectors=22))
    assert [len(b) for b in got] == [10, 10, 2]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError, match="not found"):
        tstream.open_streaming_source("nope", data_dir="/nonexistent")


def test_streaming_source_reads_an_npy_file(tmp_path):
    x = np.random.default_rng(1).standard_normal((40, 6)).astype(np.float32)
    np.save(tmp_path / "s_base.npy", x)
    np.testing.assert_array_equal(tstream.open_streaming_source("s", str(tmp_path)), x)
