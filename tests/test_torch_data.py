"""The port's data layer (``vq_tpu_torch/data``: datasets, io, hf_loaders)
against the JAX package's on the CPU.

* ``load_dummy_dataset`` draws on the host with numpy's generator: rows
  bit-equal to JAX's.
* Ground truth is an exact f32 scan on both sides, summed in other orders:
  ids equal wherever the exact (f64) scores of neighbouring ranks are more
  than 1e-5 of the largest |score| apart.
* ``load_planted_dataset`` uses a ``torch.Generator`` (other numbers than
  ``jax.random``): compared on structure, as ``test_harness_extras.py``
  checks JAX's.
* fvecs / ivecs files written by either package read back bit-equal in the
  other.
"""

import numpy as np
import pytest
import torch

from vq_tpu.core.config import Metric as JMetric
from vq_tpu.data import datasets as jds
from vq_tpu.data import hf_loaders as jhf
from vq_tpu.data import io as jio
from vq_tpu_torch.core.config import Metric
from vq_tpu_torch.data import datasets as tds
from vq_tpu_torch.data import hf_loaders as thf
from vq_tpu_torch.data import io as tio

torch.set_num_threads(1)

CPU = dict(device="cpu")


def exact_scores(x, q, ids, metric):
    """f64 scores of ``ids`` (Q, k) in the metric's ranking order (higher
    is better): −‖q − x‖², q·x, q·x/‖x‖."""
    x, q = x.astype(np.float64), q.astype(np.float64)
    xi = x[ids]  # (Q, k, D)
    if metric == "l2":
        return -np.sum((q[:, None, :] - xi) ** 2, axis=-1)
    ip = np.einsum("qd,qkd->qk", q, xi)
    return ip / np.linalg.norm(xi, axis=-1) if metric == "nip" else ip


def assert_gt_where_separated(x, q, got, want, metric, rtol=1e-5):
    s = exact_scores(x, q, np.asarray(want, np.int64), metric)
    tol = rtol * np.abs(s).max()
    gap = np.abs(np.diff(s, axis=1))
    sep = np.ones_like(s, dtype=bool)
    sep[:, 1:] &= gap > tol
    sep[:, :-1] &= gap > tol
    assert sep.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(got)[sep], np.asarray(want)[sep])
    # every id the port returns scores as well as the rank it holds
    np.testing.assert_allclose(exact_scores(x, q, np.asarray(got, np.int64), metric), s,
                               rtol=0, atol=tol)


@pytest.mark.parametrize("normalized", [False, True])
def test_dummy_rows_are_bit_equal_to_jax(normalized):
    kw = dict(num_vectors=700, dim=24, num_queries=9, seed=3, normalized=normalized)
    j = jds.load_dummy_dataset(**kw)
    t = tds.load_dummy_dataset(**kw, **CPU)
    assert t.name == j.name and t.dim == j.dim and t.num_vectors == j.num_vectors
    assert t.vectors.dtype == np.float32 and isinstance(t.vectors, np.ndarray)
    np.testing.assert_array_equal(t.vectors, j.vectors)
    np.testing.assert_array_equal(t.queries, j.queries)
    assert t.ground_truth.shape == j.ground_truth.shape == (9, 100)


@pytest.mark.parametrize("metric", ["l2", "ip", "nip"])
def test_ground_truth_ids_equal_jax_where_separated(metric):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((1500, 20)) * np.linspace(2.0, 0.3, 20)).astype(np.float32)
    q = rng.standard_normal((13, 20)).astype(np.float32)
    want = jds.compute_ground_truth(x, q, k=50, metric=JMetric(metric))
    for batch in (1024, 5):  # one query batch, and several
        got = tds.compute_ground_truth(x, q, k=50, metric=Metric(metric), batch_queries=batch,
                                       **CPU)
        assert got.dtype == np.int32 and got.shape == (13, 50)
        assert_gt_where_separated(x, q, got, want, metric)


def test_dataset_ground_truth_follows_its_metric_and_gt_k():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    q = rng.standard_normal((4, 8)).astype(np.float32)
    j = jds.Dataset("d", x, q, metric=JMetric.IP, gt_k=20)
    t = tds.Dataset("d", x, q, metric=Metric.IP, gt_k=20, **CPU)
    assert_gt_where_separated(x, q, t.ground_truth, j.ground_truth, "ip")
    given = np.zeros((4, 3), np.int32)
    assert tds.Dataset("d", x, q, ground_truth=given, **CPU).ground_truth is given


def test_planted_dataset_has_neighbor_structure():
    """Unit rows, registry dispatch, and planted near-duplicate
    neighbourhoods: a query's true top-10 is dominated by one document's
    variants (``test_harness_extras.py``'s check of JAX's)."""
    d = tds.load_planted_dataset(num_vectors=2000, dim=64, num_queries=20, rank=8,
                                 cluster_size=10, spread=0.3, seed=1, **CPU)
    assert d.name == "planted-2000x64" and d.vectors.shape == (2000, 64)
    assert np.allclose(np.linalg.norm(d.vectors, axis=1), 1.0, atol=1e-5)
    assert np.allclose(np.linalg.norm(d.queries, axis=1), 1.0, atol=1e-5)
    docs = d.ground_truth[:, :10] % 200  # 2000 / cluster_size documents
    frac_same = np.mean([np.max(np.bincount(row, minlength=200)) / 10 for row in docs])
    assert frac_same > 0.5, frac_same
    again = tds.load_planted_dataset(num_vectors=2000, dim=64, num_queries=20, rank=8,
                                     cluster_size=10, spread=0.3, seed=1, **CPU)
    np.testing.assert_array_equal(again.vectors, d.vectors)  # bit-stable for a seed


@pytest.mark.parametrize("name,shape,nq", [("dummy", (10000, 128), 100),
                                           ("demo_sweep", (10000, 128), 100),
                                           ("dummy-500x12", (500, 12), 100),
                                           ("planted-1000x32", (1000, 32), 10)])
def test_get_dataset_resolves_the_same_names_as_jax(name, shape, nq):
    kw = {"num_queries": nq} if name.startswith("planted") else {}
    j = jds.get_dataset(name, **kw)
    t = tds.get_dataset(name, **kw, **CPU)
    assert t.name == j.name and t.vectors.shape == j.vectors.shape == shape
    assert t.queries.shape == j.queries.shape == (nq, shape[1])
    if name.startswith("dummy") or name == "demo_sweep":
        np.testing.assert_array_equal(t.vectors, j.vectors)


def _write_npy_set(root, name, x, q, gt=None, nested=False):
    d = root / name if nested else root
    d.mkdir(exist_ok=True)
    pre = "" if nested else f"{name}_"
    np.save(d / f"{pre}base.npy", x)
    if q is not None:
        np.save(d / f"{pre}query.npy", q)
    if gt is not None:
        np.save(d / f"{pre}gt.npy", gt)


@pytest.mark.parametrize("layout", ["flat", "nested", "no-query", "fvecs"])
def test_get_dataset_reads_files_as_jax(tmp_path, layout):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((240, 16)).astype(np.float32)
    q = rng.standard_normal((7, 16)).astype(np.float32)
    gt = rng.integers(0, 240, (7, 5)).astype(np.int32)
    if layout == "flat":
        _write_npy_set(tmp_path, "set", x, q, gt)
    elif layout == "nested":
        _write_npy_set(tmp_path, "set", x, q, gt, nested=True)
    elif layout == "no-query":
        _write_npy_set(tmp_path, "set", x, None)
    else:
        (tmp_path / "set").mkdir()
        jio.write_fvecs(str(tmp_path / "set" / "base.fvecs"), x)
        jio.write_fvecs(str(tmp_path / "set" / "query.fvecs"), q)
    kw = {"num_queries": 11} if layout == "no-query" else {}
    j = jds.get_dataset("set", data_dir=str(tmp_path), **kw)
    t = tds.get_dataset("set", data_dir=str(tmp_path), **kw, **CPU)
    assert t.name == j.name == "set" and t.metric.value == j.metric.value
    np.testing.assert_array_equal(t.vectors, j.vectors)
    np.testing.assert_array_equal(t.queries, j.queries)
    if layout in ("flat", "nested"):
        np.testing.assert_array_equal(t.ground_truth, gt)
    else:
        metric = "nip" if layout == "fvecs" else "l2"
        assert_gt_where_separated(t.vectors, t.queries, t.ground_truth, j.ground_truth, metric)
    with pytest.raises(FileNotFoundError, match="no files found"):
        tds.get_dataset("missing", data_dir=str(tmp_path), **CPU)


@pytest.mark.parametrize("writer,reader", [(tio, jio), (jio, tio)])
def test_vecs_files_round_trip_across_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(5)
    f = rng.standard_normal((17, 9)).astype(np.float32)
    i = rng.integers(-5, 1 << 20, (17, 4)).astype(np.int32)
    writer.write_fvecs(str(tmp_path / "a" / "x.fvecs"), f)
    writer.write_ivecs(str(tmp_path / "x.ivecs"), i)
    np.testing.assert_array_equal(reader.load_fvecs(str(tmp_path / "a" / "x.fvecs")), f)
    np.testing.assert_array_equal(reader.load_ivecs(str(tmp_path / "x.ivecs")), i)
    assert (tmp_path / "x.ivecs").read_bytes() == _bytes_of(reader, tmp_path, i)


def _bytes_of(io_mod, tmp_path, i):
    io_mod.write_ivecs(str(tmp_path / "again.ivecs"), i)
    return (tmp_path / "again.ivecs").read_bytes()


def test_vecs_reader_rejects_bad_files(tmp_path):
    (tmp_path / "bad.fvecs").write_bytes(np.array([3, 1, 2], np.int32).tobytes())
    with pytest.raises(ValueError, match="not a multiple"):
        tio.load_fvecs(str(tmp_path / "bad.fvecs"))
    (tmp_path / "empty.fvecs").write_bytes(b"")
    assert tio.load_fvecs(str(tmp_path / "empty.fvecs")).shape == (0, 0)


class _FakeHF:
    """Stands in for the ``datasets`` module: a streaming split of synthetic
    rows (nothing is downloaded)."""

    def __init__(self, rows, field):
        self.rows, self.field, self.asked = rows, field, []

    def load_dataset(self, name, *args, split=None, streaming=None):
        self.asked.append((name, args, split, streaming))
        return iter([{self.field: r.tolist()} for r in self.rows])


@pytest.mark.parametrize("dim,field", [(1536, "openai"),
                                       (3072, "text-embedding-3-large-3072-embedding")])
def test_dbpedia_loader_on_a_synthetic_stream_equals_jax(monkeypatch, dim, field):
    rows = np.random.default_rng(6).standard_normal((40, dim)).astype(np.float32)
    fakes = {}
    for mod, key in ((jhf, "jax"), (thf, "port")):
        fakes[key] = _FakeHF(rows, field)
        monkeypatch.setattr(mod, "_require_datasets", lambda f=fakes[key]: f)
    j = jhf.load_dbpedia_openai(num_rows=30, dim=dim, num_queries=6)
    t = thf.load_dbpedia_openai(num_rows=30, dim=dim, num_queries=6, **CPU)
    assert fakes["port"].asked == fakes["jax"].asked
    assert t.name == j.name and t.vectors.shape == (30, dim) and t.queries.shape == (6, dim)
    np.testing.assert_array_equal(t.vectors, j.vectors)
    np.testing.assert_array_equal(t.queries, j.queries)
    assert_gt_where_separated(t.vectors, t.queries, t.ground_truth, j.ground_truth, "l2")


def test_msmarco_stream_batches_equal_jax(monkeypatch):
    rows = np.random.default_rng(8).standard_normal((25, 1024)).astype(np.float32)
    for mod in (jhf, thf):
        monkeypatch.setattr(mod, "_require_datasets", lambda: _FakeHF(rows, "emb"))
    for kw in ({"batch_size": 10}, {"batch_size": 7, "max_vectors": 16}):
        got = list(thf.stream_cohere_msmarco_passages(**kw))
        want = list(jhf.stream_cohere_msmarco_passages(**kw))
        assert [len(b) for b in got] == [len(b) for b in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(thf.load_cohere_msmarco_queries(12),
                                  jhf.load_cohere_msmarco_queries(12))


def test_hf_loaders_name_the_missing_package(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_datasets(name, *a, **k):
        if name == "datasets":
            raise ImportError("no datasets")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_datasets)
    with pytest.raises(ImportError, match="HuggingFace `datasets` is not installed"):
        thf.load_dbpedia_openai_1536_100k(**CPU)
