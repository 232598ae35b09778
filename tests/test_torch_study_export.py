"""The port's study pipeline (``bench/study.py``), codebook export
(``utils/export.py``), scan counters (``utils/profiling.py``) and plots
(``viz/plot.py``) against the JAX package's on the CPU.

Tolerances and their reasons:
* Study SQ / LVQ rows: deterministic fits, the same codes; MSE is an f32
  mean of the same decoded values in another order (1e-5 relative);
  compression and code bytes exact; recall equal (NIP scores separated on
  this decaying-spectrum corpus).  SAQ ("ours") fits from another PRNG:
  recall@10 within 0.1 of JAX's.
* Codebook queries: the same f32 distances summed in other orders, within
  1e-5 of the largest |distance|; ids equal where neighbouring distances
  are further apart than that.  Exported codebooks are bit-equal (the same
  parameters, converted).
"""

import importlib
import os

import numpy as np
import pytest
import torch

from vq_tpu.bench import study as jstudy
from vq_tpu.core.config import Metric as JMetric
from vq_tpu.core.config import OPQConfig, PQConfig, RankAwareConfig, SQConfig
from vq_tpu.methods.opq import OPQ as JaxOPQ
from vq_tpu.methods.pq import PQ as JaxPQ
from vq_tpu.methods import rankaware as jra
from vq_tpu.methods.rankaware import RankAware as JaxRA
from vq_tpu.methods.sq import SQ as JaxSQ
from vq_tpu.utils import export as jexp
from vq_tpu.utils import profiling as jprof
from vq_tpu.utils.run_logger import log_run
from vq_tpu_torch import convert
from vq_tpu_torch.bench import study as tstudy
from vq_tpu_torch.bench.registry import build_quantizer
from vq_tpu_torch.core.config import Metric
from vq_tpu_torch.data.io import write_fvecs
from vq_tpu_torch.utils import export as texp
from vq_tpu_torch.utils import profiling as tprof

from test_torch_dist_sharded import assert_where_separated

torch.set_num_threads(1)

# the modules (each package's viz/__init__ exports the function ``plot``)
jplot = importlib.import_module("vq_tpu.viz.plot")
tplot = importlib.import_module("vq_tpu_torch.viz.plot")

CPU = dict(device="cpu")


def _data(seed, n=1200, d=48):
    rng = np.random.default_rng(seed)
    sigma = np.linspace(2.0, 0.1, d)
    x = (rng.standard_normal((n, d)) * sigma).astype(np.float32)
    q = (x[rng.integers(0, n, 25)] + 0.1 * sigma * rng.standard_normal((25, d))).astype(
        np.float32)
    return x, q


@pytest.fixture(scope="module")
def study_frames():
    x, q = _data(0)
    kw = dict(methods=["sq", "lvq", "ours"], bpds=[2.0, 8.0], ks=(1, 10), verbose=False)
    return jstudy.run_study_arrays(x, q, **kw), tstudy.run_study_arrays(x, q, **kw, **CPU)


def test_study_frame_has_jax_columns_and_rows(study_frames):
    want, got = study_frames
    assert list(got.columns) == list(want.columns)
    assert list(got["method"]) == list(want["method"]) and list(got["bpd"]) == list(want["bpd"])


@pytest.mark.parametrize("method", ["sq", "lvq"])
def test_study_rows_of_deterministic_fits_match_jax(study_frames, method):
    want, got = (f[f["method"] == method].reset_index(drop=True) for f in study_frames)
    for col in ("compression", "code_bytes", "recall@1", "recall@10"):
        assert list(got[col]) == list(want[col]), col
    np.testing.assert_allclose(got["mse"], want["mse"], rtol=1e-5)


def test_study_saq_rows_match_jax_on_quality(study_frames):
    want, got = (f[f["method"] == "ours"].reset_index(drop=True) for f in study_frames)
    np.testing.assert_allclose(got["recall@10"], want["recall@10"], atol=0.1)
    assert list(got["code_bytes"]) == list(want["code_bytes"])
    assert (got["mse"].diff().dropna() < 0).all()  # more bits, less error


@pytest.fixture(scope="module")
def planted_block_mse():
    """(SAQConfig, PCA variances, block MSE table) of the planted corpus
    (rank 32 in D=1536, the CLI's planted-NxD) as the port's SAQ fit makes
    them."""
    from vq_tpu_torch.core.config import SAQConfig
    from vq_tpu_torch.data.datasets import planted_arrays
    from vq_tpu_torch.methods import saq as tsaq

    cfg = SAQConfig()
    x, _ = planted_arrays(4096, 1536, 1, device="cpu")
    mean, rot, var = tsaq._pca(x)
    table = tsaq._uniform_caq_mse_table((x - mean) @ rot, cfg.max_bits, cfg.block_dims,
                                        cfg.seed)
    return cfg, var.numpy(), table.reshape(1536 // cfg.block_dims, cfg.block_dims, -1).sum(1)


@pytest.mark.parametrize("allocator", ["greedy", "dp"])
def test_planted_corpus_cannot_separate_saq_budgets(planted_block_mse, allocator):
    """Why the study's SAQ rows at bpd 1 and 2 agree on the planted corpus:
    its variance lies in PCA dims 0-31, inside the first block, which both
    budgets give the cap of max_bits; bpd 2 spends its other bits on blocks
    whose variance is f32 round-off, so the table's MSE does not move.  The
    port's allocator and the JAX package's give the same bits on the same
    block MSE table."""
    from vq_tpu.methods import saq as jsaq
    from vq_tpu_torch.methods import saq as tsaq

    cfg, var, block_mse = planted_block_mse
    assert var[:32].sum() / var.sum() > 1 - 1e-6
    nb = len(block_mse)
    lens = np.full(nb, cfg.block_dims, dtype=np.int64)
    bits, mse = {}, {}
    for bpd in (1, 2):
        args = (block_mse, lens, 1536 * bpd, cfg.max_bits)
        bits[bpd] = getattr(tsaq, f"_allocate_{allocator}")(*args)
        np.testing.assert_array_equal(bits[bpd], getattr(jsaq, f"_allocate_{allocator}")(*args))
        mse[bpd] = block_mse[np.arange(nb), bits[bpd]].sum()
    assert bits[1][0] == bits[2][0] == cfg.max_bits
    assert (bits[2] * lens).sum() > (bits[1] * lens).sum()  # the plans differ
    np.testing.assert_allclose(mse[2], mse[1], rtol=1e-6)


def test_study_aliases_resolve_as_jax():
    assert list(tstudy.STUDY_METHODS) == list(jstudy.STUDY_METHODS)
    for alias in tstudy.STUDY_METHODS:
        for bpd in (1.0, 2.0, 4.0, 12.0):
            base, params = tstudy._study_params(alias, bpd, 48)
            assert (base, params) == jstudy._study_params(alias, bpd, 48)
        t = build_quantizer(base, 48, **dict(params), **CPU)
        from vq_tpu.bench.registry import build_quantizer as jbuild

        assert t.cfg == convert.config_from_jax(jbuild(base, 48, **dict(params)).cfg), alias


def test_study_yaml_config_and_csv_as_jax(tmp_path):
    pytest.importorskip("pandas")
    pytest.importorskip("yaml")
    x, q = _data(2, n=600)
    write_fvecs(str(tmp_path / "base.fvecs"), x)
    write_fvecs(str(tmp_path / "query.fvecs"), q)
    yaml_path = tmp_path / "study.yaml"
    yaml_path.write_text(
        f"base_path: {tmp_path}/base.fvecs\nquery_path: {tmp_path}/query.fvecs\n"
        f"methods: [sq]\nbpd: [4.0]\nks: [1, 10]\noutput_dir: {tmp_path}/out\n"
        "plot: true\nunknown_key: 1\n")
    cfg = tstudy.load_study_config(str(yaml_path))
    assert cfg == tstudy.StudyConfig(**vars(jstudy.load_study_config(str(yaml_path))))
    if cfg.plot:
        pytest.importorskip("matplotlib")
    out = tstudy.run_study(cfg, **CPU)
    assert os.path.basename(out).startswith("results_") and out.endswith(".csv")
    import pandas as pd

    df = pd.read_csv(out)
    assert len(df) == 1 and df["recall@10"].iloc[0] > 0.5
    assert os.path.exists(tmp_path / "out" / "pareto.png")


# --------------------------------------------------------------- export
def _pq_pair(x, name):
    if name == "pq":
        cfg = PQConfig(num_subquantizers=4, num_bits=4)
        j = JaxPQ(cfg, seed=0).fit(x)
        t = convert.pq_from_numpy(np.asarray(j.params.codebooks), convert.config_from_jax(cfg),
                                  **CPU)
    elif name == "opq":
        cfg = OPQConfig(num_subquantizers=4, num_bits=4, opq_iters=2)
        j = JaxOPQ(cfg, seed=0).fit(x)
        t = convert.opq_from_numpy(type(j.params)(*map(np.asarray, j.params)),
                                   convert.config_from_jax(cfg), **CPU)
    elif name == "sq":
        j = JaxSQ(SQConfig(4)).fit(x)
        t = convert.sq_from_numpy(type(j.params)(*map(np.asarray, j.params)), x.shape[1],
                                  convert.config_from_jax(j.cfg), **CPU)
    else:  # parameters as a fit leaves them (export reads only the level table)
        d = x.shape[1]
        cfg = RankAwareConfig(bits_per_dim=2.0)
        j = JaxRA(cfg)
        levels = np.sort(np.random.default_rng(1).standard_normal((d, 8)), axis=1)
        j.params = jra.RankAwareParams(np.zeros(d, np.float32), np.eye(d, dtype=np.float32),
                                       levels.astype(np.float32))
        t = convert.rankaware_from_numpy(j.params, np.full(d, 2), None,
                                         convert.config_from_jax(cfg), **CPU)
    return j, t


@pytest.fixture(scope="module")
def export_data():
    return _data(3, n=800, d=16)


@pytest.mark.parametrize("name", ["pq", "opq", "sq", "rankaware"])
def test_extracted_and_exported_codebooks_equal_jax(export_data, tmp_path, name):
    x, _ = export_data
    j, t = _pq_pair(x, name)
    want = jexp.extract_codebook(j)
    got = texp.extract_codebook(t)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    codes = np.asarray(j.compress(x[:20])) if name != "rankaware" else None
    ej = jexp.export_codebook(j, str(tmp_path / "j"), codes=codes)
    et = texp.export_codebook(t, str(tmp_path / "t"),
                              codes=None if codes is None else torch.tensor(codes))
    assert set(et) == set(ej)
    for key in set(et) - {"codebook"}:
        assert open(et[key], "rb").read() == open(ej[key], "rb").read(), key


@pytest.mark.parametrize("name", ["pq", "opq", "sq"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_codebook_queries_equal_jax(export_data, tmp_path, name, metric):
    x, q = export_data
    j, t = _pq_pair(x, name)
    topk = 3
    ws, wi = jexp.query_codebook(q, model=j, topk=topk, metric=JMetric(metric))
    gs, gi = texp.query_codebook(q, model=t, topk=topk, metric=Metric(metric))
    assert isinstance(gs, np.ndarray) and gi.shape == np.asarray(wi).shape
    tol = 1e-5 * np.abs(np.asarray(ws)).max()
    chunks = gs.shape[1] // topk  # per-chunk top-k (PQ/OPQ), one block otherwise
    for c in range(chunks):
        sl = slice(c * topk, (c + 1) * topk)
        assert_where_separated(gi[:, sl], gs[:, sl], np.asarray(wi)[:, sl],
                               np.asarray(ws)[:, sl], tol)
    if name == "sq":  # from the exported file too
        path = texp.export_codebook(t, str(tmp_path))["codebook_path"]
        ps, pi = texp.query_codebook(q, codebook_path=path, topk=topk, metric=Metric(metric),
                                     **CPU)
        np.testing.assert_array_equal(pi, gi)


def test_export_refuses_what_jax_refuses(export_data):
    x, _ = export_data
    for model in (build_quantizer("lvq", 16, **CPU).fit(x),
                  build_quantizer("rabitq", 16, **CPU).fit(x)):
        with pytest.raises(RuntimeError, match="static codebook"):
            texp.extract_codebook(model)
    with pytest.raises(ValueError, match="fit the quantizer"):
        texp.extract_codebook(build_quantizer("pq", 16, M=4, **CPU))
    with pytest.raises(ValueError, match="provide model"):
        texp.query_codebook(x[:2], **CPU)
    _, t = _pq_pair(x, "pq")
    with pytest.raises(ValueError, match="product codebook shape"):
        texp.query_codebook(x[:2], model=t, codebook_vectors=np.zeros((3, 4), np.float32))


# ------------------------------------------------------------ profiling
@pytest.mark.parametrize("rows,nq,dim,cb", [(2048, 8, 64, 16.0), (1_000_000, 1024, 1536, 16)])
def test_scan_stats_equal_jax(rows, nq, dim, cb):
    j = jprof.ScanStats(num_rows=rows, num_queries=nq, dim=dim, code_bytes_per_row=cb)
    t = tprof.ScanStats(num_rows=rows, num_queries=nq, dim=dim, code_bytes_per_row=cb)
    assert t.report(0.01) == j.report(0.01)
    assert t.report_staged(0.01, 1, 4) == j.report_staged(0.01, 1, 4)
    assert (t.bytes_scanned, t.total_flops) == (j.bytes_scanned, j.total_flops)


# ----------------------------------------------------------------- plots
def test_plot_writes_the_jax_file_names_from_one_database(tmp_path):
    pytest.importorskip("matplotlib")
    db = str(tmp_path / "runs.db")
    for method, comp, rec in (("pq", 32, 0.8), ("sq", 4, 0.99), ("saq", 10, 0.9)):
        log_run(method, "dummy", {"compression_ratio": comp, "recall@10": rec,
                                  "mse": 1e-4 / comp, "pairwise_distortion": 0.1,
                                  "rank_distortion": 1 - rec, "qps": 1000}, {"x": 1},
                db_path=db)
    want = jplot.plot(db_path=db, output_dir=str(tmp_path / "j"))
    got = tplot.plot(db_path=db, output_dir=str(tmp_path / "t"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 7 and all(os.path.getsize(p) > 0 for p in got)
    assert got[4].endswith("comparison_table.txt")
    assert open(got[4], "rb").read() == open(want[4], "rb").read()


@pytest.mark.parametrize("pts", [[(1, 1), (2, 3), (3, 2), (4, 1), (2, 2)],
                                 [(0.5, 0.5)], [(1, 2), (1, 2), (0, 3)]])
def test_pareto_frontier_equals_jax(pts):
    assert tplot.pareto_frontier(pts) == jplot.pareto_frontier(pts)


def test_pareto_curves_write_a_figure(tmp_path):
    pd = pytest.importorskip("pandas")
    pytest.importorskip("matplotlib")
    df = pd.DataFrame({"method": ["pq", "pq", "ours", "ours"], "bpd": [1, 4, 1, 4],
                       "compression": [32, 8, 30, 7.5], "mse": [1e-3, 1e-5, 8e-4, 9e-6],
                       "recall@10": [0.8, 0.96, 0.85, 0.97]})
    p = tstudy.pareto_curves(df, str(tmp_path / "sub" / "pareto.png"), ks=(10,))
    assert os.path.getsize(p) > 0
