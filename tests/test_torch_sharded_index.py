"""The port's sharded flat indexes (``vq_tpu_torch/dist/sharded_index.py``:
``ShardedFlatPQIndex``, ``ShardedFlatIndex``) against the JAX package's on
the CPU: the JAX index on its 8 virtual devices, the port's on
``make_mesh(devices=["cpu"] * 8)`` holding the JAX index's codes and norms
(``convert.sharded_flat_*``), and against the port's own single-device
``FlatQuantizedIndex`` on the same codes.

Tolerances: ids equal where separated and scores within
1e-4·(‖q‖² + 2·max‖x̂‖²) (``test_torch_dist_sharded.assert_where_separated``:
f32 sums in another order); layouts, footprints and the port's own runs
against each other (overlap chunks, ingestion paths): exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from vq_tpu.core.config import KMeansConfig, Metric, PQConfig, SearchConfig, SQConfig
from vq_tpu.dist.sharded_index import ShardedFlatIndex as JaxShardedFlat
from vq_tpu.dist.sharded_index import ShardedFlatPQIndex as JaxShardedPQ
from vq_tpu.methods.pq import PQ as JaxPQ
from vq_tpu.methods.sq import SQ as JaxSQ
from vq_tpu_torch import convert
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.dist.sharded_index import ShardedFlatIndex, ShardedFlatPQIndex
from vq_tpu_torch.kernels.pq_scan import decode_pq

from test_torch_dist_sharded import assert_where_separated, cpu_mesh, score_tol

torch.set_num_threads(1)

PQ_CFG = PQConfig(num_subquantizers=4, num_bits=6, kmeans=KMeansConfig(iters=6))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((2005, 32)) * np.linspace(2.0, 0.5, 32)).astype(np.float32)
    q = (x[rng.integers(0, 2005, 14)] + 0.1 * rng.standard_normal((14, 32))).astype(np.float32)
    return x, q


def _pq_pair(x, metric):
    j = JaxShardedPQ(JaxPQ(PQ_CFG, seed=0), SearchConfig(metric=metric, use_bf16=False)).fit(x)
    t = convert.sharded_flat_pq_index_from_numpy(
        np.asarray(j.pq.params.codebooks), np.asarray(j.codes), np.asarray(j.norms),
        j.num_rows, j.search_cfg, PQ_CFG, cpu_mesh())
    return j, t


@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP, Metric.NIP])
def test_sharded_pq_index_matches_jax_and_the_flat_index(data, metric):
    x, q = data
    j, t = _pq_pair(x, metric)
    assert t.num_shards == j.num_shards == 8
    assert t.memory_footprint() == j.memory_footprint()
    cb = t.pq.params.codebooks
    codes = torch.cat(t.codes)[:len(x)]
    x_hat = decode_pq(cb, codes).numpy()
    if metric == Metric.NIP:
        x_hat = x_hat / np.linalg.norm(x, axis=1, keepdims=True)
    tol = score_tol(q, x_hat)
    flat = convert.flat_index_of(t.pq, codes, np.linalg.norm(x, axis=1), len(x),
                                 t.search_cfg)
    for k in (10, 40):
        wi, ws = j.search_with_scores(q, k)
        gi, gs = t.search_with_scores(q, k)
        assert gi.dtype == np.uint32 and gi.shape == (14, k) and int(gi.max()) < len(x)
        assert_where_separated(gi, gs, wi, ws, tol)
        fi, fs = flat.search_with_scores(q, k)
        assert_where_separated(gi, gs, fi, fs, tol)


def test_sharded_pq_fit_and_ingestion_give_the_same_index(data):
    """The port's own fit (the converted codebooks, its own encode) and the
    ingestion path (``add_sharded``) hold the same codes and search alike;
    P=3 leaves N ragged, and no pad row surfaces."""
    x, q = data
    _, t = _pq_pair(x, Metric.L2)
    mesh = cpu_mesh(3)
    own = ShardedFlatPQIndex(t.pq, t.search_cfg, mesh).fit(x)
    codes = t.pq.compress(x)
    assert torch.equal(torch.cat(own.codes)[:len(x)], codes)
    assert own.num_rows == len(x) and sum(c.shape[0] for c in own.codes) == 2007
    ing = ShardedFlatPQIndex(t.pq, t.search_cfg, mesh)
    ing.add_sharded(codes.numpy(), np.linalg.norm(x, axis=1), len(x))
    a, b = own.search_with_scores(q, 10), ing.search_with_scores(q, 10)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert own.reconstruction_mse(x) == t.pq.reconstruction_mse(x)
    ids, _ = ShardedFlatPQIndex(t.pq, t.search_cfg, mesh).fit(x[:5]).search_with_scores(q, 8)
    assert int(ids.max()) < 5  # fewer rows than k: empty slots, never a pad row


@pytest.mark.parametrize("metric", [Metric.L2, Metric.NIP])
def test_sharded_generic_index_matches_jax(data, metric):
    """SQ 8-bit on the generic decode→score scan, overlap_chunks 1 and 4."""
    x, q = data
    sc = SearchConfig(metric=metric, use_bf16=False)
    j = JaxShardedFlat(JaxSQ(SQConfig(num_bits=8)), sc).fit(x)
    tq = convert.sq_from_numpy(jax.tree_util.tree_map(np.asarray, j.quantizer.params),
                               x.shape[1], convert.config_from_jax(j.quantizer.cfg),
                               device="cpu")
    t = convert.sharded_flat_index_of(tq, np.asarray(j.codes), np.asarray(j.norms), j.num_rows,
                                      sc, cpu_mesh())
    assert isinstance(t, ShardedFlatIndex) and t.memory_footprint() == j.memory_footprint()
    x_hat = tq.decompress(torch.cat(t.codes)[:len(x)]).numpy()
    if metric == Metric.NIP:
        x_hat = x_hat / np.linalg.norm(x, axis=1, keepdims=True)
    wi, ws = j.search_with_scores(q, 10)
    runs = [t.search_with_scores(q, 10, overlap_chunks=c) for c in (1, 4)]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert_where_separated(runs[0][0], runs[0][1], wi, ws, score_tol(q, x_hat))
    flat = FlatQuantizedIndex(tq, dataclasses.replace(t.search_cfg)).fit(x)
    fi, fs = flat.search_with_scores(q, 10)
    assert_where_separated(runs[0][0], runs[0][1], fi, fs, score_tol(q, x_hat))
