"""The port's sharded packed index (``vq_tpu_torch/dist/sharded_packed.py``)
against the JAX package's on the CPU.

The JAX index is fitted on its 8 virtual devices (the Pallas kernel runs in
interpret mode: ~5-14 s a search, so each JAX index is searched once, at
k < 32) and carried into the port through its ``_state()``
(``convert.sharded_packed_index_from_state``): the same per-shard caches
on ``make_mesh(devices=["cpu"] * 8)``, searched by the packed kernel's
plain twin.  The port's own fits are held to the converted index and to
the single-device flat index.

Tolerances: ids equal where separated and scores within
1e-4·(‖q‖² + 2·max‖x̂‖²) (``test_torch_dist_sharded.assert_where_separated``;
the packed score's f32 sums run in another order); the port against
itself (overlap chunks, save/load, converted against own caches): exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from vq_tpu.core.config import Metric, RaBitQConfig, SAQConfig, SearchConfig
from vq_tpu.dist.mesh import make_mesh as jax_make_mesh
from vq_tpu.dist.sharded_packed import ShardedPackedFlatIndex as JaxShardedPacked
from vq_tpu.methods.rabitq import RaBitQ as JaxRaBitQ
from vq_tpu.methods.saq import SAQ as JaxSAQ
from vq_tpu_torch import convert
from vq_tpu_torch.dist.sharded_packed import ShardedPackedFlatIndex
from vq_tpu_torch.index.flat import FlatQuantizedIndex

from test_torch_dist_sharded import assert_where_separated, cpu_mesh, score_tol

torch.set_num_threads(1)

N, D, NQ = 2600, 48, 12


@pytest.fixture(scope="module")
def data():
    """Norm-heterogeneous rows (so the prune stage can fire), queries near
    corpus rows (the JAX test's corpus)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((N, D)) * (1.0 + np.arange(D))[::-1] ** 0.5).astype(np.float32)
    x *= np.exp(0.5 * rng.standard_normal((N, 1))).astype(np.float32)
    q = (x[rng.integers(0, N, NQ)] + 0.05 * rng.standard_normal((NQ, D))).astype(np.float32)
    return x, q


def _port_quantizer(jq):
    params = jax.tree_util.tree_map(np.asarray, jq.params)
    cfg = convert.config_from_jax(jq.cfg)
    if isinstance(jq, JaxSAQ):
        return convert.saq_from_numpy(jq.plan, params, cfg, device="cpu")
    return convert.rabitq_from_numpy(params, cfg, device="cpu")


def _pair(x, jq, metric=Metric.L2):
    j = JaxShardedPacked(jq, SearchConfig(metric=metric, use_bf16=False),
                         mesh=jax_make_mesh()).fit(x)
    return j, convert.sharded_packed_index_from_state(_port_quantizer(jq), j._state(),
                                                      cpu_mesh())


def _tol(index, q, x, metric):
    x_hat = index.quantizer.decompress(index.quantizer.compress(x)).numpy()
    if metric == Metric.NIP:
        x_hat = x_hat / np.linalg.norm(x, axis=1, keepdims=True)
    return score_tol(q, x_hat)


@pytest.mark.parametrize("name,metric", [("saq", Metric.L2), ("saq", Metric.NIP),
                                         ("rabitq", Metric.L2)])
def test_converted_index_searches_like_jax(data, name, metric):
    x, q = data
    jq = (JaxSAQ(SAQConfig(bits_per_dim=2.0, use_pca=True)) if name == "saq"
          else JaxRaBitQ(RaBitQConfig(num_bits=2))).fit(x)
    j, t = _pair(x, jq, metric)
    assert t.num_shards == 8 and t._n_loc == j._n_loc and t.num_rows == N
    assert t.memory_footprint() == j.memory_footprint()
    wi, ws = j.search_with_scores(q, k=8)
    gi, gs = t.search_with_scores(q, k=8)
    assert gi.dtype == np.uint32 and int(gi.max()) < N
    tol = _tol(t, q, x, metric)
    assert_where_separated(gi, gs, wi, ws, tol)
    # the port's own fit from the same quantizer: the same caches' results
    own = ShardedPackedFlatIndex(t.quantizer, t.search_cfg, cpu_mesh()).fit(x)
    oi, os_ = own.search_with_scores(q, k=8)
    assert_where_separated(oi, os_, gi, gs, tol)
    # and the single-device flat index (one global norm order)
    fi, fs = FlatQuantizedIndex(t.quantizer, t.search_cfg).fit(x).search_with_scores(q, k=8)
    assert_where_separated(oi, os_, fi, fs, tol)


@pytest.mark.parametrize("k", [5, 40])
def test_overlap_chunks_equal_one_chunk(data, k):
    """On 2 shards of 3 tiles each: 3 overlap chunks (a factor-column
    slice each) give the one-chunk result bit for bit."""
    x, q = data
    saq = _port_quantizer(JaxSAQ(SAQConfig(bits_per_dim=2.0, use_pca=True)).fit(x))
    idx = ShardedPackedFlatIndex(saq, dataclasses.replace(convert.config_from_jax(
        SearchConfig(use_bf16=False))), cpu_mesh(2)).fit(x)
    assert idx._n_loc == 1536
    # SAQ norm-orders each shard of more than one tile, pad rows at its tail
    assert not torch.equal(idx.shards[1].perm, torch.arange(1536, dtype=torch.int32))
    assert sorted(idx.shards[1].perm.tolist()) == list(range(1536))
    a, b = idx.search_with_scores(q, k), idx.search_with_scores(q, k, overlap_chunks=3)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_save_load_and_a_mesh_of_another_size(data, tmp_path):
    x, q = data
    saq = _port_quantizer(JaxSAQ(SAQConfig(bits_per_dim=2.0, use_pca=True)).fit(x))
    cfg = convert.config_from_jax(SearchConfig(use_bf16=False))
    idx = ShardedPackedFlatIndex(saq, cfg, cpu_mesh(4)).fit(x)
    ids, scores = idx.search_with_scores(q, k=6)
    path = str(tmp_path / "spf.pkl")
    idx.save(path)
    back = ShardedPackedFlatIndex(saq, cfg, cpu_mesh(4)).load(path)
    ids2, scores2 = back.search_with_scores(q, k=6)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_array_equal(scores, scores2)
    assert back.memory_footprint() == idx.memory_footprint()
    with pytest.raises(ValueError, match="shards"):
        ShardedPackedFlatIndex(saq, cfg, cpu_mesh(3)).load(path)
