"""The port's sharded probed-tile IVF index
(``vq_tpu_torch/dist/sharded_ivf_packed.py``) against the JAX package's on
the CPU, and against the port's own single-device indexes.

One JAX index is fitted on its 8 virtual devices and searched once (the
Pallas kernel runs in interpret mode, ~5-14 s a search, at k < 32), then
carried into the port through its ``_state()``
(``convert.sharded_ivf_packed_index_from_state``).  The port's own fits on
the same coarse pass are held to it, to ``IvfPackedFlatIndex`` (the shard
blocks are 512-row multiples, so every shard tile is a global tile and the
tile masks agree: equal bit for bit) and, at a full probe, to the flat
packed index.

Tolerances: ids equal where separated and scores within
1e-4·(‖q‖² + 2·max‖x̂‖²) (``test_torch_dist_sharded.assert_where_separated``;
f32 sums in another order); the port against its own single-device index,
its one-shard mesh and its save/load round trip: exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from vq_tpu.core.config import IVFConfig, KMeansConfig, RaBitQConfig, SAQConfig, SearchConfig
from vq_tpu.dist.mesh import make_mesh as jax_make_mesh
from vq_tpu.dist.sharded_ivf_packed import ShardedIvfPackedIndex as JaxShardedIvfPacked
from vq_tpu.methods.saq import SAQ as JaxSAQ
from vq_tpu_torch import convert
from vq_tpu_torch.dist.sharded_ivf_packed import ShardedIvfPackedIndex
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.index.ivf import chunked_assign
from vq_tpu_torch.index.ivf_packed import IvfPackedFlatIndex
from vq_tpu_torch.methods.rabitq import RaBitQ

from test_torch_dist_sharded import assert_where_separated, cpu_mesh, score_tol

torch.set_num_threads(1)

N, D, K, NQ = 9000, 32, 8, 10


def _ivf(nprobe=2):
    return IVFConfig(num_clusters=K, nprobe=nprobe, kmeans=KMeansConfig(iters=8))


@pytest.fixture(scope="module")
def data():
    """8 Gaussian blobs of unequal sizes; queries near corpus rows."""
    rng = np.random.default_rng(41)
    centers = 4.0 * rng.standard_normal((K, D))
    p = np.linspace(2.0, 0.5, K)
    x = centers[rng.choice(K, N, p=p / p.sum())] + rng.standard_normal((N, D))
    x = x.astype(np.float32)
    q = (x[rng.integers(0, N, NQ)] + 0.1 * rng.standard_normal((NQ, D))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def pair(data):
    """A JAX index on 8 shards, its one search at k=7 and its port copy."""
    x, q = data
    jq = JaxSAQ(SAQConfig(bits_per_dim=2.0, use_pca=True))
    j = JaxShardedIvfPacked(jq, _ivf(), SearchConfig(use_bf16=False),
                            mesh=jax_make_mesh()).fit(x)
    want = j.search_with_scores(q, k=7)
    saq = convert.saq_from_numpy(jq.plan, jax.tree_util.tree_map(np.asarray, jq.params),
                                 convert.config_from_jax(jq.cfg), device="cpu")
    t = convert.sharded_ivf_packed_index_from_state(saq, j._state(), cpu_mesh())
    coarse = (np.array(j.centroids), chunked_assign(x, t.centroids, 4096))
    return j, want, t, coarse


def _tol(index, q, x):
    return score_tol(q, index.quantizer.decompress(index.quantizer.compress(x)).numpy())


def test_converted_index_searches_like_jax(data, pair):
    x, q = data
    j, (wi, ws), t, _ = pair
    assert t.num_shards == 8 and t._n_loc == j._n_loc == 1536 and t.num_rows == N
    assert t.memory_footprint() == j.memory_footprint()
    gi, gs = t.search_with_scores(q, k=7)
    assert gi.dtype == np.uint32 and gi.shape == (NQ, 7) and int(gi.max()) < N
    assert_where_separated(gi, gs, wi, ws, _tol(t, q, x))


def test_own_fit_equals_the_single_device_index(data, pair):
    """The port's own fit on JAX's coarse pass (3 shards; the last holds the
    216 pad rows): the converted index's results where separated, and the
    single-device IvfPackedFlatIndex's on the same coarse pass bit for bit,
    at two nprobes."""
    x, q = data
    _, _, t, coarse = pair
    own = ShardedIvfPackedIndex(t.quantizer, t.ivf_cfg, t.search_cfg, cpu_mesh(3)).fit(
        x, coarse=coarse)
    assert own._n_loc == 3072 and own._ids[2][-1] == -1
    single = IvfPackedFlatIndex(t.quantizer, t.ivf_cfg, t.search_cfg).fit(x, coarse=coarse)
    tol = _tol(t, q, x)
    for nprobe in (2, 5):
        for index in (own, single, t):
            index.ivf_cfg = dataclasses.replace(index.ivf_cfg, nprobe=nprobe)
        oi, os_ = own.search_with_scores(q, 7)
        si, ss = single.search_with_scores(q, 7)
        np.testing.assert_array_equal(oi, si)
        np.testing.assert_array_equal(os_, ss)
        ci, cs = t.search_with_scores(q, 7)
        assert_where_separated(oi, os_, ci, cs, tol)
    t.ivf_cfg = dataclasses.replace(t.ivf_cfg, nprobe=2)


def test_full_probe_equals_the_flat_packed_scan(data, pair):
    x, q = data
    _, _, t, coarse = pair
    own = ShardedIvfPackedIndex(t.quantizer, dataclasses.replace(t.ivf_cfg, nprobe=K),
                                t.search_cfg, cpu_mesh(4)).fit(x, coarse=coarse)
    gi, gs = own.search_with_scores(q, 20)
    fi, fs = FlatQuantizedIndex(t.quantizer, t.search_cfg).fit(x).search_with_scores(q, 20)
    assert_where_separated(gi, gs, fi, fs, _tol(t, q, x))


def test_one_shard_mesh_and_rabitq_equal_the_single_device_index(data, pair):
    """RaBitQ B=2 on 1 and 4 shards, its own coarse k-means from one seed:
    the single-device index's results bit for bit."""
    x, q = data
    cfg = convert.config_from_jax(_ivf(nprobe=3))
    sc = convert.config_from_jax(SearchConfig(use_bf16=False))
    rbq = RaBitQ(convert.config_from_jax(RaBitQConfig(num_bits=2)), device="cpu").fit(x)
    single = IvfPackedFlatIndex(rbq, cfg, sc).fit(x)
    want = single.search_with_scores(q, 9)
    for p in (1, 4):
        sh = ShardedIvfPackedIndex(rbq, cfg, sc, cpu_mesh(p)).fit(x)
        assert torch.equal(sh.centroids, single.centroids)
        got = sh.search_with_scores(q, 9)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_save_load_and_a_mesh_of_another_size(data, pair, tmp_path):
    x, q = data
    _, _, t, _ = pair
    ids, scores = t.search_with_scores(q, 5)
    path = str(tmp_path / "sivfpk.pkl")
    t.save(path)
    back = ShardedIvfPackedIndex(t.quantizer, mesh=cpu_mesh()).load(path)
    assert back.ivf_cfg == t.ivf_cfg and back.memory_footprint() == t.memory_footprint()
    ids2, scores2 = back.search_with_scores(q, 5)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_array_equal(scores, scores2)
    with pytest.raises(ValueError, match="shards"):
        ShardedIvfPackedIndex(t.quantizer, mesh=cpu_mesh(4)).load(path)
