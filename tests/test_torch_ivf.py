"""The port's residual IVF index (``vq_tpu_torch/index/ivf.py``:
``IvfQuantizedIndex``, ``scan_union_lists``, ``scan_probed_lists``,
``fit_quantizer_on_residuals``) against the JAX package's on the CPU.

The JAX index is fitted on seeded data (its own coarse k-means and residual
quantizers: PQ, SAQ, RaBitQ, RankAware) and carried into the port through
numpy (``convert.ivf_index_from_numpy``), so both search the same lists
with the same parameters.  Both compute in f32 (the JAX package's list
scans use HIGHEST precision; the port's have TF32 off).

Tolerances and their reasons:
* ids: equal except inside runs of scores equal to 1e-5 relative
  (``test_torch_flat_index.assert_same_ranking``): f32 sums in another order
  may swap exact-to-rounding ties.
* scores: within 1e-5 of the largest |score| (``assert_close_scores``): an
  L2 score is ‖q−c‖² − 2q·r̂ + 2c·r̂ + ‖r̂‖², a difference of terms larger
  than the result.
* union against windows, slabs against one shot, the own build against the
  carried one: the same bars (both are exact over the same candidates).
* layouts (row order, offsets, sizes, ids, footprint): exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core.config import (
    IVFConfig,
    KMeansConfig,
    LVQConfig,
    Metric,
    PQConfig,
    RaBitQConfig,
    RankAwareConfig,
    SAQConfig,
    SearchConfig,
)
from vq_tpu.index import ivf as jivf
from vq_tpu.kernels.kmeans import kmeans as jax_kmeans
from vq_tpu.methods.lvq import LVQ as JaxLVQ
from vq_tpu.methods.pq import PQ as JaxPQ
from vq_tpu.methods.rabitq import RaBitQ as JaxRaBitQ
from vq_tpu.methods.rankaware import RankAware as JaxRankAware
from vq_tpu.methods.saq import SAQ as JaxSAQ
from vq_tpu_torch import convert
from vq_tpu_torch.index import ivf as tivf
from vq_tpu_torch.kernels.adc import exact_topk
from vq_tpu_torch.methods.lvq import LVQ

from test_torch_flat_index import assert_close_scores, assert_same_ranking

torch.set_num_threads(1)

N, D, K, NQ = 4000, 32, 16, 12
QUANTIZERS = {
    "pq": lambda: JaxPQ(PQConfig(8, 6, KMeansConfig(iters=6)), seed=0),
    "saq": lambda: JaxSAQ(SAQConfig(bits_per_dim=2.0, block_dims=16)),
    "rabitq": lambda: JaxRaBitQ(RaBitQConfig(num_bits=2)),
    "rankaware": lambda: JaxRankAware(RankAwareConfig(bits_per_dim=2.0)),
}


@pytest.fixture(scope="module")
def data():
    """16 Gaussian blobs of unequal sizes (one holds a quarter of the rows)
    and falling spread; queries near corpus rows."""
    rng = np.random.default_rng(60)
    centers = 3.0 * rng.standard_normal((K, D)) * np.linspace(1.5, 0.3, D)
    p = np.full(K, 0.75 / (K - 1))
    p[5] = 0.25
    x = centers[rng.choice(K, N, p=p)] + rng.standard_normal((N, D)) * np.linspace(1.0, 0.2, D)
    x = x.astype(np.float32)
    q = (x[rng.integers(0, N, NQ)] + 0.1 * rng.standard_normal((NQ, D))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def coarse(data):
    x, _ = data
    cent = jax_kmeans(jax.random.PRNGKey(0), jnp.asarray(x), K, KMeansConfig(iters=8))
    return np.array(cent), jivf.chunked_assign(x, cent, 4096)


def _carry_quantizer(jq):
    cfg = convert.config_from_jax(jq.cfg)
    params = jax.tree_util.tree_map(np.asarray, jq.params)
    if isinstance(jq, JaxPQ):
        return convert.pq_from_numpy(params.codebooks, cfg, device="cpu")
    if isinstance(jq, JaxSAQ):
        return convert.saq_from_numpy(jq.plan, params, cfg, device="cpu")
    if isinstance(jq, JaxRaBitQ):
        return convert.rabitq_from_numpy(params, cfg, device="cpu")
    return convert.rankaware_from_numpy(params, jq.bits, jq.layout, cfg, device="cpu")


def _carry(j):
    return convert.ivf_index_from_numpy(
        _carry_quantizer(j.quantizer), np.asarray(j.centroids), np.asarray(j.codes_sorted),
        np.asarray(j.ids_sorted), np.asarray(j.norms_sorted), np.asarray(j.offsets),
        np.asarray(j.sizes), j._inv_perm, j._assignment, j.ivf_cfg, j.search_cfg)


@pytest.fixture(scope="module")
def pairs(data, coarse):
    x, _ = data
    out = {}
    for name, make in QUANTIZERS.items():
        j = jivf.IvfQuantizedIndex(make(), IVFConfig(K, 3, KMeansConfig(iters=8)))
        j.fit(x, coarse=(jnp.asarray(coarse[0]), coarse[1]))
        out[name] = (j, _carry(j))
    return out


def _set(index, nprobe, metric, jax_side):
    index.ivf_cfg = dataclasses.replace(index.ivf_cfg, nprobe=nprobe)
    index.search_cfg = dataclasses.replace(index.search_cfg, metric=metric)
    if jax_side:
        index._search_fn = None  # the JAX index caches a jitted search per config


@pytest.mark.parametrize("name", sorted(QUANTIZERS))
@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP, Metric.NIP])
def test_converted_index_searches_like_jax(pairs, data, name, metric):
    """nprobe=3, k=10, both strategies; the port's union = its windows."""
    j, t = pairs[name]
    _, q = data
    _set(j, 3, metric, True)
    _set(t, 3, convert.config_from_jax(SearchConfig(metric=metric)).metric, False)
    got = {}
    for strategy in ("union", "windows"):
        wi, ws = j.search_with_scores(q, 10, strategy=strategy)
        gi, gs = t.search_with_scores(q, 10, strategy=strategy)
        assert gi.dtype == np.uint32 and gi.shape == (NQ, 10) and gs.dtype == np.float32
        assert_same_ranking(gi, wi, ws)
        assert_close_scores(gs, ws)
        got[strategy] = (gi, gs)
    assert_same_ranking(got["windows"][0], *got["union"])
    assert_close_scores(got["windows"][1], got["union"][1])


@pytest.mark.parametrize("name", sorted(QUANTIZERS))
def test_memory_footprint_decompress_and_mse_equal_jax(pairs, data, name):
    j, t = pairs[name]
    x, _ = data
    assert t.memory_footprint() == j.memory_footprint()
    ids = np.array([0, 17, 999, N - 1, 5])
    want = np.asarray(j.decompress(ids))
    np.testing.assert_allclose(t.decompress(ids).numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(t.reconstruction_mse(x, 1000), j.reconstruction_mse(x, 1000),
                               rtol=1e-4)


def test_pq_nine_bits_keeps_uint16_codes(data, coarse):
    """PQ at B=9 stores uint16 codes in the lists, as the JAX package does."""
    x, q = data
    j = jivf.IvfQuantizedIndex(JaxPQ(PQConfig(4, 9, KMeansConfig(iters=3)), seed=0),
                               IVFConfig(K, 2, KMeansConfig(iters=8)))
    j.fit(x, coarse=(jnp.asarray(coarse[0]), coarse[1]))
    t = _carry(j)
    assert t.codes_sorted.dtype == torch.uint16
    assert t.memory_footprint() == j.memory_footprint()
    wi, ws = j.search_with_scores(q, 10)
    gi, gs = t.search_with_scores(q, 10)
    assert_same_ranking(gi, wi, ws)
    assert_close_scores(gs, ws)


@pytest.mark.parametrize("name", ["pq", "saq"])
def test_slab_recompute_equals_one_shot(pairs, data, monkeypatch, name):
    """_QRS_SLAB_BYTES shrunk to a two-probe slab (and to one probe): the
    probed ‖q−c‖² in slabs gives the one-shot result bit for bit."""
    _, t = pairs[name]
    _, q = data
    _set(t, 5, convert.config_from_jax(SearchConfig()).metric, False)
    whole = t.search_with_scores(q, 10)
    for slab_probes in (2, 1):
        monkeypatch.setattr(tivf, "_QRS_SLAB_BYTES", 4 * 16 * D * slab_probes)
        sl = t.search_with_scores(q, 10)
        np.testing.assert_array_equal(sl[0], whole[0])
        np.testing.assert_array_equal(sl[1], whole[1])


def test_small_decode_budget_splits_the_batch_into_query_blocks(pairs, data, monkeypatch):
    """_DECODE_BUDGET_BYTES shrunk to nothing: the union runs 40 queries in
    blocks of 16 (the last one padded), the windows strategy one query a
    block; both equal the one-block search."""
    _, t = pairs["saq"]
    _, q = data
    qq = np.concatenate([q, q[::-1] + 0.05, q + 0.1, q[:4] - 0.05])
    _set(t, 3, convert.config_from_jax(SearchConfig()).metric, False)
    whole = {s: t.search_with_scores(qq, 10, strategy=s) for s in ("union", "windows")}
    monkeypatch.setattr(tivf, "_DECODE_BUDGET_BYTES", 1)
    for strategy, (wi, ws) in whole.items():
        gi, gs = t.search_with_scores(qq, 10, strategy=strategy)
        assert gi.shape == (40, 10)
        assert_same_ranking(gi, wi, ws)
        assert_close_scores(gs, ws)


def test_pad_queries_add_no_probes(pairs, data):
    """A block of 16 with 5 real queries: the 11 zero pad rows are masked
    out of the union, so its rows are the real queries' lists only, and the
    result equals the per-query window scan."""
    _, t = pairs["pq"]
    _, q = data
    _set(t, 2, convert.config_from_jax(SearchConfig()).metric, False)
    u = t.search_with_scores(q[:5], 10, strategy="union")
    w = t.search_with_scores(q[:5], 10, strategy="windows")
    assert_same_ranking(u[0], *w)
    qq = torch.cat([torch.from_numpy(q[:5]), torch.zeros((11, D))])
    cd = tivf.pairwise_sqdist_xc(qq, t.centroids)
    probe = tivf.ordered_topk(-cd, 2)[1]
    valid = torch.arange(16) < 5
    args = (t.centroids, t.codes_sorted, t.ids_sorted, t.norms_sorted, t.offsets, t.sizes,
            t.quantizer.decode_fn(), 10, t.search_cfg.metric)
    s_mask, i_mask = tivf.scan_union_lists(qq, probe, cd, *args, chunk=256, q_valid=valid)
    s_real, i_real = tivf.scan_union_lists(qq[:5], probe[:5], cd[:5], *args, chunk=256)
    assert torch.equal(i_mask[:5], i_real) and torch.equal(s_mask[:5], s_real)
    # the pad rows probed no list of their own: nothing they see is theirs
    pad_only = set(probe[5:].reshape(-1).tolist()) - set(probe[:5].reshape(-1).tolist())
    assert all(int(t._assignment[i]) not in pad_only
               for i in i_mask[5:].reshape(-1).tolist() if i > 0)


def test_skewed_cluster_walks_many_windows(pairs, data):
    """The quarter-of-the-corpus cluster (about 950 rows) against 128-row
    windows: the windows strategy walks 7+ windows for it, the union its
    rows in several windows; both equal JAX's."""
    j, t = pairs["saq"]
    _, q = data
    assert t.max_cluster > 6 * 128
    big = int(torch.argmax(t.sizes))
    cd = ((q[:, None, :] - np.asarray(j.centroids)[None]) ** 2).sum(-1)
    qb = q[np.argsort(cd[:, big])[:4]]  # the queries nearest the big cluster
    _set(j, 2, Metric.L2, True)
    _set(t, 2, convert.config_from_jax(SearchConfig()).metric, False)
    for strategy, chunk in (("windows", 128), ("union", 256)):
        wi, ws = j.search_with_scores(qb, 10, strategy=strategy, chunk=chunk)
        gi, gs = t.search_with_scores(qb, 10, strategy=strategy, chunk=chunk)
        assert_same_ranking(gi, wi, ws)
        assert_close_scores(gs, ws)


def test_fewer_candidates_than_k_leave_minus_inf_and_id_zero(pairs, data):
    """nprobe=1 on the smallest cluster with k above its size: the empty
    slots hold −inf with id 0 (the JAX package's running top-k)."""
    j, t = pairs["pq"]
    small = int(torch.argmin(t.sizes))
    qs = t.centroids[small:small + 1].numpy()
    k = int(t.sizes[small]) + 5
    _set(j, 1, Metric.IP, True)
    _set(t, 1, convert.config_from_jax(SearchConfig(metric=Metric.IP)).metric, False)
    wi, ws = j.search_with_scores(qs, k)
    gi, gs = t.search_with_scores(qs, k)
    np.testing.assert_array_equal(gi, wi)
    assert np.isneginf(gs[0, -5:]).all() and (gi[0, -5:] == 0).all()


@pytest.mark.parametrize("name", ["pq", "rankaware"])
def test_own_build_with_coarse_equals_carried(pairs, data, coarse, name):
    """fit(coarse=…) with the carried quantizer: the same row order, CSR
    arrays and codes byte for byte; the same search results."""
    j, carried = pairs[name]
    x, q = data
    t = tivf.IvfQuantizedIndex(carried.quantizer, carried.ivf_cfg, carried.search_cfg)
    t.fit(x, coarse=coarse)
    for name_ in ("ids_sorted", "offsets", "sizes", "codes_sorted"):
        np.testing.assert_array_equal(getattr(t, name_).numpy(),
                                      getattr(carried, name_).numpy())
    np.testing.assert_allclose(t.norms_sorted.numpy(), carried.norms_sorted.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(t._inv_perm.numpy(), carried._inv_perm.numpy())
    assert t.max_cluster == j.max_cluster and t.num_rows == N
    _set(t, 3, carried.search_cfg.metric, False)
    _set(carried, 3, carried.search_cfg.metric, False)
    gi, gs = t.search_with_scores(q, 10)
    ci, cs = carried.search_with_scores(q, 10)
    np.testing.assert_array_equal(gi, ci)
    np.testing.assert_allclose(gs, cs, rtol=1e-6, atol=1e-6)


def test_residual_sample_is_jax_s(data, coarse, monkeypatch):
    """fit_quantizer_on_residuals draws JAX's rows (numpy default_rng): an
    LVQ fitted on the residual sample has JAX's mean."""
    x, _ = data
    cent = np.asarray(coarse[0])
    jq = JaxLVQ(LVQConfig(4))
    jivf.fit_quantizer_on_residuals(x, coarse[1], jnp.asarray(cent), jq, cap=1500, seed=3)
    tq = LVQ(convert.config_from_jax(LVQConfig(4)), device="cpu")
    tivf.fit_quantizer_on_residuals(x, torch.from_numpy(coarse[1]), torch.from_numpy(cent), tq,
                                    cap=1500, seed=3)
    np.testing.assert_allclose(tq.params.mean.numpy(), np.asarray(jq.params.mean), rtol=1e-5,
                               atol=1e-6)


def test_own_fit_save_load_and_recall(data, tmp_path):
    """The port's own coarse pass and residual fit, on a CPU tensor corpus:
    full probe = the exact top-k of the index's own reconstructions; a
    save/load round trip searches alike."""
    x, q = data
    cfg = convert.config_from_jax(IVFConfig(K, K, KMeansConfig(iters=5)))
    from vq_tpu_torch.methods.saq import SAQ

    t = tivf.IvfQuantizedIndex(SAQ(convert.config_from_jax(SAQConfig(2.0, block_dims=16))),
                               cfg).fit(torch.from_numpy(x))
    assert t.device == torch.device("cpu") and sorted(t.ids_sorted[:N].tolist()) == list(range(N))
    gi, gs = t.search_with_scores(q, 10)
    rec = t.decompress(np.arange(N))
    ws, wi = exact_topk(torch.from_numpy(q), rec, 10)
    assert_same_ranking(gi, wi.numpy(), ws.numpy(), rtol=1e-4)
    np.testing.assert_allclose(gs, ws.numpy(), rtol=1e-4, atol=1e-4)
    path = str(tmp_path / "ivf.pkl")
    t.save(path)
    back = tivf.IvfQuantizedIndex(SAQ(convert.config_from_jax(SAQConfig()), device="cpu"))
    back.load(path)
    assert back.ivf_cfg == t.ivf_cfg and back.memory_footprint() == t.memory_footprint()
    for strategy in ("union", "windows"):
        bi, bs = back.search_with_scores(q, 10, strategy=strategy)
        ti, ts = t.search_with_scores(q, 10, strategy=strategy)
        np.testing.assert_array_equal(bi, ti)
        np.testing.assert_array_equal(bs, ts)


def test_windows_chunk_above_the_padding_is_refused(pairs, data):
    _, t = pairs["pq"]
    with pytest.raises(ValueError, match="chunk"):
        t.search_with_scores(data[1], 5, strategy="windows", chunk=2048)
