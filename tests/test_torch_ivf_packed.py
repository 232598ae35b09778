"""The port's probed-tile IVF index (``vq_tpu_torch/index/ivf_packed.py``)
against the JAX package's (``vq_tpu/index/ivf_packed.py``), on the CPU.

The JAX side runs its Pallas gather kernel in interpret mode; the port runs
the plain twin of its gather kernel.  Both compute in f32 on the CPU.

Tolerances and their reasons:
* routing helpers (tile masks, mask caps, tile cluster ranges, row order):
  exact — integer arithmetic on the same inputs.
* the same cache searched by both packages: ids equal except inside runs of
  scores equal to 1e-5 relative; scores within 1e-5 of the largest |score|
  (f32 sums in another order; an L2 score is a difference of larger
  terms); the masked-in tile count equal.
* the port's own build from JAX's coarse pass and quantizer: words byte
  for byte, factors within 1e-5 of the largest magnitude (f32 norms and
  products in another order).
* partial probe against a brute force over the masked-in rows'
  reconstructions: scores to 1e-3 (the packed score's algebra against a
  direct distance), ids equal except at score ties (the JAX test's bar,
  ``tests/test_ivf_packed.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core.config import IVFConfig, KMeansConfig, Metric, RaBitQConfig, SAQConfig
from vq_tpu.index import ivf_packed as jivf
from vq_tpu.index.ivf import chunked_assign as jax_chunked_assign
from vq_tpu.kernels.kmeans import kmeans as jax_kmeans
from vq_tpu.core.config import RankAwareConfig
from vq_tpu.methods.rabitq import RaBitQ as JaxRaBitQ
from vq_tpu.methods.rankaware import RankAware as JaxRankAware
from vq_tpu.methods.saq import SAQ as JaxSAQ
from vq_tpu_torch import Metric as TMetric
from vq_tpu_torch import convert
from vq_tpu_torch.index import ivf_packed as tivf
from vq_tpu_torch.kernels.adc import _finalize
from vq_tpu_torch.kernels import packed_scan as tps
from vq_tpu_torch.kernels.packed_scan import TILE
from vq_tpu_torch.methods import saq as tsaq
from vq_tpu_torch.methods.saq import SAQ

from test_torch_flat_index import assert_close_scores, assert_same_ranking

torch.set_num_threads(1)

N, D, K, NQ = 6000, 32, 16, 12  # 12 tiles, the last one partial
SAQ_CFG = SAQConfig(bits_per_dim=2.0)
RABITQ_CFG = RaBitQConfig(num_bits=2)


@pytest.fixture(scope="module")
def data():
    """16 Gaussian blobs of falling spread, queries near corpus rows."""
    rng = np.random.default_rng(40)
    centers = 3.0 * rng.standard_normal((K, D)) * np.linspace(1.5, 0.3, D)
    x = centers[rng.integers(0, K, N)] + rng.standard_normal((N, D)) * np.linspace(1.0, 0.2, D)
    x = x.astype(np.float32)
    q = (x[rng.integers(0, N, NQ)] + 0.1 * rng.standard_normal((NQ, D))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def coarse(data):
    """The JAX package's coarse pass (its k-means and streamed assignment),
    shared by both packages' fits."""
    x, _ = data
    cent = jax_kmeans(jax.random.PRNGKey(0), jnp.asarray(x), K, KMeansConfig(iters=8))
    return np.array(cent), jax_chunked_assign(x, cent, 4096)  # writable, for torch


def _jax_index(data, coarse, quantizer):
    x, _ = data
    j = jivf.IvfPackedFlatIndex(quantizer.fit(x), IVFConfig(K, 1, KMeansConfig(iters=8)))
    return j.fit(x, coarse=(jnp.asarray(coarse[0]), coarse[1]))


def _carry(j):
    """The JAX index's state, through numpy, into a port index on the CPU."""
    params = jax.tree_util.tree_map(np.asarray, j.quantizer.params)
    cfg = convert.config_from_jax(j.quantizer.cfg)
    if isinstance(j.quantizer, JaxSAQ):
        tq = convert.saq_from_numpy(j.quantizer.plan, params, cfg, device="cpu")
    elif isinstance(j.quantizer, JaxRankAware):
        tq = convert.rankaware_from_numpy(params, j.quantizer.bits, j.quantizer.layout, cfg,
                                          device="cpu")
    else:
        tq = convert.rabitq_from_numpy(params, cfg, device="cpu")
    c = j.cache
    return convert.ivf_packed_index_from_numpy(
        tq, np.asarray(j.centroids), np.asarray(j.ids_sorted), np.asarray(j.cl_first),
        np.asarray(j.cl_last), [np.asarray(w) for w in c.words], np.asarray(c.factors),
        j.num_rows, np.asarray(c.tile_stats), has_norms=c.has_norms,
        prune_hint=c.prune_hint, ivf_cfg=j.ivf_cfg, search_cfg=j.search_cfg)


@pytest.fixture(scope="module")
def saq_pair(data, coarse):
    j = _jax_index(data, coarse, JaxSAQ(SAQ_CFG))
    return j, _carry(j)


def _set(index, port, nprobe, metric):
    """Both packages read nprobe and the metric at search time."""
    index.ivf_cfg = dataclasses.replace(index.ivf_cfg, nprobe=nprobe)
    index.search_cfg = dataclasses.replace(index.search_cfg, metric=metric)
    if not port:
        index._search_fn = None  # the JAX index caches a jitted search per config


# ------------------------------------------------------------ routing helpers
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_mask_from_probes_equals_jax(seed):
    """Random cluster-sorted tile ranges and probes, the first and the last
    cluster always among them."""
    rng = np.random.default_rng(seed)
    k_cl, nb = 37, 29
    asn = np.sort(rng.integers(0, k_cl, nb * TILE - 100))
    starts = np.arange(nb) * TILE
    first = asn[starts].astype(np.int32)
    last = asn[np.minimum(starts + TILE, len(asn)) - 1].astype(np.int32)
    probes = rng.integers(0, k_cl, (5, 3)).astype(np.int32)
    probes[0, 0], probes[-1, -1] = 0, k_cl - 1
    for p in (probes, probes[:1, :1], np.array([[k_cl - 1]], np.int32)):
        want = np.asarray(jivf.tile_mask_from_probes(jnp.asarray(p), jnp.asarray(first),
                                                     jnp.asarray(last), k_cl))
        got = tivf.tile_mask_from_probes(torch.from_numpy(p), torch.from_numpy(first),
                                         torch.from_numpy(last), k_cl)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_default_mask_cap_equals_jax():
    for nb in (1, 12, 196, 2048):
        for nprobe in (1, 3, 50, 200, 4096):
            for num_rows in (nb * TILE - 7, nb * TILE):
                for k_cl in (1, 16, 4096):
                    assert (tivf.default_mask_cap(nb, nprobe, num_rows, k_cl) ==
                            jivf.default_mask_cap(nb, nprobe, num_rows, k_cl))


# ------------------------------------------------- the same cache, both sides
@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP, Metric.NIP])
def test_same_cache_searches_like_jax(saq_pair, data, metric):
    """SAQ bpd=2: nprobe 1, 3 and 16 (= K, every tile) at k=10."""
    j, t = saq_pair
    _, q = data
    masked = {}
    for nprobe in (1, 3, K):
        _set(j, False, nprobe, metric)
        _set(t, True, nprobe, TMetric(metric))
        wi, ws = j.search_with_scores(q, 10)
        gi, gs = t.search_with_scores(q, 10)
        assert gi.dtype == np.uint32 and gi.shape == (NQ, 10)
        assert_same_ranking(gi, wi, ws)
        assert_close_scores(gs, ws)
        assert t.last_tiles_scanned == j.last_tiles_scanned
        assert t.last_tiles_masked_in == t.last_tiles_scanned
        masked[nprobe] = t.last_tiles_scanned
    assert masked[1] < masked[K] == -(-N // TILE), masked


def test_same_cache_rabitq_searches_like_jax(data, coarse):
    j = _jax_index(data, coarse, JaxRaBitQ(RABITQ_CFG))
    t = _carry(j)
    q = data[1][:3]  # few queries, one probe each: a partial mask
    _set(j, False, 1, Metric.L2)
    _set(t, True, 1, TMetric.L2)
    wi, ws = j.search_with_scores(q, 10)
    gi, gs = t.search_with_scores(q, 10)
    assert_same_ranking(gi, wi, ws)
    assert_close_scores(gs, ws)
    assert t.last_tiles_scanned == j.last_tiles_scanned < -(-N // TILE)


@pytest.mark.parametrize("packing", ["dense", "ffd"])
def test_same_cache_rankaware_searches_like_jax(data, coarse, packing):
    """RankAware (no per-row scale, one segment per bit width): a partial
    mask at nprobe=1, L2, k=10; the port's own build from JAX's coarse pass
    and quantizer gives JAX's words byte for byte."""
    j = _jax_index(data, coarse, JaxRankAware(RankAwareConfig(bits_per_dim=2.0,
                                                              packing=packing)))
    t = _carry(j)
    q = data[1][:3]
    _set(j, False, 1, Metric.L2)
    _set(t, True, 1, TMetric.L2)
    wi, ws = j.search_with_scores(q, 10)
    gi, gs = t.search_with_scores(q, 10)
    assert_same_ranking(gi, wi, ws)
    assert_close_scores(gs, ws)
    assert t.last_tiles_scanned == j.last_tiles_scanned < -(-N // TILE)
    assert t.memory_footprint() == j.memory_footprint()
    own = tivf.IvfPackedFlatIndex(t.quantizer, convert.config_from_jax(j.ivf_cfg))
    own.fit(data[0], coarse=coarse)
    np.testing.assert_array_equal(own.ids_sorted.numpy(), np.asarray(j.ids_sorted))
    for a, b in zip(own.cache.words, j.cache.words):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_carried_index_memory_footprint_equals_jax(saq_pair):
    j, t = saq_pair
    assert t.memory_footprint() == j.memory_footprint()


# ----------------------------------------------------- the port's own build
def test_port_builds_the_jax_cache(saq_pair, data, coarse):
    """fit(coarse=…) with JAX's quantizer parameters carried across: the
    same row order and tile cluster ranges; words byte for byte and factors
    to 1e-5 on every row the two encoders code alike.  The rows they code
    differently (CAQ rounding near-ties, test_torch_saq.py) are at most 1%,
    and no other row's word bits differ."""
    j, carried = saq_pair
    x, _ = data
    t = tivf.IvfPackedFlatIndex(carried.quantizer, convert.config_from_jax(j.ivf_cfg))
    t.fit(x, coarse=coarse)
    for name in ("ids_sorted", "cl_first", "cl_last"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    assert t.cache.perm is None and t.cache.num_rows == N
    assert t.cache.has_norms and t.cache.prune_hint == j.cache.prune_hint
    xs = x[np.asarray(j.ids_sorted)]  # rows in cluster order
    nbytes = j.quantizer.plan.code_bytes - 8 * j.quantizer.plan.num_segments
    jc = np.asarray(j.quantizer.compress(xs))[:, :nbytes]
    tc = t.quantizer.compress(torch.from_numpy(xs)).numpy()[:, :nbytes]
    same = (jc == tc).all(axis=1)
    assert same.mean() >= 0.99, same.mean()
    segs, _ = tsaq.packed_segspecs(t.quantizer.plan, t.quantizer.params)
    n_pad = t.cache.factors.shape[1]
    ok = np.concatenate([same, np.ones(n_pad - N, bool)])
    for a, b, seg in zip(t.cache.words, j.cache.words, segs):
        b = torch.from_numpy(np.array(b))
        assert a.dtype == b.dtype and a.shape == b.shape
        if seg.dequant == "values":
            rows_equal = (a == b).all(dim=1).numpy()
        else:
            rows_equal = (tps.unpack_words(a, seg) == tps.unpack_words(b, seg)).all(1).numpy()
        assert rows_equal[ok].all()
        if same.all():
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = np.asarray(j.cache.factors).T[:, ok]
    np.testing.assert_allclose(t.cache.factors.numpy()[:, ok], want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ------------------------------------------------------------ index behaviour
@pytest.fixture(scope="module")
def port_index(data):
    """The port's own fit (its own k-means) on a CPU tensor corpus."""
    x, _ = data
    return tivf.IvfPackedFlatIndex(SAQ(convert.config_from_jax(SAQ_CFG)),
                                   convert.config_from_jax(IVFConfig(K, 1))
                                   ).fit(torch.from_numpy(x))


def test_own_fit_orders_rows_by_cluster(port_index):
    t = port_index
    assert t.device == torch.device("cpu") and t.centroids.shape == (K, D)
    assert sorted(t.ids_sorted.tolist()) == list(range(N))
    first, last = t.cl_first.numpy(), t.cl_last.numpy()
    assert first.shape == (-(-N // TILE),) and (first <= last).all()
    assert (np.diff(first) >= 0).all() and (first[1:] >= last[:-1]).all()


def test_full_probe_equals_the_unmasked_scan(port_index, data):
    """nprobe = K masks every tile in: the result is the unmasked scan of
    the same cache, bit for bit."""
    t = port_index
    q = torch.from_numpy(data[1])
    _set(t, True, K, TMetric.L2)
    gi, gs = t.search_with_scores(q, 10)
    assert t.last_tiles_scanned == -(-N // TILE)
    s, pos = t.quantizer.packed_scan_raw(q, t.cache, 10, t.search_cfg.metric, use_bf16=False)
    ws, wi = _finalize(s, t.ids_sorted[pos.long()], t.search_cfg.metric, torch.sum(q * q, 1))
    np.testing.assert_array_equal(gi, wi.numpy())
    np.testing.assert_array_equal(gs, ws.numpy())


def test_partial_probe_matches_masked_bruteforce(port_index, data):
    """nprobe = 1: the exact top-k over the reconstructions of exactly the
    rows of the tiles that overlap a probed cluster of the batch."""
    t = port_index
    x, qn = data
    q = qn[:3]
    _set(t, True, 1, TMetric.L2)
    gi, gs = t.search_with_scores(q, 5)
    nb = -(-N // TILE)
    assert 0 < t.last_tiles_scanned < nb
    cent = t.centroids.numpy()
    probe = np.argsort(((q[:, None, :] - cent[None]) ** 2).sum(-1), axis=1)[:, :1]
    probed = np.zeros(K, bool)
    probed[probe.reshape(-1)] = True
    tile_in = [probed[lo:hi + 1].any() for lo, hi in zip(t.cl_first.numpy(),
                                                          t.cl_last.numpy())]
    assert sum(tile_in) == t.last_tiles_scanned
    order = t.ids_sorted.numpy()
    cand = np.concatenate([order[i * TILE:(i + 1) * TILE] for i in np.flatnonzero(tile_in)])
    rec = t.quantizer.decompress(t.quantizer.compress(torch.from_numpy(x))).numpy()
    dist = ((q[:, None, :] - rec[None, cand, :]) ** 2).sum(-1)
    ref_scores = np.sort(dist, axis=1)[:, :5]
    np.testing.assert_allclose(gs, ref_scores, rtol=1e-3, atol=1e-3)
    ref_ids = cand[np.argsort(dist, axis=1, kind="stable")[:, :5]]
    tied = np.isclose(gs, ref_scores, rtol=1e-4)
    assert np.all((gi == ref_ids) | tied)


def test_save_load_roundtrip(port_index, data, tmp_path):
    t = port_index
    q = data[1]
    _set(t, True, 3, TMetric.IP)
    ids, sc = t.search_with_scores(q, 5)
    path = str(tmp_path / "ivfpk.pkl")
    t.save(path)
    back = tivf.IvfPackedFlatIndex(SAQ(convert.config_from_jax(SAQ_CFG), device="cpu")).load(path)
    assert back.cache.perm is None and back.ivf_cfg == t.ivf_cfg
    ids2, sc2 = back.search_with_scores(q, 5)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_array_equal(sc, sc2)
    assert back.last_tiles_scanned == t.last_tiles_scanned > 0
    assert back.memory_footprint() == t.memory_footprint()


def test_sustained_search_and_mse(port_index, data):
    t = port_index
    x, q = data
    assert 0 < t.sustained_search_s(q, 5, reps=2, outer=2) < 60
    assert 0 < t.reconstruction_mse(x, 1000) == t.quantizer.reconstruction_mse(x, 1000)


# ------------------------------------------------- probe-coherent query groups
@pytest.mark.parametrize("groups,nq", [(2, 12), (4, 12), (4, 10), (4, 3)])
def test_query_groups_search_like_jax(saq_pair, data, groups, nq):
    """G groups on the same cache: a batch G divides, one it does not
    (padded by repeating its last query), one smaller than G (G becomes the
    batch size).  Ids, scores and the tiles summed over the groups are
    JAX's."""
    j, t = saq_pair
    q = data[1][:nq]
    _set(j, False, 1, Metric.L2)
    _set(t, True, 1, TMetric.L2)
    wi, ws = j.search_with_scores(q, 10, query_groups=groups)
    gi, gs = t.search_with_scores(q, 10, query_groups=groups)
    assert gi.dtype == np.uint32 and gi.shape == (nq, 10) and gs.shape == (nq, 10)
    assert_same_ranking(gi, wi, ws)
    assert_close_scores(gs, ws)
    assert t.last_tiles_scanned == j.last_tiles_scanned


def test_each_query_group_is_a_search_of_its_queries_alone(saq_pair, data):
    """The port's G=4 search of 10 queries (2 pad rows repeat the last):
    each query's result is, bit for bit, that of a G=1 search of its
    group's queries, the groups cut from the stable sort by nearest cell;
    the tiles are the sum of those searches'.  G=1 is the default search
    bit for bit."""
    _, t = saq_pair
    _set(t, True, 2, TMetric.IP)
    q = torch.from_numpy(data[1][:10])
    gi, gs = t.search_with_scores(q, 7, query_groups=4)
    tiles = t.last_tiles_scanned
    qp = torch.cat([q, q[-1:].expand(2, -1)])
    near = torch.argmin(torch.cdist(qp, t.centroids), dim=1)
    order = torch.argsort(near, stable=True)
    want_tiles = 0
    for g in order.reshape(4, 3):
        wi, ws = t.search_with_scores(qp[g], 7)
        want_tiles += t.last_tiles_scanned
        for row, i in enumerate(g.tolist()):
            if i < 10:
                np.testing.assert_array_equal(gi[i], wi[row])
                np.testing.assert_array_equal(gs[i], ws[row])
    assert tiles == want_tiles
    one = t.search_with_scores(q, 7, query_groups=1)
    default = t.search_with_scores(q, 7)
    np.testing.assert_array_equal(one[0], default[0])
    np.testing.assert_array_equal(one[1], default[1])


def test_query_groups_default_save_load_and_sustained(port_index, data, tmp_path):
    """An index built with query_groups=3 searches in 3 groups by default,
    keeps it through save/load and times its grouped search."""
    x, q = data
    t = tivf.IvfPackedFlatIndex(port_index.quantizer, port_index.ivf_cfg, query_groups=3)
    t.fit(torch.from_numpy(x), coarse=(port_index.centroids, torch.argmin(
        torch.cdist(torch.from_numpy(x), port_index.centroids), dim=1)))
    _set(t, True, 1, TMetric.L2)
    ids, sc = t.search_with_scores(q, 5)
    tiles = t.last_tiles_scanned
    want = t.search_with_scores(q, 5, query_groups=3)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(sc, want[1])
    path = str(tmp_path / "ivfpk_g3.pkl")
    t.save(path)
    back = tivf.IvfPackedFlatIndex(SAQ(convert.config_from_jax(SAQ_CFG), device="cpu")).load(path)
    assert back.query_groups == 3
    ids2, sc2 = back.search_with_scores(q, 5)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_array_equal(sc, sc2)
    assert back.last_tiles_scanned == tiles > 0
    assert 0 < back.sustained_search_s(q, 5, reps=2, outer=1) < 60


def test_approx_is_accepted_and_ignored_like_jax(saq_pair, data):
    """SearchConfig(approx=True), which the JAX package's probed-tile index
    ignores: JAX's result, and the port's exact one bit for bit."""
    j, t = saq_pair
    q = data[1]
    _set(j, False, 3, Metric.L2)
    _set(t, True, 3, TMetric.L2)
    exact = t.search_with_scores(q, 10)
    for index in (j, t):
        index.search_cfg = dataclasses.replace(index.search_cfg, approx=True)
    j._search_fn = None
    wi, ws = j.search_with_scores(q, 10)
    gi, gs = t.search_with_scores(q, 10)
    for index in (j, t):  # the fixture is shared
        index.search_cfg = dataclasses.replace(index.search_cfg, approx=False)
    j._search_fn = None
    np.testing.assert_array_equal(gi, exact[0])
    np.testing.assert_array_equal(gs, exact[1])
    assert_same_ranking(gi, wi, ws)
    assert_close_scores(gs, ws)
