"""The port's sharded residual IVF index (``vq_tpu_torch/dist/sharded_ivf.py``:
``balance_clusters``, ``ShardedIVFIndex``) and the ``probe_mask`` of both list
scans (``index/ivf.py``) against the JAX package's on the CPU.

The JAX index is fitted on its 8 virtual devices (its list scans are XLA,
no Pallas kernel) and carried into the port through numpy
(``convert.sharded_ivf_index_from_numpy``: the same per-shard blocks,
routing tables and centroids on ``make_mesh(devices=["cpu"] * 8)``).  The
port's own fits are held to its single-device ``IvfQuantizedIndex``.

Tolerances and their reasons: ids equal where separated and scores within
1e-4·(‖q‖² + 2·max‖x̂‖²) (``test_torch_dist_sharded.assert_where_separated``;
f32 sums in another order); routing tables, block layouts and footprints
exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core.config import IVFConfig, KMeansConfig, Metric, SAQConfig, SearchConfig, SQConfig
from vq_tpu.dist.mesh import make_mesh as jax_make_mesh
from vq_tpu.dist.sharded_ivf import ShardedIVFIndex as JaxShardedIVF
from vq_tpu.dist.sharded_ivf import balance_clusters as jax_balance
from vq_tpu.index import ivf as jivf
from vq_tpu.methods.saq import SAQ as JaxSAQ
from vq_tpu.methods.sq import SQ as JaxSQ
from vq_tpu_torch import convert
from vq_tpu_torch.dist.sharded_ivf import ShardedIVFIndex, balance_clusters
from vq_tpu_torch.index import ivf as tivf
from vq_tpu_torch.methods.sq import SQ

from test_torch_dist_sharded import assert_where_separated, cpu_mesh, score_tol

torch.set_num_threads(1)

N, D, K, NQ = 3000, 32, 16, 12


def _ivf_cfg(nprobe=4):
    return IVFConfig(num_clusters=K, nprobe=nprobe, kmeans=KMeansConfig(iters=8, seed=0))


@pytest.fixture(scope="module")
def data():
    """16 Gaussian blobs of unequal sizes (one holds a quarter of the rows);
    queries near corpus rows."""
    rng = np.random.default_rng(70)
    centers = 3.0 * rng.standard_normal((K, D)) * np.linspace(1.5, 0.3, D)
    p = np.full(K, 0.75 / (K - 1))
    p[3] = 0.25
    x = centers[rng.choice(K, N, p=p)] + rng.standard_normal((N, D)) * np.linspace(1.0, 0.2, D)
    x = x.astype(np.float32)
    q = (x[rng.integers(0, N, NQ)] + 0.1 * rng.standard_normal((NQ, D))).astype(np.float32)
    return x, q


def _port_quantizer(jq):
    params = jax.tree_util.tree_map(np.asarray, jq.params)
    cfg = convert.config_from_jax(jq.cfg)
    if isinstance(jq, JaxSAQ):
        return convert.saq_from_numpy(jq.plan, params, cfg, device="cpu")
    return convert.sq_from_numpy(params, D, cfg, device="cpu")


def _carry(j, mesh):
    return convert.sharded_ivf_index_from_numpy(
        _port_quantizer(j.quantizer), mesh, np.asarray(j.centroids), np.asarray(j.codes_sh),
        np.asarray(j.ids_sh), np.asarray(j.norms_sh), np.asarray(j.shard_of),
        np.asarray(j.local_off), np.asarray(j.sizes), j.num_rows, j.ivf_cfg, j.search_cfg)


def _single(t, x):
    """The port's single-device index over the sharded index's quantizer,
    centroids and assignment."""
    cents = t.centroids
    asn = tivf.chunked_assign(x, cents, 4096)
    return tivf.IvfQuantizedIndex(t.quantizer, t.ivf_cfg, t.search_cfg).fit(x, coarse=(cents, asn))


def _tol(single, q, x, metric):
    x_hat = single.decompress(np.arange(N)).numpy()
    if metric == Metric.NIP:
        x_hat = x_hat / np.linalg.norm(x, axis=1, keepdims=True)
    return score_tol(q, x_hat)


# ------------------------------------------------------------------ balance
def test_balance_clusters_matches_jax():
    rng = np.random.default_rng(3)
    for sizes, p in ((np.array([100, 90, 10, 10, 10, 10, 10, 10]), 2),
                     (rng.integers(0, 500, 37), 5), (np.zeros(6, np.int64), 4)):
        got = balance_clusters(sizes, p)
        np.testing.assert_array_equal(got, jax_balance(sizes, p))
        assert got.dtype == np.int32
    sh = balance_clusters(np.array([100, 90, 10, 10, 10, 10, 10, 10]), 2)
    assert sh[0] != sh[1]  # the two big lists land on different shards


# --------------------------------------------------------------- vs the JAX
@pytest.mark.parametrize("name,metric", [("sq", Metric.L2), ("sq", Metric.NIP),
                                         ("saq", Metric.L2), ("saq", Metric.IP)])
def test_converted_index_searches_like_jax(data, name, metric):
    """nprobe=4, k=10: the JAX index's lists on the port's mesh; both
    strategies against JAX's and against each other, and against the
    single-device index on the same centroids and assignment."""
    x, q = data
    jq = JaxSQ(SQConfig(num_bits=8)) if name == "sq" else JaxSAQ(
        SAQConfig(bits_per_dim=2.0, block_dims=16))
    j = JaxShardedIVF(jq, _ivf_cfg(), SearchConfig(metric=metric), mesh=jax_make_mesh()).fit(x)
    t = _carry(j, cpu_mesh())
    assert t.num_shards == 8 and t.memory_footprint() == j.memory_footprint()
    single = _single(t, x)
    tol = _tol(single, q, x, metric)
    got = {}
    for strategy in ("union", "windows"):
        wi, ws = j.search_with_scores(q, 10, strategy=strategy)
        gi, gs = t.search_with_scores(q, 10, strategy=strategy)
        assert gi.dtype == np.uint32 and gi.shape == (NQ, 10) and int(gi.max()) < N
        assert_where_separated(gi, gs, wi, ws, tol)
        got[strategy] = (gi, gs)
    assert_where_separated(*got["windows"], *got["union"], tol)
    fi, fs = single.search_with_scores(q, 10)
    assert_where_separated(*got["union"], fi, fs, tol)


def test_converted_layout_is_jax_s(data):
    """Each shard holds its own lists at the JAX index's local offsets, ids
    −1 in the pad; the routing tables come through unchanged."""
    x, _ = data
    j = JaxShardedIVF(JaxSQ(SQConfig(num_bits=8)), _ivf_cfg(), mesh=jax_make_mesh()).fit(x)
    t = _carry(j, cpu_mesh())
    np.testing.assert_array_equal(t.shard_of.numpy(), np.asarray(j.shard_of))
    np.testing.assert_array_equal(torch.stack(t.ids_sh).numpy(), np.asarray(j.ids_sh))
    shard_of, off, sizes = (np.asarray(a) for a in (j.shard_of, j.local_off, j.sizes))
    for c in range(K):
        ids = t.ids_sh[shard_of[c]][off[c]:off[c] + sizes[c]].numpy()
        assert (ids >= 0).all() and len(set(ids.tolist())) == sizes[c]
    assert sorted(torch.cat(t.ids_sh)[torch.cat(t.ids_sh) >= 0].tolist()) == list(range(N))


# -------------------------------------------------------------- own builds
def test_own_fit_equals_the_single_device_index(data):
    """The port's own build (its coarse k-means, residual fit and encode in
    (shard, cluster) order) against IvfQuantizedIndex fitted from the same
    seed: the same centroids bit for bit, and the same results."""
    x, q = data
    cfg = convert.config_from_jax(_ivf_cfg())
    sh = ShardedIVFIndex(SQ(convert.config_from_jax(SQConfig(8)), device="cpu"), cfg,
                         mesh=cpu_mesh(3)).fit(x)
    ref = tivf.IvfQuantizedIndex(SQ(convert.config_from_jax(SQConfig(8)), device="cpu"),
                                 cfg).fit(x)
    assert torch.equal(sh.centroids, ref.centroids)
    assert torch.equal(sh.quantizer.params.lo, ref.quantizer.params.lo)
    tol = _tol(ref, q, x, Metric.L2)
    for strategy in ("union", "windows"):
        gi, gs = sh.search_with_scores(q, 10, strategy=strategy)
        wi, ws = ref.search_with_scores(q, 10, strategy=strategy)
        assert_where_separated(gi, gs, wi, ws, tol)


def test_skewed_lists_stay_whole_and_exact():
    """A 1,500-row blob and a wide spread: balancing keeps every list on one
    shard (the blob's lists fill whole shards), and the result equals the
    single-device index's at a full probe."""
    rng = np.random.default_rng(9)
    blob = rng.standard_normal((1500, 16)).astype(np.float32) * 0.05
    spread = rng.standard_normal((500, 16)).astype(np.float32) * 8.0 + 20.0
    x = np.concatenate([blob, spread])
    q = np.concatenate([blob[:6], spread[:6]]) + 0.01
    cfg = convert.config_from_jax(_ivf_cfg(nprobe=16))
    sq = SQ(convert.config_from_jax(SQConfig(8)), device="cpu")
    sh = ShardedIVFIndex(sq, cfg, mesh=cpu_mesh(4)).fit(x)
    sizes = sh.sizes.numpy()
    loads = np.bincount(sh.shard_of.numpy(), weights=sizes, minlength=4)
    assert loads.sum() == len(x) and max(sizes) > loads.min()  # skewed
    assert all(a.shape[0] == int(loads.max()) + tivf._PAD_SLACK for a in sh.codes_sh)
    ref = tivf.IvfQuantizedIndex(sq, cfg).fit(x, coarse=(sh.centroids, tivf.chunked_assign(
        x, sh.centroids, 4096)))
    gi, gs = sh.search_with_scores(q, 5)
    wi, ws = ref.search_with_scores(q, 5)
    assert_where_separated(gi, gs, wi, ws, _tol_of(ref, q, len(x)))


def _tol_of(index, q, n):
    return score_tol(q, index.decompress(np.arange(n)).numpy())


def test_one_shard_mesh_is_the_single_device_index(data):
    x, q = data
    cfg = convert.config_from_jax(_ivf_cfg())
    sq = SQ(convert.config_from_jax(SQConfig(8)), device="cpu")
    sh = ShardedIVFIndex(sq, cfg, mesh=cpu_mesh(1)).fit(x)
    ref = tivf.IvfQuantizedIndex(sq, cfg).fit(x)
    for strategy in ("union", "windows"):
        gi, gs = sh.search_with_scores(q, 10, strategy=strategy)
        wi, ws = ref.search_with_scores(q, 10, strategy=strategy)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=0)


def test_windows_chunk_above_the_padding_is_refused(data):
    x, q = data
    sh = ShardedIVFIndex(SQ(convert.config_from_jax(SQConfig(8)), device="cpu"),
                         convert.config_from_jax(_ivf_cfg()), mesh=cpu_mesh(2)).fit(x[:600])
    with pytest.raises(ValueError, match="chunk"):
        sh._search_device(q, 5, 4, chunk=4096, strategy="windows")


# -------------------------------------------------------------- probe_mask
@pytest.fixture(scope="module")
def lists(data):
    """A JAX single-device SQ index (its CSR lists) and its port copy."""
    x, _ = data
    j = jivf.IvfQuantizedIndex(JaxSQ(SQConfig(num_bits=8)), _ivf_cfg()).fit(x)
    t = convert.ivf_index_from_numpy(
        _port_quantizer(j.quantizer), np.asarray(j.centroids), np.asarray(j.codes_sorted),
        np.asarray(j.ids_sorted), np.asarray(j.norms_sorted), np.asarray(j.offsets),
        np.asarray(j.sizes), j._inv_perm, j._assignment, j.ivf_cfg, j.search_cfg)
    return j, t


@pytest.mark.parametrize("scan", ["probed", "union"])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP])
def test_probe_mask_matches_jax(data, lists, scan, metric):
    """A random (Q, nprobe) probe_mask in both list scans: the port's result
    equals JAX's; masks that split the probes in two give two results whose
    merge is the unmasked scan; an all-False mask leaves −inf with id 0."""
    j, t = lists
    x, q = data
    nprobe, k = 5, 10
    cd = tivf.pairwise_sqdist_xc(torch.from_numpy(q), t.centroids)
    probe = tivf.ordered_topk(-cd, nprobe)[1]
    mask = torch.from_numpy(np.random.default_rng(4).random((NQ, nprobe)) < 0.5)
    tm = convert.config_from_jax(SearchConfig(metric=metric)).metric
    t_args = (t.centroids, t.codes_sorted, t.ids_sorted, t.norms_sorted, t.offsets, t.sizes,
              t.quantizer.decode_fn(), k, tm)
    j_args = (j.centroids, j.codes_sorted, j.ids_sorted, j.norms_sorted, j.offsets, j.sizes,
              j.quantizer.decode_fn(), k, metric)

    def port(m):
        if scan == "union":
            return tivf.scan_union_lists(torch.from_numpy(q), probe, cd, *t_args, chunk=256,
                                         probe_mask=m)
        return tivf.scan_probed_lists(torch.from_numpy(q), probe, *t_args, chunk=256,
                                      probe_mask=m)

    jq, jp, jm = jnp.asarray(q), jnp.asarray(probe.numpy()), jnp.asarray(mask.numpy())
    if scan == "union":
        ws, wi = jivf.scan_union_lists(jq, jp, jnp.asarray(cd.numpy()), *j_args, chunk=256,
                                       probe_mask=jm)
    else:
        ws, wi = jivf.scan_probed_lists(jq, jp, *j_args, chunk=256, probe_mask=jm)
    gs, gi = port(mask)
    single = _single_of(t)
    tol = score_tol(q, single)
    assert_where_separated(gi.numpy(), gs.numpy(), np.asarray(wi), np.asarray(ws), tol)
    # every candidate is in an unmasked probe's list
    asn = t._assignment.numpy()
    for r in range(NQ):
        allowed = set(probe[r][mask[r]].tolist())
        assert all(asn[i] in allowed for i, s in zip(gi[r].tolist(), gs[r].tolist())
                   if s > -np.inf)
    # two complementary masks merge to the unmasked scan
    a, b = port(mask), port(~mask)
    both = tivf._fold(a[0], a[1], b[0], b[1], k)
    ws_all, wi_all = port(None)
    np.testing.assert_array_equal(both[1].numpy(), wi_all.numpy())
    np.testing.assert_array_equal(both[0].numpy(), ws_all.numpy())
    none_s, none_i = port(torch.zeros_like(mask))
    assert bool(torch.isneginf(none_s).all()) and bool((none_i == 0).all())


def _single_of(t):
    return t.decompress(np.arange(t.num_rows)).numpy()


def test_sharded_search_uses_every_shard(data):
    """The union of the shards' own lists is every list: a search whose
    probes span all shards returns candidates from more than one."""
    x, q = data
    sh = ShardedIVFIndex(SQ(convert.config_from_jax(SQConfig(8)), device="cpu"),
                         dataclasses.replace(convert.config_from_jax(_ivf_cfg()), nprobe=K),
                         mesh=cpu_mesh(4)).fit(x)
    ids, _ = sh.search_with_scores(q, 50)
    shard_of = sh.shard_of.numpy()
    asn = tivf.chunked_assign(x, sh.centroids, 4096).numpy()
    assert len(set(shard_of[asn[ids.reshape(-1)]].tolist())) > 1
