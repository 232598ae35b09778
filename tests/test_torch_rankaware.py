"""The port's methods/rankaware.py against vq_tpu/methods/rankaware.py on
the CPU, with the parameters the JAX package fitted converted through numpy.

Tolerances and their reasons:
* allocate_bits: exact (the same numpy on the same inputs).
* codes and the packed layout's words: byte for byte (the same rotation and
  levels; a level boundary hit to the last bit is the only way to differ,
  and this data has none).
* factors and tile stats: within 1e-5 of the largest magnitude (f32 sums
  in another order).
* decode and the residual scorer: within 1e-5 of the largest |value|.
* scan ids: equal except inside runs of scores equal to 1e-5 relative;
  scores within 1e-5 of the largest |score|.  The JAX package scans on the
  CPU with its plain streaming route (its packed kernel runs only on a
  TPU); one call of its Pallas kernel in interpret mode, at k=10, holds the
  packed layout itself.
* the port's own fit (its own Gaussian sample and PCA signs): MSE within 5%
  of the JAX package's own fit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core.config import Metric, RankAwareConfig, SearchConfig
from vq_tpu.methods import rankaware as jra
from vq_tpu_torch import convert
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.kernels import packed_scan as tps
from vq_tpu_torch.methods import packed as pr
from vq_tpu_torch.methods import rankaware as tra

from test_torch_flat_index import assert_close_scores, assert_same_ranking

torch.set_num_threads(1)

N, D, NQ = 3000, 48, 16


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(51)
    mix = np.linalg.qr(rng.standard_normal((D, D)))[0]
    x = ((rng.standard_normal((N, D)) * np.geomspace(10.0, 0.01, D)) @ mix + 0.3).astype(np.float32)
    q = (x[rng.integers(0, N, NQ)] + 0.1 * rng.standard_normal((NQ, D))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module", params=["dense", "ffd"])
def pair(request, data):
    x, _ = data
    cfg = RankAwareConfig(bits_per_dim=2.0, packing=request.param)
    j = jra.RankAware(cfg).fit(x)
    params = jax.tree_util.tree_map(np.asarray, j.params)
    t = convert.rankaware_from_numpy(params, j.bits, j.layout, convert.config_from_jax(cfg),
                                     device="cpu")
    return j, t


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("budget", [0, 17, 96, 400])
def test_allocate_bits_equals_jax(alpha, budget):
    rng = np.random.default_rng(int(alpha * 10) + budget)
    var = np.sort(rng.gamma(1.0, 1.0, 48))[::-1]
    dg = np.concatenate([[1.0], np.sort(rng.uniform(0, 1, 8))[::-1] ** 2])
    np.testing.assert_array_equal(tra.allocate_bits(var, dg, budget, alpha, 8),
                                  jra.allocate_bits(var, dg, budget, alpha, 8))


def test_codes_and_decode_equal_jax(data, pair):
    x, _ = data
    j, t = pair
    want = np.asarray(j.compress(x))
    got = t.compress(x)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    rec_j = np.asarray(j.decompress(want))
    np.testing.assert_allclose(t.decompress(want).numpy(), rec_j, rtol=0,
                               atol=1e-5 * np.abs(rec_j).max())
    assert t.code_bytes_per_vector() == j.code_bytes_per_vector()
    assert t.config_dict() == j.config_dict()


def test_prepare_packed_equals_jax(data, pair):
    """Words byte for byte (value planes equal), factors = JAX's transposed,
    the same segments (bits, lengths, kinds; no per-row scale)."""
    x, _ = data
    j, t = pair
    codes = np.array(j.compress(x))  # writable, for torch
    norms = np.linalg.norm(x, axis=1).astype(np.float32)
    jp = jra.prepare_packed(j.params, j.bits, j.layout, jnp.asarray(codes), j.cfg.packing,
                            norms=jnp.asarray(norms))
    tp = t.prepare_scan(torch.from_numpy(codes), norms=torch.from_numpy(norms))
    jsegs = jra._packed_segspecs(j.params, j.bits)[0]
    tsegs = tra.packed_segspecs(t.params, t.bits)[0]
    assert [tuple(s) for s in tsegs] == [tuple(s) for s in jsegs]
    assert all(s.scale_col == -1 for s in tsegs) and len(tsegs) >= 3
    assert {s.dequant for s in tsegs} == {"perdim", "values"}
    for a, b in zip(tp.words, jp.words):
        b = np.asarray(b)
        assert a.dtype == torch.from_numpy(b).dtype and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), b)
    want = np.asarray(jp.factors).T
    np.testing.assert_allclose(tp.factors.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    ws = np.asarray(jp.tile_stats)
    np.testing.assert_allclose(tp.tile_stats.numpy(), ws, rtol=0, atol=1e-5 * np.abs(ws).max())
    assert tp.has_norms and tp.prune_hint == jp.prune_hint and tp.perm is None


def test_packed_layout_against_jax_interpret_kernel(data, pair):
    """The JAX package's Pallas kernel in interpret mode on its own layout,
    the port's plain twin on the port's: one call, L2, k=10."""
    x, q = data
    j, t = pair
    codes = np.array(j.compress(x))  # writable, for torch
    jp = jra.prepare_packed(j.params, j.bits, j.layout, jnp.asarray(codes), j.cfg.packing)
    ws, wi = jra._packed_scan(j.params, j.bits, jnp.asarray(q), jp, 10, Metric.L2,
                              interpret=True, use_bf16=False)
    tp = t.prepare_scan(torch.from_numpy(codes))
    gs, gi = pr.packed_scan(t.packed_route(), torch.from_numpy(q), tp, 10, tra.Metric.L2,
                            use_bf16=False)
    assert_same_ranking(gi.numpy(), np.asarray(wi), np.asarray(ws))
    assert_close_scores(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP, Metric.NIP])
def test_scan_topk_matches_jax(data, pair, metric):
    """k=10 and 100 (packed route in the port at k ≤ 128), k=200 (the plain
    streaming scan on both sides)."""
    x, q = data
    j, t = pair
    codes = np.array(j.compress(x))
    norms = np.linalg.norm(x, axis=1).astype(np.float32)
    tm = tra.Metric(metric.value)
    for k in (10, 100, 200):
        ws, wi = j.scan_topk(jnp.asarray(q), jnp.asarray(codes), k, metric,
                             norms=jnp.asarray(norms))
        gs, gi = t.scan_topk(torch.from_numpy(q), torch.from_numpy(codes), k, tm,
                             norms=torch.from_numpy(norms))
        assert_same_ranking(gi.numpy(), np.asarray(wi), np.asarray(ws))
        assert_close_scores(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP])
def test_prune_and_plain_route_equal_dense(data, pair, metric):
    x, q = data
    _, t = pair
    codes = t.compress(x)
    cache = t.prepare_scan(codes)
    tm = tra.Metric(metric.value)
    dense = t.scan_topk(q, codes, 10, tm, cache=cache, prune_tiles=False)
    pruned = t.scan_topk(q, codes, 10, tm, cache=cache, prune_tiles=True)
    plain = t.scan_topk(q, codes, 10, tm, use_packed=False)
    assert torch.equal(pruned[1], dense[1]) and torch.equal(pruned[0], dense[0])
    assert_same_ranking(plain[1].numpy(), dense[1].numpy(), dense[0].numpy())
    assert_close_scores(plain[0].numpy(), dense[0].numpy())


def test_residual_scorer_equals_decode(data, pair):
    """v·decode = v_cat·ŷ + v_add and ‖decode‖² = r2, row for row."""
    x, q = data
    _, t = pair
    codes = t.compress(x[:500])
    q_map, window = t.residual_scorer()
    v = torch.from_numpy(q)
    v_cat, v_add = q_map(v)
    o, r2 = window(codes)
    dec = t.decode_fn()(codes)
    want = v @ dec.T
    got = v_cat @ o.T + v_add[:, None]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    wr2 = torch.sum(dec * dec, dim=1)
    np.testing.assert_allclose(r2.numpy(), wr2.numpy(), rtol=0,
                               atol=1e-5 * float(wr2.abs().max()))


@pytest.mark.parametrize("codebook", ["lloyd", "gaussian", "exact"])
def test_own_fit_quality_matches_jax(data, codebook):
    x, _ = data
    cfg = RankAwareConfig(bits_per_dim=2.0, codebook=codebook)
    t = tra.RankAware(convert.config_from_jax(cfg), device="cpu").fit(x)
    j = jra.RankAware(cfg).fit(x)
    assert int(t.bits.sum()) == int(j.bits.sum()) == 2 * D
    assert t.reconstruction_mse(x) <= 1.05 * j.reconstruction_mse(x)


def test_flat_index_and_save_load(data, pair, tmp_path):
    x, q = data
    j, t = pair
    idx = convert.flat_index_of(t, t.compress(x), np.linalg.norm(x, axis=1), N,
                                convert.config_from_jax(SearchConfig()))
    assert idx._scan_cache is not None
    ids = idx.search(q, 10)
    path = str(tmp_path / "ra.pkl")
    idx.save(path)
    back = FlatQuantizedIndex(tra.RankAware(t.cfg, device="cpu")).load(path)
    np.testing.assert_array_equal(back.quantizer.bits, t.bits)
    assert (back.quantizer.layout is None) == (t.layout is None)
    np.testing.assert_array_equal(back.search(q, 10), ids)
    assert idx.memory_footprint() == back.memory_footprint()
    assert tps.prune_units(NQ, idx._scan_cache.factors.shape[1], "cpu") == -(-N // 512)
