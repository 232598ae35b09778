"""The port's SAQ (methods/saq.py) against the JAX package's, with the JAX
package's fitted plan and params converted through numpy.

Tolerances and their reasons:
* code rows: index bytes equal on ≥ 99% of rows (CAQ rounds may take
  another path at a rounding-level near-tie, see test_torch_caq.py); the
  f32 factors of rows with equal index bytes within 2e-6 relative.
* decode, packed factors and tile stats: f32 matmuls and sums in another
  order, 1e-5 of the largest magnitude.
* search ids equal, except inside runs of scores equal to 1e-5 relative;
  scores within 1e-5 of the largest |score| (an L2 distance is a
  difference of terms that can be far larger than it).
* the port's own fit (PCA signs and sample differ): the same segment bits
  and reconstruction MSE within 2% of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core.config import Metric, SAQConfig
from vq_tpu.methods import saq as jsaq
from vq_tpu_torch import convert
from vq_tpu_torch.methods import saq as tsaq

from test_torch_flat_index import assert_close_scores, assert_same_ranking

torch.set_num_threads(1)

N, D = 1300, 96  # ragged: 1300 rows pad to 1536
CFGS = {"uniform": SAQConfig(bits_per_dim=2.0, block_dims=32),
        "lloyd": SAQConfig(bits_per_dim=3.0, block_dims=32, codebook="lloyd")}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((N, D)) * np.linspace(2.0, 0.3, D)).astype(np.float32)
    x *= np.exp(0.5 * rng.standard_normal((N, 1))).astype(np.float32)
    q = x[rng.integers(0, N, 7)] + 0.1 * rng.standard_normal((7, D)).astype(np.float32)
    return x, q, np.linalg.norm(x, axis=1)


@pytest.fixture(scope="module", params=list(CFGS))
def pair(request, data):
    x = data[0]
    cfg = CFGS[request.param]
    j = jsaq.SAQ(cfg).fit(x)
    t = convert.saq_from_numpy(j.plan, jax.tree_util.tree_map(np.asarray, j.params),
                               convert.config_from_jax(cfg), device="cpu")
    return request.param, j, t, np.array(j.compress(x))  # writable, for torch


def test_encode_decode_match_jax(pair, data):
    _, j, t, jc = pair
    x = data[0]
    tc = t.compress(x).numpy()
    nb = jc.shape[1] - 8 * j.plan.num_segments
    same = (tc[:, :nb] == jc[:, :nb]).all(axis=1)
    assert same.mean() >= 0.99, same.mean()
    jf, tf = jc[same, nb:].copy().view(np.float32), tc[same, nb:].copy().view(np.float32)
    np.testing.assert_allclose(tf, jf, rtol=2e-6)
    want = np.asarray(j.decompress(jc))
    np.testing.assert_allclose(t.decompress(jc).numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("sort_rows", [True, False])
def test_prepare_packed_matches_jax(pair, data, sort_rows):
    _, j, t, jc = pair
    norms = data[2]
    jp = jsaq.prepare_packed(j.plan, j.params, jnp.asarray(jc), norms=jnp.asarray(norms),
                             sort_rows=sort_rows)
    tp = tsaq.prepare_packed(t.plan, t.params, torch.from_numpy(jc),
                             norms=torch.from_numpy(norms), sort_rows=sort_rows)
    assert tp.num_rows == jp.num_rows and tp.has_norms and tp.prune_hint == jp.prune_hint
    for a, b in zip(jp.words, tp.words):  # int32 words, or f32 value planes of level values
        a = np.asarray(a)
        assert b.dtype == (torch.float32 if a.dtype == np.float32 else torch.int32)
        np.testing.assert_array_equal(b.numpy(), a)
    want = np.asarray(jp.factors).T
    assert tp.factors.shape == want.shape and tp.factors.is_contiguous()
    np.testing.assert_allclose(tp.factors.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(tp.tile_stats.numpy(), np.asarray(jp.tile_stats), rtol=1e-5,
                               atol=1e-6)
    if sort_rows:
        np.testing.assert_array_equal(tp.perm.numpy(), np.asarray(jp.perm))
    else:
        assert tp.perm is None and jp.perm is None


def test_packed_scan_matches_pallas(pair, data):
    """The packed route (the port's plain twin vs the Pallas kernel in
    interpret mode) over norm-ordered caches, ids mapped through perm."""
    name, j, t, jc = pair
    _, q, norms = data
    jp = jsaq.prepare_packed(j.plan, j.params, jnp.asarray(jc), norms=jnp.asarray(norms),
                             sort_rows=True)
    tp = tsaq.prepare_packed(t.plan, t.params, torch.from_numpy(jc),
                             norms=torch.from_numpy(norms), sort_rows=True)
    metrics = (Metric.L2, Metric.IP, Metric.NIP) if name == "uniform" else (Metric.L2,)
    for metric in metrics:
        ws, wi = jsaq.scan_topk(j.plan, j.params, jnp.asarray(q), jnp.asarray(jc), 10, metric,
                                packed_cache=jp, use_packed=True, interpret=True)
        gs, gi = t.scan_topk(torch.from_numpy(q), torch.from_numpy(jc), 10, metric, cache=tp)
        assert gi.dtype == torch.int32
        assert_same_ranking(gi.numpy(), np.asarray(wi), np.asarray(ws))
        assert_close_scores(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP, Metric.NIP])
def test_streaming_scan_matches_jax(pair, data, metric):
    """use_packed=False: the plain streaming route on both sides, k ≤ n."""
    _, j, t, jc = pair
    _, q, norms = data
    for k in (10, 130):
        ws, wi = jsaq.scan_topk(j.plan, j.params, jnp.asarray(q), jnp.asarray(jc), k, metric,
                                norms=jnp.asarray(norms), use_packed=False, tile_rows=512)
        gs, gi = tsaq.scan_topk(t.plan, t.params, torch.from_numpy(q), torch.from_numpy(jc), k,
                                metric, norms=torch.from_numpy(norms), use_packed=False,
                                tile_rows=512)
        assert_same_ranking(gi.numpy(), np.asarray(wi), np.asarray(ws))
        assert_close_scores(gs.numpy(), np.asarray(ws))


def test_port_fit_quality_matches_jax(pair, data):
    name, j, _, _ = pair
    x = data[0]
    t = tsaq.SAQ(convert.config_from_jax(CFGS[name])).fit(torch.from_numpy(x))
    assert t.device == torch.device("cpu")  # a CPU tensor corpus: the CPU
    assert t.plan.seg_bits == j.plan.seg_bits and t.plan.seg_lens == j.plan.seg_lens
    mse_t = t.reconstruction_mse(x)
    mse_j = float(np.mean((np.asarray(j.decompress(j.compress(x))) - x) ** 2))
    assert mse_t <= 1.02 * mse_j, (mse_t, mse_j)


def test_save_load_roundtrip(pair, data, tmp_path):
    _, _, t, jc = pair
    path = str(tmp_path / "saq.pkl")
    t.save(path)
    back = tsaq.SAQ(t.cfg, device="cpu").load(path)
    assert back.plan == t.plan and back.code_bytes_per_vector() == t.code_bytes_per_vector()
    assert len(back.params.seg_rots) == t.plan.num_segments
    np.testing.assert_array_equal(back.decompress(jc).numpy(), t.decompress(jc).numpy())


def test_refusals(pair, data):
    _, _, t, jc = pair
    q = torch.from_numpy(data[1])
    cache = t.prepare_scan(torch.from_numpy(jc))  # built without norms
    with pytest.raises(ValueError, match="norms"):
        t.scan_topk(q, torch.from_numpy(jc), 10, Metric.NIP, cache=cache)
    with pytest.raises(ValueError, match="num_valid"):
        t.scan_topk(q, torch.from_numpy(jc), 10, Metric.L2, cache=cache, num_valid=100)
