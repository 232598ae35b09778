"""The port's RaBitQ (methods/rabitq.py) against the JAX package's, with
the JAX package's fitted params converted through numpy, for B ∈ {1, 2, 6}
(the "shared" level table at B ≤ 4, the f32 value plane at B = 6).

Tolerances and their reasons:
* code rows: index bytes equal on ≥ 99% of rows (a coordinate on a level
  midpoint may round either way in sums taken in another order); ‖r‖ and
  t of equal rows within 2e-6 relative.
* decode, packed factors and tile stats: f32 matmuls and sums in another
  order, 1e-5 of the largest magnitude.
* search ids equal, except inside runs of scores equal to 1e-5 relative;
  scores within 1e-5 of the largest |score| (an L2 distance is a
  difference of terms that can be far larger than it).
* the port's own fit (its N(0,1) sample differs): reconstruction MSE
  within 2% of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core.config import Metric, RaBitQConfig
from vq_tpu.methods import rabitq as jrb
from vq_tpu_torch import convert
from vq_tpu_torch.methods import rabitq as trb

from test_torch_flat_index import assert_close_scores, assert_same_ranking

torch.set_num_threads(1)

N, D = 1300, 96


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    x = (rng.standard_normal((N, D)) * np.linspace(2.0, 0.3, D) + 0.5).astype(np.float32)
    q = x[rng.integers(0, N, 7)] + 0.1 * rng.standard_normal((7, D)).astype(np.float32)
    return x, q, np.linalg.norm(x, axis=1)


@pytest.fixture(scope="module", params=[1, 2, 6])
def pair(request, data):
    cfg = RaBitQConfig(num_bits=request.param)
    j = jrb.RaBitQ(cfg).fit(data[0])
    t = convert.rabitq_from_numpy(jax.tree_util.tree_map(np.asarray, j.params),
                                  convert.config_from_jax(cfg), device="cpu")
    return request.param, j, t, np.array(j.compress(data[0]))  # writable, for torch


def test_encode_decode_match_jax(pair, data):
    bits, j, t, jc = pair
    tc = t.compress(data[0]).numpy()
    same = (tc[:, :-8] == jc[:, :-8]).all(axis=1)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(tc[same, -8:].copy().view(np.float32),
                               jc[same, -8:].copy().view(np.float32), rtol=2e-6)
    want = np.asarray(j.decompress(jc))
    np.testing.assert_allclose(t.decompress(jc).numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_prepare_packed_matches_jax(pair, data):
    bits, j, t, jc = pair
    norms = data[2]
    jp = jrb.prepare_packed(j.params, jnp.asarray(jc), bits, norms=jnp.asarray(norms))
    tp = trb.prepare_packed(t.params, torch.from_numpy(jc), bits, norms=torch.from_numpy(norms))
    assert tp.num_rows == N and tp.perm is None and tp.prune_hint == jp.prune_hint
    np.testing.assert_array_equal(tp.words[0].numpy(), np.asarray(jp.words[0]))
    want = np.asarray(jp.factors).T
    np.testing.assert_allclose(tp.factors.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(tp.tile_stats.numpy(), np.asarray(jp.tile_stats), rtol=1e-5,
                               atol=1e-6)


def test_packed_scan_matches_pallas(pair, data):
    bits, j, t, jc = pair
    _, q, norms = data
    jp = jrb.prepare_packed(j.params, jnp.asarray(jc), bits, norms=jnp.asarray(norms))
    tp = trb.prepare_packed(t.params, torch.from_numpy(jc), bits, norms=torch.from_numpy(norms))
    metrics = (Metric.L2, Metric.IP, Metric.NIP) if bits == 2 else (Metric.L2,)
    for metric in metrics:
        for prune in (False, True):
            ws, wi = jrb.scan_topk(j.params, jnp.asarray(q), jnp.asarray(jc), 10, metric, bits,
                                   packed_cache=jp, use_packed=True, interpret=True,
                                   prune_tiles=prune)
            gs, gi = t.scan_topk(torch.from_numpy(q), torch.from_numpy(jc), 10, metric,
                                 cache=tp, prune_tiles=prune)
            assert_same_ranking(gi.numpy(), np.asarray(wi), np.asarray(ws))
            assert_close_scores(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP, Metric.NIP])
def test_streaming_scan_matches_jax(pair, data, metric):
    bits, j, t, jc = pair
    _, q, norms = data
    for k in (10, 130):
        ws, wi = jrb.scan_topk(j.params, jnp.asarray(q), jnp.asarray(jc), k, metric, bits,
                               norms=jnp.asarray(norms), use_packed=False, tile_rows=512)
        gs, gi = trb.scan_topk(t.params, torch.from_numpy(q), torch.from_numpy(jc), k, metric,
                               bits, norms=torch.from_numpy(norms), use_packed=False,
                               tile_rows=512)
        assert_same_ranking(gi.numpy(), np.asarray(wi), np.asarray(ws))
        assert_close_scores(gs.numpy(), np.asarray(ws))


def test_port_fit_quality_matches_jax(pair, data):
    bits, j, _, _ = pair
    x = data[0]
    t = trb.RaBitQ(RaBitQConfig(num_bits=bits)).fit(torch.from_numpy(x))
    assert t.device == torch.device("cpu")
    np.testing.assert_allclose(t.params.centroid.numpy(), np.asarray(j.params.centroid),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t.params.rotation.numpy(), np.asarray(j.params.rotation))
    mse_t = t.reconstruction_mse(x)
    mse_j = float(np.mean((np.asarray(j.decompress(j.compress(x))) - x) ** 2))
    assert mse_t <= 1.02 * mse_j, (mse_t, mse_j)


def test_save_load_roundtrip(pair, tmp_path):
    bits, _, t, jc = pair
    path = str(tmp_path / "rabitq.pkl")
    t.save(path)
    back = trb.RaBitQ(t.cfg, device="cpu").load(path)
    assert back.code_bytes_per_vector() == t.code_bytes_per_vector()
    np.testing.assert_array_equal(back.decompress(jc).numpy(), t.decompress(jc).numpy())
    with pytest.raises(ValueError, match="num_bits"):
        trb.RaBitQ(RaBitQConfig(num_bits=9))
