"""The port's kernels/adc.py against vq_tpu/kernels/adc.py on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  Both run
in f32 here (bf16 is CUDA-only in the port and TPU-only in the JAX package).
Tolerances: 1e-5 relative where both sides compute the same f32 sums in a
different order; ids must be equal (random data has no near-ties at these
sizes, and planted ties must follow lax.top_k's order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core.config import Metric
from vq_tpu.kernels import adc as jadc
from vq_tpu_torch.kernels import adc as tadc

torch.set_num_threads(1)

METRICS = [Metric.L2, Metric.IP, Metric.NIP]


def _data(n=1000, d=32, q=12, m=4, kk=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    codes = rng.integers(0, kk, (n, m)).astype(np.uint8)
    cb = rng.standard_normal((m, kk, d // m)).astype(np.float32)
    norms = (np.abs(rng.standard_normal(n)) + 0.5).astype(np.float32)
    return x, qs, codes, cb, norms


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_pairwise_sqdist_matches_jax():
    x, q, *_ = _data()
    want = np.asarray(jadc.pairwise_sqdist(jnp.asarray(q), jnp.asarray(x)))
    got = tadc.pairwise_sqdist(_t(q), _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_decode_pq_matches_jax():
    _, _, codes, cb, _ = _data()
    want = np.asarray(jadc.decode_pq(jnp.asarray(cb), jnp.asarray(codes)))
    got = tadc.decode_pq(_t(cb), _t(codes)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP])
def test_build_lut_matches_jax(metric):
    _, q, _, cb, _ = _data()
    want = np.asarray(jadc.build_lut(jnp.asarray(cb), jnp.asarray(q), metric))
    got = tadc.build_lut(_t(cb), _t(q), metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("num_valid", [None, 777])
def test_exact_topk_matches_jax(metric, num_valid):
    """tile_rows=256 over n=1000 leaves a ragged, clamped last tile."""
    x, q, _, _, norms = _data()
    nv = None if num_valid is None else jnp.int32(num_valid)
    ws, wi = jadc.exact_topk(jnp.asarray(q), jnp.asarray(x), 10, metric,
                             norms=jnp.asarray(norms), tile_rows=256, num_valid=nv)
    gs, gi = tadc.exact_topk(_t(q), _t(x), 10, metric, norms=_t(norms), tile_rows=256,
                             num_valid=num_valid)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-4)
    if num_valid is not None:
        assert gi.numpy().max() < num_valid


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [10, 100])
def test_scan_codes_topk_matches_jax(metric, k):
    _, q, codes, cb, norms = _data()
    ws, wi = jadc.scan_codes_topk(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(cb), k,
                                  metric, jnp.asarray(norms), tile_rows=384, use_bf16=True)
    gs, gi = tadc.scan_codes_topk(_t(q), _t(codes), _t(cb), k, metric, _t(norms),
                                  tile_rows=384, use_bf16=True)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-4)


def test_scan_codes_topk_num_valid_matches_jax():
    _, q, codes, cb, _ = _data(seed=3)
    ws, wi = jadc.scan_codes_topk(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(cb), 10,
                                  Metric.L2, tile_rows=256, num_valid=jnp.int32(500))
    gs, gi = tadc.scan_codes_topk(_t(q), _t(codes), _t(cb), 10, Metric.L2, tile_rows=256,
                                  num_valid=500)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert gi.numpy().max() < 500


@pytest.mark.parametrize("metric", METRICS)
def test_scan_generic_topk_matches_jax(metric):
    _, q, codes, cb, norms = _data(seed=4)
    jcb, tcb = jnp.asarray(cb), _t(cb)
    ws, wi = jadc.scan_generic_topk(jnp.asarray(q), jnp.asarray(codes),
                                    lambda ct: jadc.decode_pq(jcb, ct), 10, metric,
                                    jnp.asarray(norms), tile_rows=300)
    gs, gi = tadc.scan_generic_topk(_t(q), _t(codes), lambda ct: tadc.decode_pq(tcb, ct), 10,
                                    metric, _t(norms), tile_rows=300)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n_tiles", [1, 5])
def test_streaming_topk_planted_ties_follow_lax_top_k(n_tiles):
    """Scores drawn from 4 values, so most top-k slots are ties; the order
    must be lax.top_k's (score desc, then id asc) across tile merges."""
    rng = np.random.default_rng(7)
    n, q, k = 640, 6, 50
    tile = n // n_tiles
    s = rng.choice(np.array([-1.0, 0.5, 2.0, 3.0], np.float32), size=(q, n))
    s[:, 200:210] = -np.inf  # masked columns among the rest
    js, ji = jadc._streaming_topk(lambda st: jax.lax.dynamic_slice_in_dim(
        jnp.asarray(s), st, tile, axis=1), n, q, k, tile)
    ts, ti = tadc._streaming_topk(lambda st: _t(s[:, st:st + tile]), n, q, k, tile)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
