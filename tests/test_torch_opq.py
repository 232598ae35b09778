"""The port's methods/opq.py against vq_tpu/methods/opq.py on the CPU.

Tolerances and their reasons:
* converted params: codes equal except at subspace near-ties (the same
  rotation and codebooks; the rotated rows in another f32 summation order),
  each such code's subspace distance within 1e-5 relative of JAX's pick;
  decode within 1e-5 of the largest |value| (a (D, D) product).
* scan ids: equal except inside runs of scores equal to 1e-5 relative;
  scores within 1e-5 of the largest |score|.
* the port's own fit: R orthogonal (‖RᵀR − I‖ < 1e-4), reconstruction MSE
  no worse than the PQ fit it starts from, recall@10 within 0.02 of the JAX
  package's own fit (the PRNGs differ, so only quality compares).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core.config import KMeansConfig, Metric, OPQConfig, PQConfig, SearchConfig
from vq_tpu.index.flat import FlatQuantizedIndex as JaxFlat
from vq_tpu.methods.opq import OPQ as JaxOPQ
from vq_tpu.metrics.recall import recall_at_k
from vq_tpu_torch import convert
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.kernels.adc import exact_topk
from vq_tpu_torch.methods import opq as topq
from vq_tpu_torch.methods.pq import PQ

from test_torch_flat_index import assert_close_scores, assert_same_ranking

torch.set_num_threads(1)

N, D, NQ = 3000, 32, 24
CFG = OPQConfig(num_subquantizers=4, num_bits=6, opq_iters=4, kmeans=KMeansConfig(iters=8))


@pytest.fixture(scope="module")
def data():
    """Correlated rows (a random mixing of falling scales): a rotation helps."""
    rng = np.random.default_rng(31)
    mix = np.linalg.qr(rng.standard_normal((D, D)))[0]
    x = ((rng.standard_normal((N, D)) * np.linspace(2.0, 0.2, D)) @ mix).astype(np.float32)
    q = (x[rng.integers(0, N, NQ)] + 0.1 * rng.standard_normal((NQ, D))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def pair(data):
    x, _ = data
    j = JaxOPQ(CFG, seed=0).fit(x)
    t = convert.opq_from_numpy(type(j.params)(*map(np.asarray, j.params)),
                               convert.config_from_jax(CFG), device="cpu")
    return j, t


def test_converted_codes_and_decode_match_jax(data, pair):
    x, _ = data
    j, t = pair
    want = np.asarray(j.compress(x))
    got = t.compress(x).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    xr = x @ np.asarray(j.params.rotation)
    cb = np.asarray(j.params.codebooks)
    xs = xr.reshape(N, 4, -1)
    diff = np.argwhere(got != want)
    for r, m in diff:  # near-ties only
        np.testing.assert_allclose(np.sum((xs[r, m] - cb[m, got[r, m]]) ** 2),
                                   np.sum((xs[r, m] - cb[m, want[r, m]]) ** 2), rtol=1e-5)
    assert len(diff) <= 3
    rec_j = np.asarray(j.decompress(want))
    np.testing.assert_allclose(t.decompress(want).numpy(), rec_j, rtol=0,
                               atol=1e-5 * np.abs(rec_j).max())
    assert t.code_bytes_per_vector() == j.code_bytes_per_vector()
    assert t.config_dict() == j.config_dict()


@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP, Metric.NIP])
def test_scan_topk_matches_jax(data, pair, metric):
    x, q = data
    j, t = pair
    codes = np.array(j.compress(x))
    norms = np.linalg.norm(x, axis=1).astype(np.float32)
    for k in (10, 100):
        ws, wi = j.scan_topk(jnp.asarray(q), jnp.asarray(codes), k, metric,
                             norms=jnp.asarray(norms))
        gs, gi = t.scan_topk(torch.from_numpy(q), torch.from_numpy(codes), k,
                             convert.config_from_jax(SearchConfig(metric=metric)).metric,
                             norms=torch.from_numpy(norms))
        assert_same_ranking(gi.numpy(), np.asarray(wi), np.asarray(ws))
        assert_close_scores(gs.numpy(), np.asarray(ws))


def test_converted_flat_index_footprint_matches_jax(data, pair):
    x, q = data
    j, t = pair
    jidx = JaxFlat(j).fit(x)
    tidx = convert.flat_index_of(t, np.asarray(jidx.codes), np.asarray(jidx.norms),
                                 jidx.num_rows, convert.config_from_jax(jidx.search_cfg))
    assert tidx.memory_footprint() == jidx.memory_footprint()
    wi, ws = jidx.search_with_scores(q, 10)
    gi, gs = tidx.search_with_scores(q, 10)
    assert_same_ranking(gi, wi, ws)


def test_own_fit_quality(data):
    """300 queries: at 24 the recall of two fits from different PRNGs
    spreads by ±0.05 on this corpus, at 300 by ≤ 0.012."""
    x, _ = data
    rng = np.random.default_rng(32)
    q = (x[rng.integers(0, N, 300)] + 0.1 * rng.standard_normal((300, D))).astype(np.float32)
    tcfg = convert.config_from_jax(CFG)
    t = topq.OPQ(tcfg, seed=0, device="cpu").fit(x)
    r = t.params.rotation
    assert float(torch.linalg.norm(r.T @ r - torch.eye(D))) < 1e-4
    pq_mse = PQ(tcfg.pq, seed=0, device="cpu").fit(x).reconstruction_mse(x)
    assert t.reconstruction_mse(x) <= pq_mse
    _, gt = exact_topk(torch.from_numpy(q), torch.from_numpy(x), 10)
    r_t = recall_at_k(gt.numpy(), FlatQuantizedIndex(t).fit(x).search(q, 10), 10)
    r_j = recall_at_k(gt.numpy(), JaxFlat(JaxOPQ(CFG, seed=0)).fit(x).search(q, 10), 10)
    assert r_t >= r_j - 0.02, (r_t, r_j)


def test_xt_xhat_chunked_equals_whole(data, pair, monkeypatch):
    x, _ = data
    _, t = pair
    xt = torch.from_numpy(x)
    xs = topq._to_subspaces(xt @ t.params.rotation, 4)
    whole = topq._xt_xhat(xt, xs, t.params.codebooks)
    monkeypatch.setattr(topq, "_XTX_BUDGET", 4 * 4 * 64 * 700)  # 700-row chunks
    chunked = topq._xt_xhat(xt, xs, t.params.codebooks)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5 * float(whole.abs().max()))


def test_save_load_roundtrip(data, pair, tmp_path):
    x, _ = data
    _, t = pair
    path = str(tmp_path / "opq.pkl")
    t.save(path)
    back = topq.OPQ(convert.config_from_jax(CFG), device="cpu").load(path)
    np.testing.assert_array_equal(back.compress(x).numpy(), t.compress(x).numpy())
