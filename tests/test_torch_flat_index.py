"""The whole slice: a JAX FlatQuantizedIndex(PQ / SAQ / RaBitQ), fitted on
seeded data and converted to the port through numpy, must search like the
original.  (The JAX package on the CPU scans SAQ and RaBitQ with its plain
streaming route; the port takes its packed route over the layout its
``fit`` builds, the plain twin of the packed kernel on the CPU.)

Both sides run f32 on the CPU (bf16 is CUDA-only in the port, TPU-only in
the JAX package).  Ids must be equal at k=10 and k=100 for L2, IP and NIP,
except inside runs of scores equal to 1e-5 relative, whose order f32 sums
taken in another order may swap; scores agree to 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core.config import (
    KMeansConfig,
    Metric,
    PQConfig,
    RaBitQConfig,
    SAQConfig,
    SearchConfig,
)
from vq_tpu.index.flat import FlatQuantizedIndex as JaxFlat
from vq_tpu.methods.pq import PQ as JaxPQ
from vq_tpu.methods.rabitq import RaBitQ as JaxRaBitQ
from vq_tpu.methods.saq import SAQ as JaxSAQ
from vq_tpu.metrics.recall import recall_at_k
from vq_tpu_torch import convert
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.kernels.adc import exact_topk
from vq_tpu_torch.methods.pq import PQ
from vq_tpu_torch.methods.rabitq import RaBitQ
from vq_tpu_torch.methods.saq import SAQ

torch.set_num_threads(1)

CFG = PQConfig(num_subquantizers=8, num_bits=6, kmeans=KMeansConfig(iters=6))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4000, 64)) * np.linspace(2.0, 0.3, 64)).astype(np.float32)
    q = x[rng.integers(0, 4000, 24)] + 0.1 * rng.standard_normal((24, 64)).astype(np.float32)
    return x, q


def assert_same_ranking(got_ids, want_ids, want_scores, rtol=1e-5):
    """Ids equal, except where a score ties its neighbour to ``rtol``."""
    for r, c in np.argwhere(got_ids != want_ids):
        s = want_scores[r]
        tol = rtol * max(abs(s[c]), 1e-6)
        tied = (c > 0 and abs(s[c] - s[c - 1]) <= tol) or (
            c + 1 < len(s) and abs(s[c + 1] - s[c]) <= tol)
        assert tied, (r, c, s[max(c - 1, 0):c + 2], got_ids[r, c], want_ids[r, c])


def assert_close_scores(got, want):
    """Within 1e-5 of the largest |score|: an L2 distance is a difference of
    terms that can be far larger than it."""
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def _pair(x, metric):
    j = JaxFlat(JaxPQ(CFG, seed=0), SearchConfig(metric=metric)).fit(x)
    t = convert.flat_index_from_numpy(
        np.asarray(j.quantizer.params.codebooks), np.asarray(j.codes), np.asarray(j.norms),
        j.num_rows, convert.config_from_jax(j.search_cfg), convert.config_from_jax(CFG),
        device="cpu")
    return j, t


@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP, Metric.NIP])
def test_converted_index_searches_like_jax(data, metric):
    x, q = data
    j, t = _pair(x, metric)
    for k in (10, 100):
        wi, ws = j.search_with_scores(q, k)
        gi, gs = t.search_with_scores(q, k)
        assert gi.dtype == np.uint32 and gi.shape == (24, k)
        assert_same_ranking(gi, wi, ws)
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-4)


def test_memory_footprint_and_mse_match_jax(data):
    x, _ = data
    j, t = _pair(x, Metric.L2)
    assert t.memory_footprint() == j.memory_footprint()
    np.testing.assert_allclose(t.reconstruction_mse(x, 2000), j.reconstruction_mse(x, 2000),
                               rtol=1e-5)


def test_save_load_roundtrip(data, tmp_path):
    x, q = data
    _, t = _pair(x, Metric.NIP)
    path = str(tmp_path / "flat.pkl")
    t.save(path)
    back = FlatQuantizedIndex(PQ(CFG, device="cpu")).load(path)
    assert back.num_rows == t.num_rows and back.search_cfg == t.search_cfg
    for k in (10, 100):
        np.testing.assert_array_equal(back.search(q, k), t.search(q, k))


def test_port_fit_end_to_end_recall_close_to_jax(data):
    """The port fits with its own PRNG: recall@10 against exact ground truth
    within 0.1 of the JAX package's on the same data."""
    x, q = data
    _, gt = exact_topk(torch.from_numpy(q), torch.from_numpy(x), 10)
    t = FlatQuantizedIndex(PQ(CFG, seed=0, device="cpu")).fit(x)
    j = JaxFlat(JaxPQ(CFG, seed=0)).fit(x)
    r_t = recall_at_k(gt.numpy(), t.search(q, 10), 10)
    r_j = recall_at_k(gt.numpy(), j.search(q, 10), 10)
    assert r_t >= r_j - 0.1, (r_t, r_j)
    np.testing.assert_allclose(t.norms.numpy(), np.asarray(jnp.linalg.norm(x, axis=-1)),
                               rtol=1e-6)


def test_nine_bit_pq_footprint_and_search_equal_jax():
    """PQ M=4 B=9 on 3000 × 16 rows: uint16 codes, the JAX package's
    footprint byte for byte (68,768 B), and its search."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3000, 16)).astype(np.float32)
    q = x[:20] + 0.05 * rng.standard_normal((20, 16)).astype(np.float32)
    cfg = PQConfig(num_subquantizers=4, num_bits=9, kmeans=KMeansConfig(iters=3))
    j = JaxFlat(JaxPQ(cfg, seed=0)).fit(x)
    t = convert.flat_index_from_numpy(
        np.asarray(j.quantizer.params.codebooks), np.asarray(j.codes), np.asarray(j.norms),
        j.num_rows, convert.config_from_jax(j.search_cfg), convert.config_from_jax(cfg),
        device="cpu")
    assert t.codes.dtype == torch.uint16
    assert t.memory_footprint() == j.memory_footprint() == 68_768
    for k in (10, 100):
        wi, ws = j.search_with_scores(q, k)
        gi, gs = t.search_with_scores(q, k)
        assert_same_ranking(gi, wi, ws)
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-4)
    own = FlatQuantizedIndex(PQ(convert.config_from_jax(cfg), device="cpu")).fit(x)
    assert own.codes.dtype == torch.uint16 and own.memory_footprint() == 68_768


@pytest.mark.parametrize("k", [10, 150])
def test_approx_topk_gives_the_jax_packages_cpu_result(data, k):
    """SearchConfig(approx=True) on the PQ index (k=150 > 128: the
    streaming route; one 4000-wide tile, where the JAX package calls
    ``lax.approx_max_k``): off the TPU JAX returns its exact result bit for
    bit, and so does the port; the two agree as above."""
    x, q = data
    j, t = _pair(x, Metric.L2)
    exact_j, exact_t = j.search_with_scores(q, k), t.search_with_scores(q, k)
    j.search_cfg = dataclasses.replace(j.search_cfg, approx=True)
    t.search_cfg = dataclasses.replace(t.search_cfg, approx=True)
    wi, ws = j.search_with_scores(q, k)
    gi, gs = t.search_with_scores(q, k)
    np.testing.assert_array_equal(wi, exact_j[0])
    np.testing.assert_array_equal(ws, exact_j[1])
    np.testing.assert_array_equal(gi, exact_t[0])
    np.testing.assert_array_equal(gs, exact_t[1])
    assert_same_ranking(gi, wi, ws)
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-4)


SAQ_CFG = SAQConfig(bits_per_dim=2.0, block_dims=16)
RABITQ_CFG = RaBitQConfig(num_bits=2)


@pytest.fixture(scope="module")
def packed_quantizers(data):
    """JAX SAQ and RaBitQ fitted once; each index below encodes with them."""
    x, _ = data
    return {"saq": JaxSAQ(SAQ_CFG).fit(x), "rabitq": JaxRaBitQ(RABITQ_CFG).fit(x)}


def _packed_pair(x, quantizers, name, metric):
    jq = quantizers[name]
    j = JaxFlat(jq, SearchConfig(metric=metric)).fit(x)
    params = jax.tree_util.tree_map(np.asarray, jq.params)
    tq = (convert.saq_from_numpy(jq.plan, params, convert.config_from_jax(SAQ_CFG),
                                 device="cpu") if name == "saq"
          else convert.rabitq_from_numpy(params, convert.config_from_jax(RABITQ_CFG),
                                         device="cpu"))
    t = convert.flat_index_of(tq, np.asarray(j.codes), np.asarray(j.norms), j.num_rows,
                              convert.config_from_jax(j.search_cfg))
    return j, t


@pytest.mark.parametrize("name", ["saq", "rabitq"])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP, Metric.NIP])
def test_converted_packed_index_searches_like_jax(data, packed_quantizers, name, metric):
    """Ids equal at k=10 and k=100 except inside runs of scores equal to
    1e-5 relative; scores within 1e-5 of the largest |score| (an L2 distance
    is a difference of terms that can be far larger than it)."""
    x, q = data
    j, t = _packed_pair(x, packed_quantizers, name, metric)
    assert t._scan_cache is not None
    for k in (10, 100):
        wi, ws = j.search_with_scores(q, k)
        gi, gs = t.search_with_scores(q, k)
        assert gi.dtype == np.uint32 and gi.shape == (24, k)
        assert_same_ranking(gi, wi, ws)
        assert_close_scores(gs, ws)


@pytest.mark.parametrize("name", ["saq", "rabitq"])
def test_packed_memory_footprint_matches_jax(data, packed_quantizers, name):
    j, t = _packed_pair(data[0], packed_quantizers, name, Metric.L2)
    assert t.memory_footprint() == j.memory_footprint()


@pytest.mark.parametrize("name", ["saq", "rabitq"])
def test_packed_save_load_roundtrip(data, packed_quantizers, tmp_path, name):
    """Nested params (SAQ's per-segment rotation tuple) survive save/load,
    and the loaded index rebuilds its scan layout."""
    x, q = data
    _, t = _packed_pair(x, packed_quantizers, name, Metric.NIP)
    path = str(tmp_path / "flat.pkl")
    t.save(path)
    fresh = SAQ(SAQ_CFG, device="cpu") if name == "saq" else RaBitQ(RABITQ_CFG, device="cpu")
    back = FlatQuantizedIndex(fresh).load(path)
    assert back._scan_cache is not None
    for k in (10, 100):
        np.testing.assert_array_equal(back.search(q, k), t.search(q, k))
    qpath = str(tmp_path / "quantizer.pkl")
    t.quantizer.save(qpath)
    loaded = (SAQ(SAQ_CFG, device="cpu") if name == "saq"
              else RaBitQ(RABITQ_CFG, device="cpu")).load(qpath)
    np.testing.assert_array_equal(loaded.compress(x[:50]).numpy(),
                                  t.quantizer.compress(x[:50]).numpy())
