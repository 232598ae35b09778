"""The whole slice: a JAX FlatQuantizedIndex(PQ), fitted on seeded data and
converted to the port through numpy, must search like the original.

Both sides run f32 on the CPU (bf16 is CUDA-only in the port, TPU-only in
the JAX package).  Ids must be equal at k=10 and k=100 for L2, IP and NIP,
except inside runs of scores equal to 1e-5 relative, whose order f32 sums
taken in another order may swap; scores agree to 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core.config import KMeansConfig, Metric, PQConfig, SearchConfig
from vq_tpu.index.flat import FlatQuantizedIndex as JaxFlat
from vq_tpu.methods.pq import PQ as JaxPQ
from vq_tpu.metrics.recall import recall_at_k
from vq_tpu_torch import convert
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.kernels.adc import exact_topk
from vq_tpu_torch.methods.pq import PQ

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
        tol = rtol * abs(s[c])
        tied = (c > 0 and abs(s[c] - s[c - 1]) <= tol) or (
            c + 1 < len(s) and abs(s[c + 1] - s[c]) <= tol)
        assert tied, (r, c, s[max(c - 1, 0):c + 2], got_ids[r, c], want_ids[r, c])


def _pair(x, metric):
    j = JaxFlat(JaxPQ(CFG, seed=0), SearchConfig(metric=metric)).fit(x)
    t = convert.flat_index_from_numpy(
        np.asarray(j.quantizer.params.codebooks), np.asarray(j.codes), np.asarray(j.norms),
        j.num_rows, j.search_cfg, CFG)
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
    back = FlatQuantizedIndex(PQ(CFG)).load(path)
    assert back.num_rows == t.num_rows and back.search_cfg == t.search_cfg
    for k in (10, 100):
        np.testing.assert_array_equal(back.search(q, k), t.search(q, k))


def test_port_fit_end_to_end_recall_close_to_jax(data):
    """The port fits with its own PRNG: recall@10 against exact ground truth
    within 0.1 of the JAX package's on the same data."""
    x, q = data
    _, gt = exact_topk(torch.from_numpy(q), torch.from_numpy(x), 10)
    t = FlatQuantizedIndex(PQ(CFG, seed=0)).fit(x)
    j = JaxFlat(JaxPQ(CFG, seed=0)).fit(x)
    r_t = recall_at_k(gt.numpy(), t.search(q, 10), 10)
    r_j = recall_at_k(gt.numpy(), j.search(q, 10), 10)
    assert r_t >= r_j - 0.1, (r_t, r_j)
    np.testing.assert_allclose(t.norms.numpy(), np.asarray(jnp.linalg.norm(x, axis=-1)),
                               rtol=1e-6)


def test_approx_topk_is_refused():
    with pytest.raises(ValueError, match="approx"):
        FlatQuantizedIndex(PQ(CFG), SearchConfig(approx=True))
