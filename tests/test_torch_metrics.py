"""The port's harness metrics (``vq_tpu_torch/metrics``) against the JAX
package's on the same seeded arrays.

The metrics are the same numpy code on the host, so every value must equal
JAX's exactly (float equality), for numpy input and for tensors, which go
through the host copy (``_device.to_host``) first.
"""

import numpy as np
import pytest
import torch

import vq_tpu.metrics as jm
import vq_tpu_torch.metrics as tm
from vq_tpu_torch import _device

torch.set_num_threads(1)

KINDS = ("numpy", "tensor")


def _as(kind, a):
    return torch.from_numpy(np.ascontiguousarray(a)) if kind == "tensor" else a


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((400, 24)).astype(np.float32)
    x_hat = (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    gt = np.argsort(rng.standard_normal((30, 400)), axis=1)[:, :100].astype(np.int32)
    ids = gt.copy()
    ids[:, ::3] = rng.integers(0, 400, ids[:, ::3].shape)  # some misses
    return x, x_hat, gt, ids.astype(np.uint32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 10, 100])
def test_recall_and_rank_distortion_equal_jax(arrays, kind, k):
    _, _, gt, ids = arrays
    g, i = _as(kind, gt), _as(kind, ids.astype(np.int64))
    assert tm.recall_at_k(g, i, k) == jm.recall_at_k(gt, ids, k)
    assert tm.compute_rank_distortion(g, i, k) == jm.compute_rank_distortion(gt, ids, k)
    np.testing.assert_array_equal(tm.compute_rank_distortion_per_query(g, i, k),
                                  jm.compute_rank_distortion_per_query(gt, ids, k))


@pytest.mark.parametrize("kind", KINDS)
def test_recall_at_ks_equals_jax(arrays, kind):
    _, _, gt, ids = arrays
    got = tm.recall_at_ks(_as(kind, gt), _as(kind, ids.astype(np.int64)), (1, 10, 100, 200))
    assert got == jm.recall_at_ks(gt, ids, (1, 10, 100, 200)) and set(got) == {1, 10, 100}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sample", [None, 50, 10_000])
def test_distortion_and_mse_equal_jax(arrays, kind, sample):
    x, x_hat, _, _ = arrays
    assert tm.compute_distortion(_as(kind, x), _as(kind, x_hat)) == \
        jm.compute_distortion(x, x_hat)
    assert tm.reconstruction_mse(_as(kind, x), _as(kind, x_hat), sample) == \
        jm.reconstruction_mse(x, x_hat, sample)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("num_pairs,seed", [(1000, 42), (50, 3)])
def test_pairwise_distortion_equals_jax(arrays, kind, num_pairs, seed):
    x, x_hat, _, _ = arrays
    assert tm.compute_pairwise_distortion(_as(kind, x), _as(kind, x_hat), num_pairs, seed) == \
        jm.compute_pairwise_distortion(x, x_hat, num_pairs, seed)


def test_pairwise_distortion_of_two_rows_equals_jax():
    """The fallback when every random pair repeats a row (n = 1 draws)."""
    x = np.array([[0.0, 1.0], [2.0, 0.5]], np.float32)
    assert tm.compute_pairwise_distortion(x, x * 1.5, num_pairs=1) == \
        jm.compute_pairwise_distortion(x, x * 1.5, num_pairs=1)


class _HalfDecoder:
    """decompress = codes · 0.5, exact in f32 on numpy (the JAX side) and on
    tensors (the port's side, where codes stay tensors)."""

    def decompress(self, codes):
        if isinstance(codes, torch.Tensor):
            return codes.to(torch.float32) * 0.5
        return np.asarray(codes, np.float32) * 0.5


@pytest.mark.parametrize("kind", KINDS)
def test_asymmetric_pairwise_distortion_equals_jax(arrays, kind):
    x, _, _, _ = arrays
    codes = np.round(x * 2.0).astype(np.int16)
    want = jm.compute_asymmetric_pairwise_distortion(x, codes, _HalfDecoder(), 300, 5)
    got = tm.compute_asymmetric_pairwise_distortion(_as(kind, x), _as(kind, codes),
                                                    _HalfDecoder(), 300, 5)
    assert got == want


class _Index:
    """search_with_scores returns fixed ids (numpy, as the indexes do)."""

    def __init__(self, ids):
        self.ids, self.calls = ids, 0

    def search_with_scores(self, queries, k=10):
        self.calls += 1
        return self.ids[: len(queries), :k], np.zeros((len(queries), k), np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_evaluate_recall_and_qps_match_jax(arrays, kind):
    x, _, gt, ids = arrays
    q = x[:30]
    assert tm.evaluate_recall(_Index(ids), _as(kind, q), gt) == \
        jm.evaluate_recall(_Index(ids), q, gt)
    t_idx, j_idx = _Index(ids), _Index(ids)
    got, want = tm.measure_qps(t_idx, _as(kind, q), k=10), jm.measure_qps(j_idx, q, k=10)
    assert set(got) == set(want) and t_idx.calls == j_idx.calls == 4
    assert got["qps"] > 0 and got["avg_query_latency_ms"] > 0
    one = _Index(ids)
    tm.measure_qps(one, _as(kind, q[0]), k=5, repeats=2, warmup=0)  # a single query
    assert one.calls == 2


def test_timed_compress_keeps_codes_on_the_device_and_copies_the_rest_to_the_host(monkeypatch):
    """time_compress returns the model's codes as they are (a tensor on its
    device), its window holding their copy to the host; time_decompress
    returns numpy."""
    copied = []
    real = _device.to_host
    monkeypatch.setattr("vq_tpu_torch.metrics.performance.to_host",
                        lambda a: copied.append(a) or real(a))

    class Model:
        def compress(self, x):
            return torch.as_tensor(x) * 2

        def decompress(self, c):
            return c / 2

    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    codes, t = tm.time_compress(Model(), x)
    assert isinstance(codes, torch.Tensor) and t >= 0 and copied[0] is codes
    rec, t = tm.time_decompress(Model(), codes)
    assert isinstance(rec, np.ndarray) and t >= 0
    np.testing.assert_array_equal(rec, x)


def test_public_names_match_jax():
    assert sorted(tm.__all__) == sorted(jm.__all__)
