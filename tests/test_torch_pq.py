"""The port's methods/pq.py (and data/sampling.py) against vq_tpu on the CPU.

Codebooks fitted by the JAX package are converted through numpy, so both
packages encode and decode with the same codebooks.  Codes must be equal;
where one differs (a near-tie in a subspace argmin) the two codewords'
subspace distances must agree within 1e-5 relative.  Decoded rows agree to
1e-6 (a gather on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core.config import KMeansConfig, PQConfig
from vq_tpu.data import sampling as jsampling
from vq_tpu.methods import pq as jpq
from vq_tpu_torch import convert
from vq_tpu_torch.data import sampling as tsampling
from vq_tpu_torch.methods import pq as tpq

torch.set_num_threads(1)

CFG = PQConfig(num_subquantizers=4, num_bits=6, kmeans=KMeansConfig(iters=8))


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3000, 32)) * np.linspace(2.0, 0.2, 32)).astype(np.float32)
    jq = jpq.PQ(CFG, seed=0).fit(x)
    tq = convert.pq_from_numpy(np.asarray(jq.params.codebooks), convert.config_from_jax(CFG),
                               device="cpu")
    return x, jq, tq


def test_encode_matches_jax(fitted):
    x, jq, tq = fitted
    want = np.asarray(jq.compress(x))
    got = tq.compress(x)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    got = got.numpy()
    diff = np.argwhere(got != want)
    cb = np.asarray(jq.params.codebooks)
    xs = x.reshape(len(x), 4, -1)
    for r, m in diff:  # near-ties only: equal subspace distances
        d_got = np.sum((xs[r, m] - cb[m, got[r, m]]) ** 2)
        d_want = np.sum((xs[r, m] - cb[m, want[r, m]]) ** 2)
        np.testing.assert_allclose(d_got, d_want, rtol=1e-5)
    assert len(diff) <= 3


def test_encode_chunked_ragged_tail_matches_one_chunk(fitted):
    x, _, tq = fitted
    whole = tpq.encode(tq.params, x, chunk=4096)
    ragged = tpq.encode(tq.params, x, chunk=700)  # 3000 = 4·700 + 200
    np.testing.assert_array_equal(ragged.numpy(), whole.numpy())


def test_decode_matches_jax(fitted):
    x, jq, tq = fitted
    codes = np.asarray(jq.compress(x[:500]))
    want = np.asarray(jq.decompress(codes))
    got = tq.decompress(codes).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_mse_and_compression_ratio_match_jax(fitted):
    x, jq, tq = fitted
    np.testing.assert_allclose(tq.reconstruction_mse(x, 1000), jq.reconstruction_mse(x, 1000),
                               rtol=1e-5)
    assert tq.get_compression_ratio(x) == jq.get_compression_ratio(x)
    assert tq.code_bytes_per_vector() == jq.code_bytes_per_vector()
    assert tq.config_dict() == jq.config_dict()


def test_own_fit_quality_matches_jax(fitted):
    """The port's fit uses its own PRNG: reconstruction MSE within 5%."""
    x, jq, _ = fitted
    tq = tpq.PQ(convert.config_from_jax(CFG), seed=0, device="cpu").fit(x)
    assert tq.params.codebooks.shape == (4, 64, 8)
    assert tq.reconstruction_mse(x) <= 1.05 * jq.reconstruction_mse(x)


def test_scan_topk_matches_jax(fitted):
    from vq_tpu.core.config import Metric

    x, jq, tq = fitted
    codes = np.array(jq.compress(x))  # a writable copy for torch.from_numpy
    q = x[:20] + 0.05
    ws, wi = jq.scan_topk(jnp.asarray(q), jnp.asarray(codes), 10, Metric.L2)
    gs, gi = tq.scan_topk(torch.from_numpy(q), torch.from_numpy(codes), 10, Metric.L2)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-4)


def test_save_load_roundtrip(fitted, tmp_path):
    x, _, tq = fitted
    path = str(tmp_path / "pq.pkl")
    tq.save(path)
    back = tpq.PQ(convert.config_from_jax(CFG), device="cpu").load(path)
    assert back.dim == 32
    np.testing.assert_array_equal(back.params.codebooks.numpy(), tq.params.codebooks.numpy())
    np.testing.assert_array_equal(back.compress(x).numpy(), tq.compress(x).numpy())


@pytest.mark.parametrize("cap", [100, 5000])
def test_host_sample_rows_numpy_matches_jax(cap):
    x = np.random.default_rng(1).standard_normal((1000, 4)).astype(np.float32)
    want = np.asarray(jsampling.host_sample_rows(x, cap, seed=3))
    got = tsampling.host_sample_rows(x, cap, seed=3)
    np.testing.assert_array_equal(got, want)


def test_host_sample_rows_tensor_stays_a_tensor():
    x = torch.arange(4000, dtype=torch.float32).reshape(1000, 4)
    got = tsampling.host_sample_rows(x, 100, seed=3)
    assert isinstance(got, torch.Tensor) and got.shape == (100, 4)
    rows = got[:, 0].numpy() / 4
    assert len(set(rows)) == 100 and np.all(np.diff(rows) > 0)


def test_chunk_rows_for_bytes_matches_jax():
    for d in (32, 1536, 1 << 20):
        assert tsampling.chunk_rows_for_bytes(d) == jsampling.chunk_rows_for_bytes(d)


def test_to_subspaces_layout_matches_jax():
    x = np.arange(24, dtype=np.float32).reshape(3, 8)
    want = np.asarray(jpq._to_subspaces(jnp.asarray(x), 4))
    np.testing.assert_array_equal(tpq._to_subspaces(torch.from_numpy(x), 4).numpy(), want)
    with pytest.raises(ValueError):
        tpq._to_subspaces(torch.from_numpy(x), 3)


def test_nine_bit_codes_are_uint16_like_jax():
    """K = 512 codewords: uint16 codes (the JAX package's dtype), equal to
    JAX's encode from the same codebooks, and the code bytes it reports."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3000, 16)).astype(np.float32)
    cfg = PQConfig(num_subquantizers=4, num_bits=9, kmeans=KMeansConfig(iters=3))
    jq = jpq.PQ(cfg, seed=0).fit(x)
    tq = convert.pq_from_numpy(np.asarray(jq.params.codebooks), convert.config_from_jax(cfg),
                               device="cpu")
    want = np.asarray(jq.compress(x))
    got = tq.compress(x)
    assert want.dtype == np.uint16 and got.dtype == torch.uint16
    assert (got.numpy() != want).sum() <= 3  # subspace near-ties only
    np.testing.assert_allclose(tq.decompress(want).numpy(), np.asarray(jq.decompress(want)),
                               atol=1e-6, rtol=0)
    assert tq.code_bytes_per_vector() == jq.code_bytes_per_vector() == 8.0


def test_codes_from_numpy_keeps_the_dtype():
    """uint16 codes whose values are all ≤ 255 stay uint16 (the dtype is the
    codebook's, not the values')."""
    small = np.arange(12, dtype=np.uint16).reshape(3, 4)
    assert convert.codes_from_numpy(small, "cpu").dtype == torch.uint16
    assert convert.codes_from_numpy(small.astype(np.uint8), "cpu").dtype == torch.uint8
    with pytest.raises(ValueError, match="uint8 or uint16"):
        convert.codes_from_numpy(small.astype(np.int32), "cpu")
