"""The port's methods/sq.py and methods/lvq.py (and data/sampling.py's
chunked_min_max) against the JAX package's on the CPU.

Tolerances and their reasons:
* params (SQ's lo/scale, LVQ's mean): exact for SQ (a min and a max);
  LVQ's mean within 1e-6 relative (an f32 sum in another order).
* codes: byte for byte, from the same params (the same f32 elementwise
  operations, round half to even on both sides).
* decode: within 1e-6 of the largest |value| (the same products).
* scan ids: equal except inside runs of scores equal to 1e-5 relative
  (``test_torch_flat_index.assert_same_ranking``); scores within 1e-5 of the
  largest |score| (a decode-and-dot in another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core.config import LVQConfig, Metric, SearchConfig, SQConfig
from vq_tpu.data import sampling as jsampling
from vq_tpu.index.flat import FlatQuantizedIndex as JaxFlat
from vq_tpu.methods.lvq import LVQ as JaxLVQ
from vq_tpu.methods.sq import SQ as JaxSQ
from vq_tpu_torch import convert
from vq_tpu_torch.data import sampling as tsampling
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.methods.lvq import LVQ
from vq_tpu_torch.methods.sq import SQ

from test_torch_flat_index import assert_close_scores, assert_same_ranking

torch.set_num_threads(1)

N, D, NQ = 3000, 33, 16  # odd D: the 4-bit nibble packing pads a column


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((N, D)) * np.linspace(2.0, 0.2, D) + 0.5).astype(np.float32)
    q = (x[rng.integers(0, N, NQ)] + 0.1 * rng.standard_normal((NQ, D))).astype(np.float32)
    return x, q


def _sq_pair(x, bits):
    j = JaxSQ(SQConfig(bits)).fit(x)
    t = convert.sq_from_numpy(type(j.params)(*map(np.asarray, j.params)), D,
                              convert.config_from_jax(j.cfg), device="cpu")
    return j, t


def test_chunked_min_max_equals_jax(data):
    x, _ = data
    lo_j, hi_j = jsampling.chunked_min_max(x, chunk_rows=700)
    for src in (x, torch.from_numpy(x)):
        lo, hi = tsampling.chunked_min_max(src, "cpu", chunk_rows=700)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_j))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(hi_j))


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_sq_fit_codes_and_decode_equal_jax(data, bits):
    x, _ = data
    j, t = _sq_pair(x, bits)
    own = SQ(convert.config_from_jax(j.cfg), device="cpu").fit(x)
    np.testing.assert_array_equal(own.params.lo.numpy(), np.asarray(j.params.lo))
    np.testing.assert_array_equal(own.params.scale.numpy(), np.asarray(j.params.scale))
    want = np.asarray(j.compress(x))
    got = t.compress(x)
    assert got.dtype == {4: torch.uint8, 8: torch.uint8, 16: torch.uint16}[bits]
    assert got.shape == want.shape == (N, {4: (D + 1) // 2, 8: D, 16: D}[bits])
    np.testing.assert_array_equal(got.numpy(), want)
    rec_j = np.asarray(j.decompress(want))
    np.testing.assert_allclose(t.decompress(want).numpy(), rec_j, rtol=0,
                               atol=1e-6 * np.abs(rec_j).max())
    assert t.code_bytes_per_vector() == j.code_bytes_per_vector()
    assert t.config_dict() == j.config_dict()
    np.testing.assert_array_equal(t.encode_fn()(torch.from_numpy(x[:50])).numpy(), want[:50])


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP, Metric.NIP])
def test_sq_flat_search_like_jax(data, bits, metric):
    x, q = data
    j, t = _sq_pair(x, bits)
    jidx = JaxFlat(j, SearchConfig(metric=metric)).fit(x)
    tidx = convert.flat_index_of(t, np.asarray(jidx.codes), np.asarray(jidx.norms),
                                 jidx.num_rows, convert.config_from_jax(jidx.search_cfg))
    wi, ws = jidx.search_with_scores(q, 10)
    gi, gs = tidx.search_with_scores(q, 10)
    assert_same_ranking(gi, wi, ws)
    assert_close_scores(gs, ws)
    assert tidx.memory_footprint() == jidx.memory_footprint()


def _lvq_pair(x, bits):
    j = JaxLVQ(LVQConfig(bits)).fit(x)
    t = convert.lvq_from_numpy(type(j.params)(*map(np.asarray, j.params)),
                               convert.config_from_jax(j.cfg), device="cpu")
    return j, t


@pytest.mark.parametrize("bits", [2, 5, 8])
def test_lvq_codes_and_decode_equal_jax(data, bits):
    x, _ = data
    j, t = _lvq_pair(x, bits)
    for src in (x, torch.from_numpy(x)):
        own = LVQ(convert.config_from_jax(j.cfg), device="cpu").fit(src)
        np.testing.assert_allclose(own.params.mean.numpy(), np.asarray(j.params.mean),
                                   rtol=1e-6, atol=1e-7)
    want = np.asarray(j.compress(x))
    got = t.compress(x, chunk=1000)  # three chunks: the row-chunked compress
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    rec_j = np.asarray(j.decompress(want))
    np.testing.assert_allclose(t.decompress(want).numpy(), rec_j, rtol=0,
                               atol=1e-6 * np.abs(rec_j).max())
    assert t.code_bytes_per_vector() == j.code_bytes_per_vector()


@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP, Metric.NIP])
def test_lvq_flat_search_like_jax(data, metric):
    x, q = data
    j, t = _lvq_pair(x, 4)
    jidx = JaxFlat(j, SearchConfig(metric=metric)).fit(x)
    tidx = convert.flat_index_of(t, np.asarray(jidx.codes), np.asarray(jidx.norms),
                                 jidx.num_rows, convert.config_from_jax(jidx.search_cfg))
    for k in (10, 100):
        wi, ws = jidx.search_with_scores(q, k)
        gi, gs = tidx.search_with_scores(q, k)
        assert_same_ranking(gi, wi, ws)
        assert_close_scores(gs, ws)
    assert tidx.memory_footprint() == jidx.memory_footprint()


def test_own_fits_search_and_round_trip(data, tmp_path):
    """The port's own fits: MSE as JAX's (the same fit), save/load."""
    x, q = data
    for cls, jcls, cfg in ((SQ, JaxSQ, SQConfig(8)), (LVQ, JaxLVQ, LVQConfig(8))):
        t = cls(convert.config_from_jax(cfg), device="cpu")
        idx = FlatQuantizedIndex(t).fit(x)
        j = jcls(cfg).fit(x)
        np.testing.assert_allclose(t.reconstruction_mse(x), j.reconstruction_mse(x), rtol=1e-4)
        path = str(tmp_path / f"{t.name}.pkl")
        idx.save(path)
        back = FlatQuantizedIndex(cls(convert.config_from_jax(cfg), device="cpu")).load(path)
        np.testing.assert_array_equal(back.search(q, 5), idx.search(q, 5))


def test_bad_widths_are_refused():
    with pytest.raises(ValueError):
        SQ(convert.config_from_jax(SQConfig(6)))
    with pytest.raises(ValueError):
        LVQ(convert.config_from_jax(LVQConfig(9)))
