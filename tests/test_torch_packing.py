"""The port's bit packing (core/packing.py) and tile-ordered words
(kernels/packed_scan.py::pack_words) against the JAX package's, on the
same numpy indices.  Row layout is part of the saved format, so bytes and
words must be identical, not close."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core import packing as jp
from vq_tpu.kernels import pallas_packed as jpp
from vq_tpu_torch.core import packing as tp
from vq_tpu_torch.kernels import packed_scan as tps

torch.set_num_threads(1)


@pytest.mark.parametrize("bits", range(1, 9))
def test_pack_bits_byte_identical(bits):
    rng = np.random.default_rng(bits)
    idx = rng.integers(0, 1 << bits, (13, 37))
    want = np.asarray(jp.pack_bits(jnp.asarray(idx), bits))
    got = tp.pack_bits(torch.from_numpy(idx), bits).numpy()
    assert got.dtype == np.uint8 and got.shape == (13, tp.packed_bytes(37, bits))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tp.unpack_bits(torch.from_numpy(got), bits, 37).numpy(), idx)


def test_f32_bytes_roundtrip_matches_jax():
    x = np.random.default_rng(0).standard_normal(17).astype(np.float32)
    want = np.asarray(jp.f32_to_bytes(jnp.asarray(x)))
    got = tp.f32_to_bytes(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tp.bytes_to_f32(torch.from_numpy(got)).numpy(), x)


# (bits, ln): dense widths, the 3-bit → 4 and 1-bit skinny → 2 widenings of
# choose_beff, a full-lane 1-bit segment, B = 8
@pytest.mark.parametrize("bits,ln", [(1, 14), (1, 128), (2, 20), (3, 37), (4, 64), (5, 9),
                                     (8, 5)])
def test_pack_words_byte_identical(bits, ln):
    beff = jpp.choose_beff(bits, ln)
    assert tps.choose_beff(bits, ln) == beff
    idx = np.random.default_rng(ln).integers(0, 1 << bits, (1024, ln))
    want = np.asarray(jpp.pack_words(jnp.asarray(idx), bits, beff, tile=512))
    got = tps.pack_words(torch.from_numpy(idx), bits, beff)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    seg = tps.make_segspec(bits, ln, "uniform", -1)
    assert tuple(seg) == tuple(jpp.make_segspec(bits, ln, "uniform", -1))
    np.testing.assert_array_equal(tps.unpack_words(got, seg).numpy(), idx)


def test_pack_words_refuses_partial_tiles():
    with pytest.raises(ValueError, match="multiple of tile"):
        tps.pack_words(torch.zeros((700, 4), dtype=torch.int64), 2)
