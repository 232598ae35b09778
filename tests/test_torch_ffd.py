"""The port's core/ffd.py against vq_tpu/core/ffd.py on the CPU.

Layouts and bytes are integer work on the same inputs, so everything here
is exact: the FFD layout field for field, the packed bytes byte for byte,
the unpacked codes value for value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core import ffd as jffd
from vq_tpu_torch.core import ffd as tffd

torch.set_num_threads(1)

WIDTHS = {
    "mixed": np.array([8, 7, 6, 5, 4, 4, 3, 3, 3, 2, 2, 1, 1, 1, 0, 0, 5, 4, 3, 2, 1]),
    "lone four": np.array([3, 3, 4, 3, 3, 2, 2, 1]),
    "uniform 2": np.full(37, 2),
    "zeros and ones": np.array([0, 1, 0, 1, 1, 0, 0, 1]),
    "falling (rank-aware)": np.repeat([6, 5, 4, 3, 2, 1, 0], [3, 5, 8, 13, 21, 34, 4]),
}


def _codes(bits, n=300, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 1 << int(b), n) if b else np.zeros(n, np.int64)
                     for b in bits], axis=1).astype(np.int32)


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_ffd_layout_equals_jax(name):
    bits = WIDTHS[name]
    got, want = tffd.ffd_layout(bits), jffd.ffd_layout(bits)
    assert got.n_bytes == want.n_bytes
    for field in ("bits", "byte_idx", "shift"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_ffd_bytes_and_codes_equal_jax(name):
    bits = WIDTHS[name]
    codes = _codes(bits)
    layout = tffd.ffd_layout(bits)
    want = np.asarray(jffd.ffd_encode(jnp.asarray(codes), jffd.ffd_layout(bits)))
    got = tffd.ffd_encode(torch.from_numpy(codes), layout)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    back = tffd.ffd_decode_codes(got, layout)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jffd.ffd_decode_codes(jnp.asarray(want), jffd.ffd_layout(bits))))


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_dense_bytes_and_codes_equal_jax(name):
    bits = WIDTHS[name]
    codes = _codes(bits, seed=1)
    want = np.asarray(jffd.dense_encode(jnp.asarray(codes), bits))
    got = tffd.dense_encode(torch.from_numpy(codes), bits)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    back = tffd.dense_decode_codes(got, bits)
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jffd.dense_decode_codes(jnp.asarray(want), bits)))


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_dense_layout_cols_equal_jax(name):
    bits = WIDTHS[name]
    for got, want in zip(tffd.dense_layout_cols(bits), jffd.dense_layout_cols(bits)):
        np.testing.assert_array_equal(got, want)


def test_ffd_layout_rejects_wide_fields():
    with pytest.raises(ValueError):
        tffd.ffd_layout(np.array([9, 1]))
