"""The port's CAQ encoder (kernels/caq.py) and 1-D Lloyd codebooks
(kernels/lloyd1d.py) against the JAX package's, on the same numpy input.

CAQ's adjustment rounds accept a ±1 move when its gain, a difference of two
nearly equal f32 products, is positive; sums in another order flip moves
whose gain is at rounding level, and the rounds then take another path.
So: from equal codes, one round may differ only in moves whose exact
(float64) gain is a near-tie.  After all rounds, codes are equal on ≥ 95%
of rows at B ≤ 4; at B = 8 (255 levels, many near-ties) paths part more
often, so the cosine (the objective) is compared: per row within 1e-4
relative at B ≤ 4 and 1e-3 at B = 8, on average within 1e-5.  rescale and
o_l2norm of equal-code rows agree to 2e-6 relative (f32 sums of D terms);
fac_error is compared through its cosine term (o_l2sqr·l2/ip² − 1, a
difference of nearly equal numbers) to 2e-6 absolute plus 4e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.kernels import caq as jcaq
from vq_tpu.kernels import lloyd1d as jl
from vq_tpu_torch.kernels import caq as tcaq
from vq_tpu_torch.kernels import lloyd1d as tl

torch.set_num_threads(1)


def _cos(o, v):
    return np.sum(o * v, 1) / np.linalg.norm(o, axis=1) / np.linalg.norm(v, axis=1)


def _levels(rng, d, bits):
    return np.sort(rng.standard_normal((d, 1 << bits)).astype(np.float32), axis=1)


def _encode_both(o, bits, levels, rounds=6):
    if levels is None:
        return (jcaq.caq_encode(jnp.asarray(o), bits, rounds=rounds),
                tcaq.caq_encode(torch.from_numpy(o), bits, rounds=rounds))
    return (jcaq.caq_encode_levels(jnp.asarray(o), jnp.asarray(levels), rounds=rounds),
            tcaq.caq_encode_levels(torch.from_numpy(o), torch.from_numpy(levels), rounds=rounds))


def _values(codes, bits, levels):
    if levels is None:
        return (codes + 0.5) * 2.0 / (1 << bits) - 1.0
    return levels[np.arange(levels.shape[0]), codes]


@pytest.mark.parametrize("grid", ["uniform", "levels"])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_caq_encode_matches_jax(grid, bits):
    rng = np.random.default_rng(bits)
    o = rng.standard_normal((400, 64)).astype(np.float32)
    levels = _levels(rng, 64, bits) if grid == "levels" else None
    j, t = _encode_both(o, bits, levels)
    jc, tc = np.asarray(j.codes), t.codes.numpy()
    same = (jc == tc).all(axis=1)
    if bits <= 4:
        assert same.mean() >= 0.95, same.mean()
    cj, ct = _cos(o, _values(jc, bits, levels)), _cos(o, _values(tc, bits, levels))
    assert np.max(np.abs(cj - ct) / cj) <= (1e-4 if bits <= 4 else 1e-3)
    assert abs(ct.mean() - cj.mean()) <= 1e-5 * cj.mean()
    for name in ("rescale", "o_l2norm"):
        want = np.asarray(getattr(j, name))[same]
        np.testing.assert_allclose(getattr(t, name).numpy()[same], want, rtol=2e-6)
    o2 = np.sum(o.astype(np.float64) ** 2, axis=1)[same]

    def cos_term(fac):
        return (np.asarray(fac, np.float64)[same] / (o2 * tcaq._CONST_EPSILON)) ** 2 * 63

    np.testing.assert_allclose(cos_term(t.fac_error.numpy()), cos_term(j.fac_error),
                               rtol=4e-6, atol=2e-6)
    dec = tcaq.caq_decode(t.codes, t.rescale, bits) if levels is None else \
        tcaq.caq_decode_levels(t.codes, t.rescale, torch.from_numpy(levels))
    want = (jcaq.caq_decode(j.codes, j.rescale, bits) if levels is None else
            jcaq.caq_decode_levels(j.codes, j.rescale, jnp.asarray(levels)))
    np.testing.assert_allclose(dec.numpy()[same], np.asarray(want)[same], rtol=2e-6,
                               atol=1e-6)


@pytest.mark.parametrize("grid", ["uniform", "levels"])
def test_one_round_differs_only_at_near_ties(grid):
    """From the (equal) initial codes, a move one package takes and the other
    does not has an exact gain within rounding of zero."""
    bits = 4
    rng = np.random.default_rng(7)
    o = rng.standard_normal((400, 64)).astype(np.float32)
    levels = _levels(rng, 64, bits) if grid == "levels" else None
    j0, t0 = _encode_both(o, bits, levels, rounds=0)
    np.testing.assert_array_equal(t0.codes.numpy(), np.asarray(j0.codes))
    j1, t1 = _encode_both(o, bits, levels, rounds=1)
    jc, tc, c0 = np.asarray(j1.codes), t1.codes.numpy(), np.asarray(j0.codes)
    ou = o / np.abs(o).max(axis=1, keepdims=True) if levels is None else o
    cmax = (1 << bits) - 1
    for r in np.where(~(jc == tc).all(axis=1))[0]:
        x = ou[r].astype(np.float64)
        grid_vals = (levels.astype(np.float64) if levels is not None else
                     np.tile((np.arange(cmax + 1) + 0.5) * 2.0 / (cmax + 1) - 1.0, (64, 1)))
        cur = grid_vals[np.arange(64), c0[r]]
        ip, l2 = x @ cur, cur @ cur
        for col in np.where(jc[r] != tc[r])[0]:
            for step in (1, -1):
                c = int(np.clip(c0[r, col] + step, 0, cmax))
                v = grid_vals[col, c]
                nip, nl2 = ip - x[col] * cur[col] + x[col] * v, l2 - cur[col] ** 2 + v * v
                gain = nip * nip * l2 - ip * ip * nl2
                if c in (jc[r, col], tc[r, col]) and c != c0[r, col]:
                    assert abs(gain) <= 1e-5 * ip * ip * nl2, (r, col, gain)


def test_lloyd_matches_jax():
    """Lloyd's arithmetic is sums of sorted samples: levels agree to 1e-5."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3000, 6)).astype(np.float32) * np.linspace(0.5, 3, 6)
    want = np.asarray(jl.lloyd_1d_columns(jnp.asarray(x), 8))
    got = tl.lloyd_1d_columns(torch.from_numpy(x), 8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    col = x[:, 2]
    np.testing.assert_allclose(tl.lloyd_1d(torch.from_numpy(col), 16).numpy(),
                               np.asarray(jl.lloyd_1d(jnp.asarray(col), 16)), rtol=1e-5,
                               atol=1e-5)


def test_quantize_to_levels_matches_jax():
    rng = np.random.default_rng(4)
    lv = np.sort(rng.standard_normal((5, 8)).astype(np.float32), axis=1)
    x = rng.standard_normal((300, 5)).astype(np.float32)
    x[0] = 0.5 * (lv[:, 1] + lv[:, 2])  # exactly on a boundary: side "left"
    np.testing.assert_array_equal(tl.quantize_to_levels(torch.from_numpy(x[:, 0]),
                                                        torch.from_numpy(lv[0])).numpy(),
                                  np.asarray(jl.quantize_to_levels(jnp.asarray(x[:, 0]),
                                                                   jnp.asarray(lv[0]))))
    np.testing.assert_array_equal(
        tl.quantize_to_levels_per_dim(torch.from_numpy(x), torch.from_numpy(lv)).numpy(),
        np.asarray(jl.quantize_to_levels_per_dim(jnp.asarray(x), jnp.asarray(lv))))


@pytest.mark.parametrize("levels", [2, 4, 64])
def test_lloyd_normal_quality_matches_jax(levels):
    """Different generators, so compared on quality: the N(0,1) quantizer's
    MSE on a fresh sample within 1% of JAX's; sorted levels."""
    got = tl.lloyd_1d_normal(levels, seed=0, device="cpu").numpy()
    want = np.asarray(jl.lloyd_1d_normal(levels, seed=0))
    z = np.random.default_rng(9).standard_normal(100_000).astype(np.float32)

    def mse(lv):
        return float(np.mean((z - lv[np.abs(z[:, None] - lv[None]).argmin(1)]) ** 2))

    assert mse(got) <= 1.01 * mse(want), (mse(got), mse(want))
    assert (np.diff(got) >= 0).all()


@pytest.mark.parametrize("bits", [1, 3, 8])
def test_caq_cosine_matches_jax(bits):
    """cos(o, ô) of the same codes, within 1e-6 (f32 sums in another order);
    the adjusted codes' cosine is at least the rounded codes'."""
    rng = np.random.default_rng(bits)
    o = rng.standard_normal((300, 48)).astype(np.float32)
    o[0] = 0.0  # a zero row: the clamp keeps it finite
    codes = rng.integers(0, 1 << bits, (300, 48)).astype(np.int32)
    want = np.asarray(jcaq.caq_cosine(jnp.asarray(o), jnp.asarray(codes), bits))
    got = tcaq.caq_cosine(torch.from_numpy(o), torch.from_numpy(codes), bits)
    assert got.shape == (300,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    ou = torch.from_numpy(o[1:] / np.abs(o[1:]).max(axis=1, keepdims=True))
    base = tcaq.caq_encode(ou, bits, rounds=0)
    adj = tcaq.caq_encode(ou, bits, rounds=6)
    assert bool((tcaq.caq_cosine(ou, adj.codes, bits)
                 >= tcaq.caq_cosine(ou, base.codes, bits) - 1e-6).all())
