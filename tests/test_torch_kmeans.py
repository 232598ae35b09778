"""The port's kernels/kmeans.py against vq_tpu/kernels/kmeans.py on the CPU.

From the same centroids (made with numpy) one Lloyd step and the assignment
must agree: 1e-5 on centroids (f32 sums in another order), equal ids.  The
two packages' random numbers differ, so seeded fits are compared on
quality: MSE within 5% of the JAX package's.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core.config import KMeansConfig
from vq_tpu_torch._device import make_generator

# each package's kernels/__init__ exports a function named `kmeans`
jkm = importlib.import_module("vq_tpu.kernels.kmeans")
tkm = importlib.import_module("vq_tpu_torch.kernels.kmeans")

torch.set_num_threads(1)


def _blobs(n=1200, d=8, k=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * 4
    x = centers[rng.integers(0, k, n)] + rng.standard_normal((n, d)).astype(np.float32)
    c0 = x[rng.choice(n, k, replace=False)]
    return x.astype(np.float32), c0


def _mse(x, c):
    d2 = ((x[:, None, :] - c[None]) ** 2).sum(-1)
    return float(d2.min(1).mean())


def test_pairwise_sqdist_xc_matches_jax():
    x, c = _blobs()
    want = np.asarray(jkm.pairwise_sqdist_xc(jnp.asarray(x), jnp.asarray(c)))
    got = tkm.pairwise_sqdist_xc(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_lloyd_iter_matches_jax():
    x, c0 = _blobs()
    want = np.asarray(jkm._lloyd_iter(jnp.asarray(x), jnp.asarray(c0)))
    got = tkm._lloyd_iter(torch.from_numpy(x), torch.from_numpy(c0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lloyd_iter_batched_matches_vmap():
    xs = np.stack([_blobs(seed=s)[0] for s in (1, 2, 3)])
    cs = np.stack([_blobs(seed=s)[1] for s in (1, 2, 3)])
    want = np.asarray(jax.vmap(jkm._lloyd_iter)(jnp.asarray(xs), jnp.asarray(cs)))
    got = tkm._lloyd_iter(torch.from_numpy(xs), torch.from_numpy(cs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lloyd_iter_row_tiled_equals_untiled(monkeypatch):
    """Above the element budget the rows are tiled; partial sums over tiles
    give the same step (1e-5: another f32 summation order)."""
    xs = np.stack([_blobs(n=3000, seed=s)[0] for s in (4, 5)])
    cs = np.stack([_blobs(n=3000, seed=s)[1] for s in (4, 5)])
    whole = tkm._lloyd_iter(torch.from_numpy(xs), torch.from_numpy(cs))
    monkeypatch.setattr(tkm, "_TILE_ELEMS", 2 * 16 * 700)
    tiled = tkm._lloyd_iter(torch.from_numpy(xs), torch.from_numpy(cs))
    np.testing.assert_allclose(tiled.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)


def test_empty_cluster_keeps_centroid():
    x, c0 = _blobs()
    c0 = c0.copy()
    c0[3] = 1e3  # far from every row: no assignments
    got = tkm._lloyd_iter(torch.from_numpy(x), torch.from_numpy(c0)).numpy()
    np.testing.assert_array_equal(got[3], c0[3])
    want = np.asarray(jkm._lloyd_iter(jnp.asarray(x), jnp.asarray(c0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tile", [16384, 500])
def test_assign_matches_jax(tile):
    x, c = _blobs(seed=6)
    want = np.asarray(jkm.assign(jnp.asarray(x), jnp.asarray(c), tile=tile))
    got = tkm.assign(torch.from_numpy(x), torch.from_numpy(c), tile=tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_assign_batched_matches_jax():
    xs = np.stack([_blobs(seed=s)[0] for s in (7, 8)])
    cs = np.stack([_blobs(seed=s)[1] for s in (7, 8)])
    want = np.asarray(jkm.assign_batched(jnp.asarray(xs), jnp.asarray(cs), tile=512))
    got = tkm.assign_batched(torch.from_numpy(xs), torch.from_numpy(cs), tile=512)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kmeans_from_same_start_matches_jax():
    """c0 feeds both packages the same start: several Lloyd steps agree."""
    x, c0 = _blobs(seed=9)
    cfg = KMeansConfig(iters=5)
    c = jnp.asarray(c0)
    for _ in range(cfg.iters):
        c = jkm._lloyd_iter(jnp.asarray(x), c)
    got = tkm.kmeans(None, torch.from_numpy(x), 16, cfg, c0=torch.from_numpy(c0))
    np.testing.assert_allclose(got.numpy(), np.asarray(c), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("init", ["kmeanspp", "random"])
def test_kmeans_batched_quality_matches_jax(init):
    """Own seeding on both sides: MSE within 5% of the JAX package's."""
    xs = np.stack([_blobs(n=1500, seed=s)[0] for s in (10, 11, 12)])
    cfg = KMeansConfig(iters=10, init=init, max_points_per_centroid=64)
    cj = np.asarray(jkm.kmeans_batched(jax.random.PRNGKey(0), jnp.asarray(xs), 16, cfg))
    ct = tkm.kmeans_batched(make_generator(0, "cpu"), torch.from_numpy(xs), 16, cfg)
    assert ct.shape == (3, 16, 8)
    mse_j = np.mean([_mse(xs[i], cj[i]) for i in range(3)])
    mse_t = np.mean([_mse(xs[i], ct[i].numpy()) for i in range(3)])
    assert mse_t <= 1.05 * mse_j, (mse_t, mse_j)


def test_kmeanspp_init_picks_distinct_rows():
    x, _ = _blobs(seed=13)
    c = tkm._kmeanspp_init(make_generator(1, "cpu"), torch.from_numpy(x)[None], 16)[0]
    assert len({tuple(r) for r in c.numpy().round(6)}) == 16
    assert all((np.abs(x - r).sum(1) == 0).any() for r in c.numpy())


def _scatter_add_lloyd(x, c):
    """The old update (float scatter-add sums), kept here as the reference
    the fixed-order reduction must equal on the CPU."""
    a = torch.argmin(tkm.pairwise_sqdist_xc(x, c), dim=-1)
    sums = torch.zeros_like(c).scatter_add_(1, a[..., None].expand(-1, -1, x.shape[2]), x)
    counts = torch.zeros(c.shape[:2]).scatter_add_(1, a, torch.ones_like(a, dtype=torch.float32))
    new_c = sums / torch.clamp(counts, min=1.0)[..., None]
    return torch.where((counts > 0)[..., None], new_c, c)


@pytest.mark.parametrize("tile_elems", [None, 2 * 16 * 700])
def test_fixed_order_lloyd_equals_scatter_add_and_jax(monkeypatch, tile_elems):
    """The sorted segment sums against the scatter-add sums and JAX's
    one-hot product, from the same start (1e-5: another f32 summation
    order), whole and row-tiled; an empty cluster keeps its centroid."""
    xs = np.stack([_blobs(n=3000, seed=s)[0] for s in (14, 15)])
    cs = np.stack([_blobs(n=3000, seed=s)[1] for s in (14, 15)])
    cs[1, 4] = 1e3  # empty
    if tile_elems:
        monkeypatch.setattr(tkm, "_TILE_ELEMS", tile_elems)
    got = tkm._lloyd_iter(torch.from_numpy(xs), torch.from_numpy(cs))
    old = _scatter_add_lloyd(torch.from_numpy(xs), torch.from_numpy(cs))
    want = np.asarray(jax.vmap(jkm._lloyd_iter)(jnp.asarray(xs), jnp.asarray(cs)))
    np.testing.assert_allclose(got.numpy(), old.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1, 4].numpy(), cs[1, 4])


def test_fit_is_deterministic():
    """Two fits from one seed give the same centroids bit for bit (the card
    holds the same in chip_smoke.py)."""
    xs = torch.from_numpy(np.stack([_blobs(n=2000, seed=s)[0] for s in (16, 17)]))
    cfg = KMeansConfig(iters=4, max_points_per_centroid=64)
    a = tkm.kmeans_batched(make_generator(3, "cpu"), xs, 16, cfg)
    b = tkm.kmeans_batched(make_generator(3, "cpu"), xs, 16, cfg)
    assert torch.equal(a, b)
