"""The port's own configs (``vq_tpu_torch/core/config.py``) and native
allocators (``vq_tpu_torch/native``) against the JAX package's.

* Every config class has the JAX class's name, fields, defaults and field
  order; ``Metric`` has the same members and values.
* ``convert.config_from_jax`` turns a JAX config into the port's class of
  the same name, nested ``kmeans`` and ``Metric`` included, and round-trips
  through ``asdict``.
* The native greedy and DP allocators and ``codebook_exact`` return exactly
  the JAX package's results on seeded inputs (the same C++ source, the same
  seeded subsample); the port's library is built under ``vq_tpu_torch/_build``
  and, without a compiler, every entry point returns None.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from vq_tpu import native as jnative
from vq_tpu.core import config as jcfg
from vq_tpu_torch import convert
from vq_tpu_torch import native as tnative
from vq_tpu_torch.core import config as tcfg
from vq_tpu_torch.methods import saq as tsaq

CLASSES = ["KMeansConfig", "PQConfig", "OPQConfig", "SQConfig", "RaBitQConfig", "SAQConfig",
           "LVQConfig", "RankAwareConfig", "IVFConfig", "SearchConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_config_class_matches_jax_field_for_field(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    jf, tf = dataclasses.fields(j), dataclasses.fields(t)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert tcfg.asdict(t()) == jcfg.asdict(j())  # defaults, nested ones too
    assert t.__dataclass_params__.frozen == j.__dataclass_params__.frozen
    hash(t())


def test_metric_members_and_values_match_jax():
    assert [(m.name, m.value) for m in tcfg.Metric] == [(m.name, m.value) for m in jcfg.Metric]
    for m in jcfg.Metric:
        assert tcfg.Metric(m.value) == m and tcfg.Metric(m) is tcfg.Metric[m.name]


@pytest.mark.parametrize("cfg", [
    jcfg.KMeansConfig(iters=3, seed=5, init="random"),
    jcfg.PQConfig(num_subquantizers=16, num_bits=6, kmeans=jcfg.KMeansConfig(iters=7)),
    jcfg.SAQConfig(bits_per_dim=2.0, codebook="lloyd", use_pca=False),
    jcfg.RaBitQConfig(num_bits=6, seed=3),
    jcfg.IVFConfig(num_clusters=4096, nprobe=50,
                   kmeans=jcfg.KMeansConfig(iters=10, max_points_per_centroid=64)),
    jcfg.SearchConfig(metric=jcfg.Metric.NIP, k=100, use_bf16=False),
], ids=lambda c: type(c).__name__)
def test_config_from_jax_round_trips(cfg):
    got = convert.config_from_jax(cfg)
    assert type(got) is getattr(tcfg, type(cfg).__name__)
    assert tcfg.asdict(got) == jcfg.asdict(cfg)
    for f in dataclasses.fields(got):
        v = getattr(got, f.name)
        assert not type(v).__module__.startswith("vq_tpu."), (f.name, type(v))
    assert convert.config_from_jax(got) == got  # a port config converts to itself


def test_config_from_jax_refuses_other_objects():
    with pytest.raises(TypeError):
        convert.config_from_jax(object())


def _alloc_cases(seed, n=8):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        nb, mb = int(rng.integers(1, 8)), int(rng.integers(3, 9))
        mse = np.sort(rng.uniform(0.01, 50, (nb, mb + 1)), axis=1)[:, ::-1].copy()
        lens = rng.integers(2, 64, nb)
        yield mse, lens, int(rng.integers(1, mb * lens.sum())), mb


@pytest.mark.parametrize("fn", ["allocate_greedy_native", "allocate_dp_native"])
def test_native_allocators_equal_jax(fn):
    assert tnative.available() and jnative.available()
    for mse, lens, budget, mb in _alloc_cases(seed=len(fn)):
        np.testing.assert_array_equal(getattr(tnative, fn)(mse, lens, budget, mb),
                                      getattr(jnative, fn)(mse, lens, budget, mb))


@pytest.mark.parametrize("levels,n,cap", [(4, 3000, 65536), (16, 20000, 5000)])
def test_codebook_exact_equals_jax(levels, n, cap):
    """Same sorted (and, past the cap, the same seeded) sample, same DP."""
    rng = np.random.default_rng(levels)
    x = np.concatenate([rng.normal(-3, 0.2, n), rng.normal(0, 1.0, n),
                        rng.normal(5, 0.5, n)]).astype(np.float32)
    got = tnative.codebook_exact(x, levels, sample_cap=cap, seed=3)
    np.testing.assert_array_equal(got, jnative.codebook_exact(x, levels, sample_cap=cap,
                                                              seed=3))
    assert got.dtype == np.float32 and (np.diff(got) >= 0).all()


def test_native_library_lives_in_the_build_dir():
    lib = Path(tnative._load()._name)
    assert lib.parent == tnative.BUILD_DIR and lib.name.startswith("libvq_native_")
    assert not list(Path(tnative.__file__).parent.glob("*.so"))


def test_without_a_compiler_the_numpy_fallbacks_run(monkeypatch):
    """No g++: every native entry point returns None and SAQ's callers run
    the port's NumPy allocator and its own Lloyd."""
    def no_compiler():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(tnative, "_build", no_compiler)
    tnative._load.cache_clear()
    try:
        assert not tnative.available()
        mse, lens, budget, mb = next(_alloc_cases(seed=9))
        assert tnative.allocate_greedy_native(mse, lens, budget, mb) is None
        assert tnative.allocate_dp_native(mse, lens, budget, mb) is None
        col = np.random.default_rng(0).standard_normal(4000).astype(np.float32)
        assert tnative.codebook_exact(col, 8) is None
        levels = tsaq._codebook_exact(col, 8, sample_cap=65536, seed=0)
        assert levels.shape == (8,) and (np.diff(levels) >= 0).all()
    finally:
        tnative._load.cache_clear()
