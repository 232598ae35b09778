"""The yardstick's arithmetic: the bounds PERF.md §6 states, the traffic
generator, the profiler reduction."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from vqbench import generator, tracing
from vqbench.costs import packed_scan, pq_scan


def test_pq_bound_is_perf_md_s_pq192_gate_bound():
    # N=100k, Q=1024, M=192 (dsub 8, K=256), k=10, bf16: 0.3181 ms (decode route)
    assert round(pq_scan.bound_s(q=1024, n=100_000, m=192, kk=256, dsub=8, k=10) * 1e3,
                 4) == 0.3181
    # M=16 (dsub 96): 0.0497 ms (table route)
    assert round(pq_scan.bound_s(q=1024, n=100_000, m=16, kk=256, dsub=96, k=10) * 1e3,
                 4) == 0.0497


def test_packed_bound_is_perf_md_s_saq_bound():
    # chip_smoke.py phase 6: N=100k, Q=256, k=10, SAQ bpd=2 with PCA coded over
    # lens (64, 256, 448, 64) at bits (5, 3, 2, 1): every query scans every row
    lens, bits = (64, 256, 448, 64), (5, 3, 2, 1)
    b = packed_scan.bound_s(q=256, rows_per_query_sum=256 * 100_000, union_rows=100_000,
                            coded_dims=sum(lens),
                            code_bits=sum(ln * bt for ln, bt in zip(lens, bits)),
                            factors_per_row=8, k=10)
    assert round(b * 1e3, 4) == 0.0431


def test_generator_sends_every_query_equally_often_in_a_seeded_order():
    mix = {"batch": 48, "loop": "closed", "passes": 6}
    a, b = generator.stream(1024, mix, 2**31 + 5), generator.stream(1024, mix, 2**31 + 5)
    c = generator.stream(1024, mix, 2**31 + 6)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # batches run on across passes: a whole number of them, every pass a permutation
    assert len(a) == 6 * 1024 - (6 * 1024) % 48
    for p in range(5):
        assert np.array_equal(np.sort(a[p * 1024:(p + 1) * 1024]), np.arange(1024))
    counts = np.bincount(a, minlength=1024)
    assert counts.max() - counts.min() <= 1
    got = generator.batches(1024, mix, 2**31 + 5, 200)
    assert {len(x) for x in got} == {48} and np.array_equal(np.concatenate(got[:128]), a)
    assert np.array_equal(got[128], a[:48])  # a window that outruns the stream starts over
    with pytest.raises(ValueError):
        generator.stream(1000, {**mix, "loop": "open"}, 1)


def _event(start, end, name, cuda):
    return types.SimpleNamespace(
        time_range=types.SimpleNamespace(start=start, end=end), name=name,
        device_type=torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU)


def test_trace_reduction_counts_busy_time_once_and_names_gaps():
    ev = [_event(0, 100, "k1", True), _event(50, 150, "k2", True),
          _event(400, 500, "Memcpy DtoH", True), _event(140, 420, "aten::sum", False),
          _event(100, 1000, "search", False)]
    r = tracing.reduce(ev, window_s=1e-3, batches=2)
    assert r["busy_s"] == pytest.approx(250e-6)
    assert r["kernels"] == 2
    assert r["idle_gaps"] == [["aten::sum", pytest.approx(250e-6)]]
    assert r["device_ops"][0][0] in ("k1", "k2", "Memcpy DtoH")
