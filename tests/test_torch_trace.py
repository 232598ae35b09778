"""The port's spans (``vq_tpu_torch/utils/trace.py``) on the CPU: nesting
and each request's record, the bound on kept records, a span closed by an
exception, threads, the profiler's view of the spans, the records the two
indexes' searches leave, and the benchmark's two readers of them
(``vqbench/layer_metrics/search.{host,wait}_ms.py``).

``pq.scan`` is not seen here: on the CPU the PQ scan never calls the hand
kernels' wrappers, where that span sits.
"""

import importlib.util
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vq_tpu_torch import IVFConfig, KMeansConfig, PQConfig, SAQConfig
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.index.ivf_packed import IvfPackedFlatIndex
from vq_tpu_torch.methods.pq import PQ
from vq_tpu_torch.methods.saq import SAQ
from vq_tpu_torch.utils import trace
from vq_tpu_torch.utils.trace import span

REPO = Path(__file__).resolve().parents[1]
READERS = ["search.host_ms", "search.wait_ms"]


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture
def clock(monkeypatch):
    """The host clock as a counter: each reading 1 µs after the last."""
    ticks = iter(range(1_000, 10**12, 1_000))
    monkeypatch.setattr(trace.time, "perf_counter_ns", lambda: next(ticks))


def test_spans_nest_and_sum_into_the_root_record(clock):
    with span("r"):
        with span("a"):
            pass
        with span("a"):
            pass
        with span("b"):
            with span("c"):
                pass
    (rec,) = trace.recent("r", 10)
    # r 1→10, a 2→3 and 4→5, b 6→9, c 7→8 (µs)
    assert rec == pytest.approx({"r": 9e-6, "a": 2e-6, "b": 3e-6, "c": 1e-6}, rel=1e-12)
    assert trace._thread.ns is None


def test_each_root_closes_its_own_record(clock):
    for _ in range(3):
        with span("r"):
            with span("a"):
                pass
    recs = trace.recent("r", 10)
    assert len(recs) == 3
    assert all(r == pytest.approx({"r": 3e-6, "a": 1e-6}, rel=1e-12) for r in recs)


def test_the_record_deque_is_bounded():
    for _ in range(10):
        with span("old"):
            pass
    for _ in range(trace.KEEP):
        with span("new"):
            pass
    assert trace.recent("old", 10) == []
    assert len(trace.recent("new", 10 * trace.KEEP)) == trace.KEEP
    assert len(trace.recent("new", 5)) == 5
    assert trace.recent("new", 0) == []


def test_recent_returns_the_newest_records_oldest_first(monkeypatch):
    ticks = iter(range(1_000, 10**12, 1_000))
    monkeypatch.setattr(trace.time, "perf_counter_ns", lambda: next(ticks))
    for i in range(5):
        with span("r"):
            for _ in range(i):  # i children: the root's record grows with i
                with span("a"):
                    pass
    recs = trace.recent("r", 2)
    assert [r.get("a", 0.0) for r in recs] == pytest.approx([3e-6, 4e-6], rel=1e-12)


def test_a_span_closed_by_an_exception_leaves_the_stack_sound():
    with pytest.raises(ValueError):
        with span("r"):
            with span("a"):
                raise ValueError("boom")
    assert trace._thread.ns is None
    (rec,) = trace.recent("r", 10)
    assert set(rec) == {"r", "a"}
    with span("s"):
        pass
    (rec,) = trace.recent("s", 10)
    assert set(rec) == {"s"}


def test_one_threads_spans_never_land_in_anothers_record():
    threads, per_thread = 16, 10
    start = threading.Barrier(threads)

    def work(i):
        start.wait(timeout=30)
        for _ in range(per_thread):
            with span("t"):
                for _ in range(3):
                    with span(f"c{i}"):
                        with span(f"d{i}"):
                            pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    recs = trace.recent("t", trace.KEEP)
    assert len(recs) == threads * per_thread
    owners = []
    for rec in recs:
        (child,) = [name for name in rec if name.startswith("c")]
        i = child[1:]
        assert set(rec) == {"t", f"c{i}", f"d{i}"}
        owners.append(i)
    assert sorted(set(owners), key=int) == [str(i) for i in range(threads)]


def test_under_the_profiler_each_span_is_a_plain_cpu_event():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            with span("inner"):
                torch.ones(4) + 1
    ev = {e.name: e for e in prof.events() if e.name in ("outer", "inner")}
    assert set(ev) == {"outer", "inner"}
    for e in ev.values():
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation
        assert e.time_range.end > e.time_range.start
    assert ev["inner"].cpu_parent is not None and ev["inner"].cpu_parent.name == "outer"
    assert ev["outer"].cpu_parent is None
    # a root the profiler traced keeps no record: the trace holds it
    assert trace.recent("outer", 10) == []


def test_without_a_profiler_no_event_is_made_and_the_record_is_kept(monkeypatch):
    made = []

    def record_function_fast(name):
        made.append(name)
        raise AssertionError("a profiler range opened with no profiler on")

    monkeypatch.setattr(trace, "_RecordFunctionFast", record_function_fast)
    with span("outer"):
        with span("inner"):
            torch.ones(4) + 1
    assert made == []
    (rec,) = trace.recent("outer", 10)
    assert set(rec) == {"outer", "inner"} and rec["outer"] >= rec["inner"] > 0


def _data(n=2048, d=32, nq=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g)
    return x, x[:nq] + 0.05 * torch.randn((nq, d), generator=g)


def test_a_flat_search_leaves_one_search_record():
    x, q = _data()
    pq = PQ(PQConfig(4, 4, KMeansConfig(iters=3)), seed=0, device="cpu")
    index = FlatQuantizedIndex(pq).fit(x)
    trace.reset()
    ids, _ = index.search_with_scores(q, k=5)
    assert ids.shape == (8, 5)
    (rec,) = trace.recent("search", 10)
    assert set(rec) == {"search", "search.fetch"}
    assert rec["search"] >= rec["search.fetch"] > 0


@pytest.mark.parametrize("groups", [1, 2])
def test_an_ivf_packed_search_leaves_one_record_of_its_stages(groups):
    x, q = _data()
    index = IvfPackedFlatIndex(SAQ(SAQConfig(bits_per_dim=2.0, block_dims=16), device="cpu"),
                               IVFConfig(num_clusters=8, nprobe=2, kmeans=KMeansConfig(iters=3)),
                               query_groups=groups).fit(x)
    trace.reset()
    ids, _ = index.search_with_scores(q, k=5)
    assert ids.shape == (8, 5)
    (rec,) = trace.recent("search", 10)
    assert set(rec) == {"search", "ivf.route", "ivf.mask", "packed.scan", "ivf.finalize",
                        "search.fetch"}
    assert all(v > 0 for v in rec.values())
    inner = sum(v for name, v in rec.items() if name != "search")
    assert rec["search"] >= inner


def _reader(name):
    path = REPO / "vqbench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _feed(records):
    for search_ms, fetch_ms in records:
        trace._records.append(("search", {"search": round(search_ms * 1e6),
                                          "search.fetch": round(fetch_ms * 1e6)}))


@pytest.mark.parametrize("name", READERS)
def test_a_reader_takes_the_median_of_the_newest_64_records(name):
    # 36 old records far off, then 64 of fetch 10 + i and host 1 + i / 100
    _feed([(1e3, 5e2)] * 36)
    _feed([(11 + i + i / 100, 10 + i) for i in range(64)])
    _feed([(1e3, 5e2)] * 3)
    trace._records.append(("other", {"other": 10**9}))
    # the newest 64 of root "search": 61 of the ramp, then the 3 far off
    ramp = [(11 + i + i / 100, 10 + i) for i in range(3, 64)] + [(1e3, 5e2)] * 3
    if name == "search.host_ms":
        want = float(np.median([s - f for s, f in ramp]))
    else:
        want = float(np.median([f for _, f in ramp]))
    assert _reader(name).read(None) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_none_below_16_records(name):
    reader = _reader(name)
    assert reader.read(None) is None
    _feed([(3.0, 2.0)] * 15)
    trace._records.append(("search", {"search": 10**6}))  # no fetch: not counted
    assert reader.read(None) is None
    _feed([(3.0, 2.0)])
    assert reader.read(None) == pytest.approx(1.0 if name == "search.host_ms" else 2.0)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_none_from_a_program_without_spans(name, monkeypatch):
    _feed([(3.0, 2.0)] * 32)
    monkeypatch.setitem(sys.modules, "vq_tpu_torch.utils.trace", None)
    assert _reader(name).read(None) is None
