"""Rehearse chip_smoke.py's phases on the CPU at tiny sizes.

On the CPU the port's wrappers run their plain versions, so this checks the
script's control flow, shapes and checks, not the kernels: launch counters
stay 0 (their check is stubbed), the card's clock calls are stubbed, the
profile of phase 4 is skipped, and the quality floors, set for the
full-size data on the card, are lowered.
The kernels themselves are checked on the card by the script itself.
"""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from vq_tpu_torch.kernels import packed_scan as pk  # noqa: E402
from vq_tpu_torch.kernels import pq_scan as ps  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def cpu_smoke(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)

    def host_ms(torch_, fn, reps=5, warmup=2):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(cs, "cuda_ms", host_ms)
    monkeypatch.setattr(cs, "require_launched", lambda counts, what: None)
    monkeypatch.setattr(cs, "require_launches", lambda got, want, what: None)
    monkeypatch.setattr(cs, "BF16_MIN_RECALL", 0.9)
    monkeypatch.setattr(cs, "RECALL_GATE_PQ192_FLOOR", 0.5)
    return torch.device("cpu")


def test_phase_kernels_rehearsal(cpu_smoke):
    cs.phase_kernel_edges(torch, cpu_smoke, nq=37, n=6000)
    results = {}
    cs.phase_kernels(torch, cpu_smoke, results, n=1500, d=384, nq=16)
    for name in ("pq_scan_topk_fused", "pq_score_all"):
        assert set(results[name]["times"]) == {"M=16 dsub=24", "M=192 dsub=2"}


def test_phase_decode_edges_rehearsal(cpu_smoke):
    """Phase 3's decode-route edge cases (Q = 1, 7, 65; M=25 with dsub 3
    and 8; K=100; N=77; M=300; k = 1, 10, 128; limit < k; ties)."""
    cs.phase_decode_edges(torch, cpu_smoke)


def test_phase_main_and_gate_rehearsal(cpu_smoke):
    # profile=False: torch.profiler records no device time on the CPU
    launches, ctx = cs.phase_main(torch, cpu_smoke, n=1500, d=32, nq=8, profile=False)
    assert set(launches) == {"pq_scan_topk_fused", "pq_score_all"}
    x = cs.remake(torch, ctx["maker"], cpu_smoke)[0]  # phases 13 and 16 remake it
    assert x.shape == (1500, 32) and torch.equal(x, cs.remake(torch, ctx["maker"], cpu_smoke)[0])
    cs.phase_gate(torch, cpu_smoke, n=400, d=192, nq=8)


def test_phase_packed_kernels_rehearsal(cpu_smoke):
    """Phase 6 at D=128, where SAQ lloyd has no value-plane segment (the
    script requires every dequant kind to launch only on the card); the
    fifth configuration is RankAware, and its FFD packing runs once."""
    results = {}
    cs.phase_packed_kernels(torch, cpu_smoke, results, n=3000, d=128, nq=8)
    times = results["packed_scan_topk"]["times"]
    assert len(times) == 5 and list(times)[-1].startswith("RankAware lloyd bpd=2 segments")


def test_phase_packed_edges_rehearsal(cpu_smoke):
    """Phase 6's edge cases with enough queries for Q = 65 (bf16: Q = 1, 7,
    65, k = 1 and 128, N = 300, segment lengths 40, 21, 9 and 7)."""
    x, q, _ = cs.packed_corpus(torch, 3000, 128, 70, seed=3, dev=cpu_smoke)
    _, _, _, m, packed = cs.packed_configs(torch, x, q, torch.linalg.norm(x, dim=1))[0]
    cs.phase_packed_edges(torch, cpu_smoke, q, m, packed, m.compress(x))


def test_synthetic_packed_segments_are_not_multiples_of_16():
    a = cs.synthetic_packed(torch, torch.device("cpu"), 1000, 5, seed=1)
    assert [s.ln for s in a["segs"]] == [40, 21, 9, 7]
    assert a["q_cat"].shape == (5, 77) and a["factors"].shape == (6, 1024)
    assert [s.dequant for s in a["segs"]] == ["uniform", "perdim", "shared", "values"]


def test_phase_packed_paths_rehearsal(cpu_smoke):
    assert cs.phase_saq_main(torch, cpu_smoke, n=4000, d=128, nq=8, profile=False)[0] == 0
    assert cs.phase_rabitq_main(torch, cpu_smoke, n=4000, d=128, nq=8) == 0


def test_phase_gather_kernels_rehearsal(cpu_smoke):
    """Phase 9 at N=3000 (6 tiles, the last partial), D=128."""
    results = {}
    cs.phase_gather_kernels(torch, cpu_smoke, results, n=3000, d=128, nq=8)
    want = {"25% random", "all", "RankAware 25% random", "RankAware all"}
    assert set(results["packed_scan_topk_gather"]["times"]) == want
    assert set(results["packed_scan_topk_gather"]["bounds"]) == want
    assert next(iter(results["packed_scan_topk_gather"]["times"])) == "25% random"


def test_phase_ivf_main_rehearsal(cpu_smoke, monkeypatch):
    """Phase 10 at N=6000, D=64, K=32 (nprobe 2 and 8, the full probe 32);
    its stage timings run, the profiler (no device time here) and phase
    12's host split (the card's allocator statistics) do not.  Then phase
    12 on its corpus and coarse pass (PQ M=16 for M=192, which needs
    D=1536)."""
    monkeypatch.setattr(cs, "profile_search", lambda *a, **k: None)
    monkeypatch.setattr(cs, "union_host_split", lambda *a, **k: None)
    launches, ctx = cs.phase_ivf_main(torch, cpu_smoke, n=6000, d=64, nq=16, k_cl=32,
                                      nprobes=(2, 8), nq_small=4)
    assert launches == 0 and ctx["x"].shape == (6000, 64) and ctx["cents"].shape == (32, 64)
    assert cs.phase_ivf_residual(torch, cpu_smoke, ctx, k_cl=32, nprobes=(2, 8), nq_small=4,
                                 pq_m=16) == 0


def test_phase_sharded_rehearsal(cpu_smoke, monkeypatch):
    """Phase 13 on a mesh of 4 CPU shards, on phases 4, 7, 10 and 12 run at
    tiny sizes (N=2002 PQ at D=32, ragged at P=3, N=4000 SAQ at D=128, the IVF corpus of
    N=6000 at D=64 with K=32, nprobe 8)."""
    monkeypatch.setattr(cs, "profile_search", lambda *a, **k: None)
    monkeypatch.setattr(cs, "union_host_split", lambda *a, **k: None)
    _, pq_ctx = cs.phase_main(torch, cpu_smoke, n=2002, d=32, nq=8, profile=False)
    _, saq_ctx = cs.phase_saq_main(torch, cpu_smoke, n=4000, d=128, nq=8, profile=False)
    _, ivf_ctx = cs.phase_ivf_main(torch, cpu_smoke, n=6000, d=64, nq=16, k_cl=32,
                                   nprobes=(8,), nq_small=4, profile=False)
    cs.phase_ivf_residual(torch, cpu_smoke, ivf_ctx, k_cl=32, nprobes=(8,), nq_small=4,
                          pq_m=16, profile=False)
    launches = cs.phase_sharded(torch, cpu_smoke, pq_ctx, saq_ctx, ivf_ctx, nprobe=8,
                                profile=False)
    assert launches == {"pq_scan_topk_fused": 0, "pq_score_all": 0, "packed_scan_topk": 0,
                        "packed_scan_topk_gather": 0}


def test_phase_ranks_rehearsal(cpu_smoke, monkeypatch, tmp_path):
    """Phase 16 on phases 4, 7 and 10 run at tiny sizes (as in phase 13's
    rehearsal): the one-process mesh of 4 CPU shards, then 2 spawned gloo
    ranks of 2 shards each, held to it bit for bit (the NCCL rank needs
    the card)."""
    monkeypatch.setattr(cs, "profile_search", lambda *a, **k: None)
    _, pq_ctx = cs.phase_main(torch, cpu_smoke, n=2002, d=32, nq=8, profile=False)
    _, saq_ctx = cs.phase_saq_main(torch, cpu_smoke, n=4000, d=128, nq=8, profile=False)
    _, ivf_ctx = cs.phase_ivf_main(torch, cpu_smoke, n=6000, d=64, nq=16, k_cl=32,
                                   nprobes=(8,), nq_small=4, profile=False)
    spec = cs.ranks_spec(torch, str(tmp_path), pq_ctx, saq_ctx, ivf_ctx, nprobe=8)
    assert cs.phase_ranks(torch, cpu_smoke, spec) == {
        "phase 16 gloo ranks": dict.fromkeys(cs.KERNELS, 0)}


def test_phase_ranks_runs_last_joins_with_a_timeout_and_catches_nothing():
    """Phase 16 is the last phase main() calls, after phase 14; its ranks'
    group and their join are bounded by RANKS_TIMEOUT_S, a rank still
    running then is killed, and no function of the phase catches an
    exception."""
    import ast
    import inspect
    import textwrap

    def calls(fn):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        return [n.func.id for n in ast.walk(tree)
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]

    phases = [name for name in calls(cs.main) if name.startswith("phase_")]
    assert phases[-2:] == ["phase_harness", "phase_ranks"]
    assert "spawn_ranks" in calls(cs.phase_ranks) and "ranks_main" not in calls(cs.main)
    spawn = inspect.getsource(cs.spawn_ranks)
    assert "RANKS_TIMEOUT_S" in spawn and ".kill()" in spawn and "is_alive()" in spawn
    assert "timeout_s=RANKS_TIMEOUT_S" in inspect.getsource(cs.ranks_main)
    for fn in (cs.remake, cs.ranks_spec, cs.ranks_program, cs.ranks_main, cs.spawn_ranks,
               cs.hold_ranks, cs.phase_ranks):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), fn.__name__


def test_phase_quantizers_rehearsal(cpu_smoke):
    """Phase 11 at N=3000: OPQ M=16 at D=64 (2 iterations), RankAware, SQ
    and LVQ at D=64."""
    launches = cs.phase_quantizers(torch, cpu_smoke, n=3000, d=64, nq=16, n_ra=3000, d_ra=64,
                                   nq_ra=8, opq_iters=2, opq_train=2000, profile=False)
    assert launches == {"pq_scan_topk_fused": 0, "packed_scan_topk": 0}


def test_phase_harness_rehearsal(cpu_smoke):
    """Phase 14 at N=3000, D=48, Q=16 (the gate's planted corpus N=2000, the
    stream N=4096, the subprocess's dummy N=2000, K=16 at nprobe 4), with
    the plot step the card's machine cannot run."""
    pytest.importorskip("pandas")
    pytest.importorskip("matplotlib")
    path = cs.phase_harness(torch, cpu_smoke, n=3000, d=48, nq=16, n_gate=2000, n_stream=4096,
                            n_sub=2000, clusters=16, nprobe=4, plot=True, profile=False)
    assert path == dict.fromkeys(cs.KERNELS, 0)


def test_harness_steps_on_the_card_launch_every_kernel_at_full_width():
    steps = cs.harness_steps("/t", "cuda:0", 1_000_000, 1536, 1024, 100_000, 262_144, 4096, 50,
                             cs.PLOT_ON_CARD)
    names = [name for name, _, _ in steps]
    assert names == ["precompute-gt", "run PQ M=16 k=256", "sweep PQ M=16 + SAQ bpd=2",
                     "ivf-bench", "streaming-sweep", "run PQ M=192", "study"]
    assert {k for _, _, ks in steps for k in ks} == set(cs.KERNELS)
    for _, argv, _ in steps:
        assert argv[argv.index("--device") + 1] == "cuda:0"
        if "--dataset" in argv:
            assert argv[argv.index("--dataset") + 1] in (
                "planted-1000000x1536", "planted-100000x1536", "dummy-262144x1536")
    assert "M=192" in steps[5][1] and steps[3][1][steps[3][1].index("--nprobe") + 1] == "50"


def test_same_where_separated_holds_ids_only_where_scores_part():
    class Index:  # decompress: unit rows
        def decompress(self, ids):
            return torch.ones((len(ids), 4)) * 0.5

    q = torch.ones((1, 4)) * 0.5
    s = np.array([[0.1, 0.2, 0.2 + 1e-7, 0.5]], np.float32)
    ids = np.array([[3, 4, 5, 6]], np.uint32)
    swapped = np.array([[3, 5, 4, 6]], np.uint32)
    err, sep = cs.same_where_separated(torch, Index(), q, (ids, s), (swapped, s), "tie")
    assert err == 0.0 and sep == 2
    with pytest.raises(AssertionError, match="ids differ"):
        cs.same_where_separated(torch, Index(), q, (ids, s), (ids[:, ::-1].copy(), s), "order")


def test_same_up_to_ties_holds_ids_only_at_untied_ranks():
    """Rows on one axis at √d from q = 0, so row i scores d_i; rows 4 and 5
    tie, as do 6 and 7; row 8 does not score the k-th's 0.5."""
    d = {3: 0.1, 4: 0.2, 5: 0.2, 6: 0.5, 7: 0.5, 8: 0.9}
    rows = torch.zeros((9, 4))
    for i, v in d.items():
        rows[i, 0] = v ** 0.5
    q = torch.zeros((1, 4))

    def decode(ids):
        return rows[torch.as_tensor(ids)]

    def same(other, what):
        return cs.same_up_to_ties(torch, q, decode, (ids, s), (np.array([other], np.uint32), s),
                                  what)

    s = np.array([[0.1, 0.2, 0.2, 0.5]], np.float32)
    ids = np.array([[3, 4, 5, 6]], np.uint32)
    assert same([3, 5, 4, 6], "tie") == 2
    assert same([3, 4, 5, 7], "k-th") == 1  # the k-th may tie a row the top-k leaves out
    with pytest.raises(AssertionError, match="untied"):
        same([2, 4, 5, 6], "id")
    with pytest.raises(AssertionError, match="rescored"):
        same([3, 4, 5, 8], "a k-th that does not tie")
    with pytest.raises(AssertionError, match="scores differ"):
        cs.same_up_to_ties(torch, q, decode, (ids, s), (ids, s + np.float32(1e-7)), "score")
    with pytest.raises(AssertionError, match="rescored"):  # the first rank, always rescored
        cs.same_up_to_ties(torch, q, decode, (ids, s + 0.05), (ids, s + 0.05), "shifted")


def test_counting_adds_a_blocks_launches_to_its_path():
    path = dict.fromkeys(cs.KERNELS, 0)
    with cs.counting(path) as got:
        ps.pq_scan_topk_fused.launches += 2
        pk.packed_scan_topk.gather_launches += 1
    with cs.counting(path):
        pk.packed_scan_topk.gather_launches += 3
    assert got == {"pq_scan_topk_fused": 2, "pq_score_all": 0, "packed_scan_topk": 0,
                   "packed_scan_topk_gather": 1}
    assert path == {**got, "packed_scan_topk_gather": 4}
    ps.reset_launch_counts()
    pk.reset_launch_counts()


def test_bounds_are_the_larger_of_bytes_and_operations():
    assert cs.bound_ms(3.35e12, 0.5) == (1000.0, "bytes")
    assert cs.bound_ms(3.35e9, 0.5) == (500.0, "operations")
    mask = torch.tensor([1, 0, 1], dtype=torch.int32)
    assert cs.scanned_rows(torch, 1536, 1300) == 1300
    assert cs.scanned_rows(torch, 1536, 1300, mask) == 512 + 276


@pytest.mark.parametrize("m,bf16,want", [(16, True, "table"), (192, True, "decode"),
                                         (16, False, "table"), (192, False, "table")])
def test_pq_bound_is_the_lesser_of_the_two_routes(m, bf16, want):
    """Q=1024, N=100k, D=1536, k=10: the table route's Q·N·M f32 adds at
    33.5e12 a second (plus the tables) against the decode route's 2·Q·N·D
    products at the operands' rate; each against the same bytes."""
    nq, n, d = 1024, 100_000, 1536
    q = torch.empty((nq, d), device="meta")
    codes = torch.empty((n, m), dtype=torch.uint8, device="meta")
    cb = torch.empty((m, 256, d // m), device="meta")
    ms, by, route, routes = cs.pq_bound(q, codes, cb, 10, bf16, False)
    rate = 989e12 if bf16 else 67e12
    assert routes["decode"] == pytest.approx(2.0 * nq * n * d / rate * 1e3)
    assert routes["table"] == pytest.approx((2.0 * nq * 256 * d / rate + nq * n * m / 33.5e12)
                                            * 1e3)
    assert (route, by) == (want, "operations") and ms == min(routes.values())
    # the score kernel's (Q, N) f32 writes outweigh neither route's operations here
    assert cs.pq_bound(q, codes, cb, 10, bf16, True)[2] == want


def test_packed_scan_bits_compare_needs_every_result_equal(tmp_path):
    """scripts/packed_scan_bits.py compare: 0 only when both saved sets hold
    the same results bit for bit."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "scripts" / "packed_scan_bits.py"
    spec = importlib.util.spec_from_file_location("packed_scan_bits", path)
    bits = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bits)
    a = {"x": [torch.tensor([1.0, -float("inf")]), torch.tensor([3, 0])]}
    for name, d in (("a", a), ("b", {"x": [a["x"][0].clone(), a["x"][1].clone()]}),
                    ("c", {"x": [torch.tensor([1.0, 2.0]), a["x"][1]]}), ("d", {})):
        torch.save(d, tmp_path / f"{name}.pt")
    assert bits.compare(str(tmp_path / "a.pt"), str(tmp_path / "b.pt")) == 0
    assert bits.compare(str(tmp_path / "a.pt"), str(tmp_path / "c.pt")) == 1
    assert bits.compare(str(tmp_path / "a.pt"), str(tmp_path / "d.pt")) == 1


def test_exits_nonzero_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cs.main() != 0
    assert "ok" not in capsys.readouterr().out


def test_phase_search_options_rehearsal(cpu_smoke, monkeypatch):
    """Phase 15 on phases 4, 7 and 10 run at tiny sizes: the segment-subset
    checks at N=3000, D=128 (SAQ bpd=2 there has two segments: head 1 and
    the tail), the cascade on phase 7's N=4000 index, groups G = 1, 4, 16
    at Q = 16 and 8 on phase 10's N=6000 index (K=32, nprobe 8), on its
    queries and on a coherent stream of 2 cells, and approx on all four
    indexes."""
    monkeypatch.setattr(cs, "profile_search", lambda *a, **k: None)
    _, pq_ctx = cs.phase_main(torch, cpu_smoke, n=2002, d=32, nq=8, profile=False)
    _, saq_ctx = cs.phase_saq_main(torch, cpu_smoke, n=4000, d=128, nq=8, profile=False)
    _, ivf_ctx = cs.phase_ivf_main(torch, cpu_smoke, n=6000, d=64, nq=16, k_cl=32,
                                   nprobes=(8,), nq_small=4, profile=False)
    results = {}
    path = cs.phase_search_options(torch, cpu_smoke, results, pq_ctx, saq_ctx, ivf_ctx,
                                   n=3000, d=128, nq=8, heads=(1,), k1s=(5, 20), rfs=(5, 10),
                                   groups=(1, 4, 16), nq_small=8, cells=2, nprobe=8,
                                   profile=False)
    assert path == dict.fromkeys(cs.KERNELS, 0)
    assert list(results["packed_scan_topk"]["times"]) == ["SAQ uniform segments (0,) k=20"]


def test_packed_bound_counts_the_factor_rows_a_call_reads():
    """A segment subset reads its own words and its own scale and shift
    rows; NIP reads the norm row and no shift."""
    from vq_tpu_torch.kernels.packed_scan import make_segspec

    segs = tuple(make_segspec(2, 64, "uniform", s) for s in range(4))
    words = [torch.empty((1024 // 16, 64), dtype=torch.int32, device="meta")] * 4
    a = dict(q_cat=torch.empty((8, 64), device="meta"), factors=torch.empty((9, 1024)),
             words=words[:1], segs=segs[1:2], lv_tables=(), k=10, limit=1024,
             metric_kind="l2", r2_cols=(5,), norm_col=8, use_bf16=True)
    assert cs.factor_rows_read(a) == 2
    assert cs.factor_rows_read({**a, "metric_kind": "nip"}) == 2
    assert cs.factor_rows_read({**a, "segs": segs, "words": words, "r2_cols": (4, 5, 6, 7)}) == 8
    ms, by = cs.packed_bound(torch, a)
    want = 1024 * (4 * 64 / 16 + 2 * 4) + 8 * 65 * 4 + 8 * 10 * 8
    assert by == "bytes" and ms == pytest.approx(want / 3.35e12 * 1e3)
