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

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

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
    monkeypatch.setattr(cs, "BF16_MIN_RECALL", 0.9)
    monkeypatch.setattr(cs, "RECALL_GATE_PQ192_FLOOR", 0.5)
    return torch.device("cpu")


def test_phase_kernels_rehearsal(cpu_smoke):
    cs.phase_kernel_edges(torch, cpu_smoke, nq=37, n=6000)
    results = {}
    cs.phase_kernels(torch, cpu_smoke, results, n=1500, d=384, nq=16)
    for name in ("pq_scan_topk_fused", "pq_score_all"):
        assert set(results[name]["times"]) == {"M=16 dsub=24", "M=192 dsub=2"}


def test_phase_main_and_gate_rehearsal(cpu_smoke):
    # profile=False: torch.profiler records no device time on the CPU
    launches = cs.phase_main(torch, cpu_smoke, n=1500, d=32, nq=8, profile=False)
    assert set(launches) == {"pq_scan_topk_fused", "pq_score_all"}
    cs.phase_gate(torch, cpu_smoke, n=400, d=192, nq=8)


def test_phase_packed_kernels_rehearsal(cpu_smoke):
    """Phase 6 at D=128, where SAQ lloyd has no value-plane segment (the
    script requires every dequant kind to launch only on the card)."""
    results = {}
    cs.phase_packed_kernels(torch, cpu_smoke, results, n=3000, d=128, nq=8)
    assert len(results["packed_scan_topk"]["times"]) == 4


def test_phase_packed_paths_rehearsal(cpu_smoke):
    assert cs.phase_saq_main(torch, cpu_smoke, n=4000, d=128, nq=8, profile=False) == 0
    assert cs.phase_rabitq_main(torch, cpu_smoke, n=4000, d=128, nq=8) == 0


def test_exits_nonzero_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cs.main() != 0
    assert "ok" not in capsys.readouterr().out
