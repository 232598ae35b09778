"""What decides ``correct``, on the CPU at tiny sizes: the reference agrees
with the program, the control (the reference one precision lower in the
program's place) fails, and a run with its timed path broken underneath
comes out not correct."""

from __future__ import annotations

import json

import pytest
import torch
from conftest import CELLS, run_cell

from vqbench import control, harness

FAULTY_SYSTEM = '''"""{system} with a fault planted in its search."""
import importlib.util
from pathlib import Path

import numpy as np

_spec = importlib.util.spec_from_file_location(
    "real_{system}", Path(__file__).with_name("{system}.py"))
_real = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_real)
build, counters, work, state = _real.build, _real.counters, _real.work, _real.state


def search(index, queries, k):
    ids, scores = _real.search(index, queries, k)
    ids, scores = ids.copy(), scores.copy()
    fault = "{fault}"
    if fault == "answer_altered":  # one id of the batch swapped for another row's
        ids[0, 0] = (int(ids[0, 0]) + index.num_rows // 2) % index.num_rows
    elif fault == "half_batch_left_out":  # the second half answered as the first
        h = ids.shape[0] // 2
        ids[h:2 * h], scores[h:2 * h] = ids[:h], scores[:h]
    return ids, scores
'''


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_agrees_with_the_program(tiny_root, cell):
    rc, res = run_cell(tiny_root, cell, seed=5)
    assert rc == 0
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(tiny_root, cell):
    """The control on the CPU: TF32 has no effect there, so it is the
    float8 scan that has to fail a number."""
    _, _, cfg, _ = harness.load_cell(tiny_root, cell)
    nums = control.control_numbers(tiny_root, cell, 2**31 + 17, torch.device("cpu"))
    assert set(nums) == set(cfg["limits"])
    assert any(nums[n] > lim for n, lim in cfg["limits"].items()), nums


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_left_out"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, fault):
    bench, c, _, _ = harness.load_cell(tiny_root, cell)
    entry = next(e for e in bench["configs"] if e["name"] == c["config"])
    path = tiny_root / entry["file"]
    cfg = json.loads(path.read_text())
    faulty = f"{cfg['system']}_{fault}"
    (tiny_root / "vqbench" / "systems" / f"{faulty}.py").write_text(
        FAULTY_SYSTEM.format(system=cfg["system"], fault=fault))
    cfg["system"] = faulty
    path.write_text(json.dumps(cfg))
    rc, res = run_cell(tiny_root, cell)
    assert rc == 0 and res["correct"] is False


def _garbled(v):
    """A state leaf of the same shape and type that holds nothing right."""
    if isinstance(v, torch.Tensor):
        return torch.flip(v, dims=[0]) + 1 if v.dtype.is_floating_point else torch.flip(v, [0])
    if isinstance(v, (tuple, list)) and v and isinstance(v[0], torch.Tensor):
        return type(v)(_garbled(t) for t in v)
    return v


@pytest.mark.parametrize("cell", CELLS)
def test_the_answers_are_judged_from_the_reference_alone(tiny_root, cell):
    """The answers' numbers do not move when the program's state is garbled
    (the reference derives its own fit, codes and layout), while the
    stage numbers that read that state fail."""
    _, _, cfg, mix = harness.load_cell(tiny_root, cell)
    x, pool = harness.make_data(tiny_root, cfg, 2**31 + 29, "cpu")
    system = harness.load(tiny_root, "systems", cfg["system"])
    index = system.build(x, cfg, mix)
    answers, _ = harness.window(system, index, harness.Traffic(pool, mix, 2**31 + 29),
                                mix["k"], 0.2)
    state = system.state(index)
    ref = harness.load(tiny_root, "reference", cfg["reference"])
    sound = ref.judge(x, pool, state, answers, cfg, mix, 3)
    garbled = ref.judge(x, pool, {n: _garbled(v) for n, v in state.items()}, answers, cfg,
                        mix, 3)
    assert {n: garbled[n] for n in ("gap", "score_err")} == {
        n: sound[n] for n in ("gap", "score_err")}
    stages = set(cfg["limits"]) - {"gap", "score_err"}
    assert all(sound[n] <= cfg["limits"][n] for n in stages), sound
    assert all(garbled[n] > cfg["limits"][n] for n in stages), garbled
