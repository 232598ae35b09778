"""The benchmark's flat SAQ deployment on the CPU at a small size: the
port's ``FlatQuantizedIndex`` over SAQ fitted on a row source and searched
(``vqbench/systems/flat_saq.py``), judged by the plain reference
``vqbench/reference/flat_saq.py``.

* the reference agrees with the program within the CPU rehearsal's limits
  (``vqbench/tests/tiny/configs/msmarco53m-saq2.json``), streamed in one
  block or in blocks of 1,000 rows;
* its streamed ``gap`` and ``score_err`` are ``common.judge_answers``' over
  the whole decoded corpus;
* the control (float8 scan; TF32 has no effect on the CPU) fails a limit;
* a state of another plan, order or words fails its stage number;
* ``costs/packed_dense.py`` at the configuration's plan;
* the reference, the row-source corpus and the cost load nothing of the
  program, the JAX package or JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vqbench import generator
from vqbench.corpora import fullrank_stream
from vqbench.costs import packed_dense
from vqbench.reference import common, flat_saq
from vqbench.reference import saq as rsaq
from vqbench.systems import flat_saq as system

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
N, D, NQ, SEED = 6000, 64, 64, 2**31 + 71
MIX = {"batch": 16, "k": 10, "nprobe": None, "loop": "closed", "passes": 4,
       "judge_batches": 3}


def config() -> dict:
    cfg = json.loads((REPO / "vqbench" / "configs" / "msmarco53m-saq2.json").read_text())
    tiny = json.loads((REPO / "vqbench" / "tests" / "tiny" / "configs" /
                       "msmarco53m-saq2.json").read_text())
    cfg["quantizer"].update(tiny["quantizer"])
    return {**cfg, "n": N, "d": D, "num_queries": NQ, "limits": tiny["limits"]}


@pytest.fixture(scope="module")
def run():
    """The corpus (a row source of 1,000-row blocks), the pool, the built
    index, its state and the answers to 8 batches."""
    cfg = config()
    x, pool = fullrank_stream.make(N, D, NQ, SEED, "cpu", block=1000,
                                   **{k: v for k, v in cfg["corpus"]["params"].items()})
    index = system.build(x, cfg, MIX)
    answers = [(b, *system.search(index, pool[torch.as_tensor(b)], MIX["k"]))
               for b in generator.batches(NQ, MIX, SEED, 8)]
    return cfg, x, pool, index, system.state(index), answers


@pytest.mark.parametrize("block", [flat_saq.BLOCK, 1000])
def test_the_reference_agrees_with_the_program(run, block):
    cfg, x, pool, _, state, answers = run
    nums = flat_saq.judge(x, pool, state, answers, cfg, MIX, 3, block=block)
    assert set(nums) == set(cfg["limits"])
    for name, lim in cfg["limits"].items():
        assert nums[name] <= lim, (name, nums)


def test_the_streamed_answers_are_judge_answers_over_the_whole_corpus(run):
    cfg, x, pool, _, state, answers = run
    plan, params = flat_saq.fit(x, cfg, "cpu")
    codes, scales = rsaq.encode(plan, params, x[0:N], cfg["quantizer"]["caq_rounds"])
    xr = rsaq.decode(plan, params, codes, scales, 0, N)
    # a wrong answer in the first batch, so the numbers are not all zero
    bad = [(answers[0][0], answers[0][1].copy(), answers[0][2])] + answers[1:]
    bad[0][1][0, 0] = (int(bad[0][1][0, 0]) + N // 2) % N
    mix = {**MIX, "judge_batches": None}
    for ans in (answers, bad):
        whole = common.judge_answers(pool, xr, ans, MIX["k"])
        streamed = flat_saq.judge(x, pool, state, ans, cfg, mix, block=1000)
        for name in ("gap", "score_err"):
            assert streamed[name] == pytest.approx(whole[name], rel=1e-4, abs=1e-5)
    assert whole["gap"] > 1e-3 and whole["score_err"] > 1e-3


def test_the_control_fails_a_limit(run):
    cfg, x, pool, *_ = run
    batches = generator.batches(NQ, MIX, SEED, MIX["judge_batches"])
    state, answers = flat_saq.control(x, pool, cfg, MIX, batches, block=1000)
    nums = flat_saq.judge(x, pool, state, answers, cfg, MIX, 3)
    assert any(nums[n] > lim for n, lim in cfg["limits"].items()), nums
    for name in ("fit", "layout", "words", "factors"):  # TF32 is f32 on the CPU
        assert nums[name] <= cfg["limits"][name], (name, nums)


@pytest.mark.parametrize("fault", ["plan", "perm", "words", "factors"])
def test_a_wrong_stage_fails_its_number(run, fault):
    cfg, x, pool, _, state, answers = run
    bad = dict(state)
    if fault == "plan":
        bad["plan"] = tuple(tuple(v) for v in state["plan"][:2]) + (
            tuple(b + 1 for b in state["plan"][2]),)
    elif fault == "perm":
        bad["perm"] = torch.roll(state["perm"], 1)
    elif fault == "words":
        bad["words"] = (state["words"][0] ^ 1,) + tuple(state["words"][1:])
    else:
        bad["factors"] = state["factors"] * 1.01
    nums = flat_saq.judge(x, pool, bad, answers, cfg, MIX, 3)
    name = {"plan": "fit", "perm": "layout"}.get(fault, fault)
    assert nums[name] > cfg["limits"][name], nums


def test_packed_dense_bound_at_the_configurations_plan():
    """The greedy plan at D=1024, 2 bits/dim: (64 dims, 5 bits), (64, 4),
    (320, 3), (256, 2): 704 coded dims, 2,048 code bits, 8 factor rows an
    L2 scan reads; Q=64, k=10 over 53.2M rows."""
    w = {"q": 64, "n": 53_200_000, "coded_dims": 704, "code_bits": 2048, "factors_per_row": 8,
         "k": 10}
    nbytes = 53_200_000 * (256 + 32) + 64 * 705 * 4 + 64 * 10 * 8
    assert nbytes / 3.35e12 == pytest.approx(4.5736e-3, rel=1e-4)
    ops_s = 2.0 * 64 * 53_200_000 * 704 / 989e12
    assert ops_s == pytest.approx(4.8472e-3, rel=1e-4)
    assert packed_dense.bound_s(**w) == ops_s
    assert packed_dense.bound_s(**w, bf16=False) == pytest.approx(ops_s * 989 / 67)
    assert packed_dense.bound_s(**{**w, "q": 1}) == pytest.approx(nbytes / 3.35e12, rel=1e-3)


def test_the_reference_side_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import vqbench.reference.flat_saq, vqbench.corpora.fullrank_stream\n"
            "import vqbench.costs.packed_dense\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'vq_tpu_torch', 'vq_tpu', 'jax', 'jaxlib', 'flax'}))"
            % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_the_systems_counters_and_work(run):
    cfg, _, pool, index, _, _ = run
    system.search(index, pool[:16], MIX["k"])
    c = system.counters(index)
    assert c["tiles"] == -(-N // 512) and c["units"] == c["tiles"]  # the plain twin's tiles
    assert 0 < c["scanned"] <= c["units"]
    w = system.work(index, None, cfg, MIX)(pool[:16])
    plan = index.quantizer.plan
    assert w == {"family": "packed_dense", "n": N, "coded_dims": sum(plan.seg_lens),
                 "code_bits": sum(a * b for a, b in zip(plan.seg_lens, plan.seg_bits)),
                 "factors_per_row": 2 * plan.num_segments, "k": 10, "bf16": True, "q": 16}
    assert np.isfinite(packed_dense.bound_s(**w))
