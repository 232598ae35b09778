"""The benchmark's flat Extended RaBitQ deployment on the CPU at a small
size: the port's ``FlatQuantizedIndex`` over RaBitQ B=4 fitted on a row
source and searched (``vqbench/systems/flat_rabitq.py``), judged by the
plain reference ``vqbench/reference/flat_rabitq.py``.

* the reference agrees with the program within the CPU rehearsal's limits
  (``vqbench/tests/tiny/configs/msmarco53m-rabitq4.json``), streamed in one
  block or in blocks of 1,000 rows;
* its streamed ``gap`` and ``score_err`` are ``common``'s definitions over
  the whole corpus's estimator distances;
* the control (float8 scan; TF32 has no effect on the CPU) fails a limit;
* a state of another fit, words or factors fails its stage number, and
  the factors are held on the rows whose codes agree;
* ``costs/packed_dense.py`` at the configuration's sizes;
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
from vqbench.reference import common, flat_rabitq
from vqbench.reference import rabitq as rrb
from vqbench.systems import flat_rabitq as system

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
N, D, NQ, SEED = 6000, 64, 64, 2**31 + 83
MIX = {"batch": 16, "k": 10, "nprobe": None, "loop": "closed", "passes": 4,
       "judge_batches": 3}


def config() -> dict:
    cfg = json.loads((REPO / "vqbench" / "configs" / "msmarco53m-rabitq4.json").read_text())
    tiny = json.loads((REPO / "vqbench" / "tests" / "tiny" / "configs" /
                       "msmarco53m-rabitq4.json").read_text())
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


@pytest.mark.parametrize("block", [flat_rabitq.BLOCK, 1000])
def test_the_reference_agrees_with_the_program(run, block):
    cfg, x, pool, _, state, answers = run
    nums = flat_rabitq.judge(x, pool, state, answers, cfg, MIX, 3, block=block)
    assert set(nums) == set(cfg["limits"])
    for name, lim in cfg["limits"].items():
        assert nums[name] <= lim, (name, nums)


def test_the_streamed_answers_are_judged_over_the_whole_corpus(run):
    cfg, x, pool, _, state, answers = run
    params = flat_rabitq.fit(x, cfg, "cpu")
    idx, nrm, t = rrb.encode(params, x[0:N])
    s_hat, alpha, _ = rrb.scale_shift(params, idx, nrm, t)
    dist = rrb.distances(params, pool, s_hat, alpha, nrm)
    # a wrong answer in the first batch, so the numbers are not all zero
    bad = [(answers[0][0], answers[0][1].copy(), answers[0][2])] + answers[1:]
    bad[0][1][0, 0] = (int(bad[0][1][0, 0]) + N // 2) % N
    mix = {**MIX, "judge_batches": None}
    for ans in (answers, bad):
        rows, ids, scores = (torch.as_tensor(a) for a in common.stack_answers(ans))
        kth = torch.topk(dist, MIX["k"], dim=1, largest=False).values[:, -1]
        gap, err = common._judge_block(dist, rows, ids, scores, kth[rows])
        streamed = flat_rabitq.judge(x, pool, state, ans, cfg, mix, block=1000)
        assert streamed["gap"] == pytest.approx(gap, rel=1e-4, abs=1e-5)
        assert streamed["score_err"] == pytest.approx(err, rel=1e-4, abs=1e-5)
    assert gap > 1e-3 and err > 1e-3


def test_the_control_fails_a_limit(run):
    cfg, x, pool, *_ = run
    batches = generator.batches(NQ, MIX, SEED, MIX["judge_batches"])
    state, answers = flat_rabitq.control(x, pool, cfg, MIX, batches, block=1000)
    nums = flat_rabitq.judge(x, pool, state, answers, cfg, MIX, 3)
    assert any(nums[n] > lim for n, lim in cfg["limits"].items()), nums
    for name in ("words", "factors"):  # TF32 is f32 on the CPU
        assert nums[name] <= cfg["limits"][name], (name, nums)


@pytest.mark.parametrize("fault", ["centroid", "levels", "words", "factors"])
def test_a_wrong_stage_fails_its_number(run, fault):
    cfg, x, pool, _, state, answers = run
    bad = dict(state)
    if fault == "centroid":
        bad["centroid"] = state["centroid"] + 1e-3 * state["centroid"].abs().max()
    elif fault == "levels":
        bad["levels"] = state["levels"] * 1.001
    elif fault == "words":
        bad["words"] = (state["words"][0] ^ 1,)
    else:
        bad["factors"] = state["factors"] * 1.01
    nums = flat_rabitq.judge(x, pool, bad, answers, cfg, MIX, 3)
    name = "fit" if fault in ("centroid", "levels") else fault
    assert nums[name] > cfg["limits"][name], nums


@pytest.mark.parametrize("word_rows", [1, "all"])
def test_factors_are_held_on_the_rows_whose_codes_agree(run, word_rows):
    """Every bit of word row 0 flipped changes the codes of its 8 rows
    (tile rows 0, 64, ..., 448): ``words`` fails, and their factors, off
    too, leave ``factors`` at 0; with every word row flipped no row agrees
    and ``factors`` reads 1.0."""
    cfg, x, pool, _, state, answers = run
    words, fac = state["words"][0].clone(), state["factors"].clone()
    if word_rows == 1:
        words[0] = ~words[0]
        fac[:, 0:512:64] *= 2.0
    else:
        words = ~words
    bad = {**state, "words": (words,), "factors": fac}
    nums = flat_rabitq.judge(x, pool, bad, answers, cfg, MIX, 3)
    assert nums["words"] > cfg["limits"]["words"], nums
    assert nums["factors"] == (0.0 if word_rows == 1 else 1.0), nums


def test_packed_dense_bound_at_the_configurations_sizes():
    """D=1024 at 4 bits: 4,096 code bits and 2 factors (α, c2), 520 B a row;
    Q=64, k=10 over 53.2M rows: the bytes (8.26 ms) bound it, above the
    operations (7.05 ms)."""
    w = {"q": 64, "n": 53_200_000, "coded_dims": 1024, "code_bits": 4096, "factors_per_row": 2,
         "k": 10}
    nbytes = 53_200_000 * 520 + 64 * 1025 * 4 + 64 * 10 * 8
    assert nbytes / 3.35e12 == pytest.approx(8.2579e-3, rel=1e-4)
    assert 2.0 * 64 * 53_200_000 * 1024 / 989e12 == pytest.approx(7.0505e-3, rel=1e-4)
    assert packed_dense.bound_s(**w) == nbytes / 3.35e12


def test_the_reference_side_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import vqbench.reference.flat_rabitq, vqbench.reference.rabitq\n"
            "import vqbench.corpora.fullrank_stream, vqbench.costs.packed_dense\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'vq_tpu_torch', 'vq_tpu', 'jax', 'jaxlib', 'flax'}))"
            % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_the_systems_counters_and_work(run):
    cfg, x, pool, index, _, _ = run
    system.search(index, pool[:16], MIX["k"])
    c = system.counters(index)
    assert c["tiles"] == -(-N // 512) and c["units"] == c["tiles"]  # the plain twin's tiles
    assert c["scanned"] == c["units"]  # the prune is off on unit rows
    w = system.work(index, x, cfg, MIX)(pool[:16])
    assert w == {"family": "packed_dense", "n": N, "coded_dims": D, "code_bits": 4 * D,
                 "factors_per_row": 2, "k": 10, "bf16": True, "q": 16}
    assert np.isfinite(packed_dense.bound_s(**w))
