"""The row-source corpus maker on the CPU at tiny n: its rows are the
concatenation of its blocks whatever the request, a seed remakes them,
the whole corpus is never materialized, it draws from ``fullrank``'s
distribution, and the exact top-k and recall read it as they read a
tensor."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch
from conftest import REPO

from vqbench import harness
from vqbench.corpora import fullrank, fullrank_stream
from vqbench.reference import common

N, D, NQ, BLOCK = 1000, 16, 40, 256  # four blocks, the last of 232 rows
SEED = 2**31 + 101
PARAMS = {"csize": 10, "spread": 1.0, "basis_seed": 20261018, "block": BLOCK}


def make(seed=SEED, **kw):
    return fullrank_stream.make(N, D, NQ, seed, "cpu", **{**PARAMS, **kw})


def whole(rows):
    return torch.cat([rows.make_block(b) for b in range(-(-len(rows) // rows.block))])


def test_rows_answer_requests_as_the_concatenated_blocks():
    rows, pool = make()
    x = whole(rows)
    assert x.shape == rows.shape == (N, D) and len(rows) == N
    assert rows.dtype == x.dtype == torch.float32 and rows.device == x.device
    assert torch.allclose(torch.linalg.norm(x, dim=1), torch.ones(N), atol=1e-5)
    assert pool.shape == (NQ, D)
    for i0, i1 in [(0, 1), (250, 260), (255, 257), (0, 512), (100, 1000), (768, 1000),
                   (999, 1000), (0, 1000), (300, 300)]:
        assert torch.equal(rows[i0:i1], x[i0:i1]), (i0, i1)
    assert torch.equal(rows[-10:], x[-10:]) and torch.equal(rows[::7], x[::7])
    ids = [999, 0, 255, 256, 256, 513, 767, 768, 12]
    for key in (ids, np.array(ids), torch.tensor(ids), range(250, 780, 3)):
        assert torch.equal(rows[key], x[torch.as_tensor(list(key))])
    assert rows[[]].shape == (0, D)


def test_a_seed_remakes_its_rows_and_another_seed_others():
    rows, pool = make()
    again, pool2 = make()
    other, pool3 = make(seed=SEED + 1)
    assert torch.equal(whole(rows), whole(again)) and torch.equal(pool, pool2)
    assert torch.equal(rows[300:700], again[300:700])
    assert not torch.allclose(whole(rows), whole(other)) and not torch.allclose(pool, pool3)
    # a block is remade alone, in any order
    assert torch.equal(rows.make_block(2), whole(again)[2 * BLOCK:3 * BLOCK])


def test_the_whole_corpus_is_never_materialized():
    rows, _ = make()
    rows.max_rows = 300
    for attempt in (lambda: np.asarray(rows), lambda: torch.as_tensor(rows), lambda: list(rows),
                    lambda: rows[:], lambda: rows[0:301], lambda: rows[list(range(301))]):
        with pytest.raises((MemoryError, TypeError, ValueError)):
            attempt()
    assert rows[0:300].shape == (300, D)
    with pytest.raises(TypeError):
        rows[3]
    with pytest.raises(IndexError):
        rows[[N]]
    with pytest.raises(IndexError):
        rows[[-1]]


def test_it_draws_from_the_distribution_of_fullrank():
    """With the same seeds both share the mixing matrix and the centres;
    the rows' column profile and neighbourhood distances agree."""
    n, kc = 4000, 400
    x, q = fullrank.make(n, D, NQ, SEED, "cpu", csize=10, basis_seed=3)
    rows, pool = fullrank_stream.make(n, D, NQ, SEED, "cpu", csize=10, basis_seed=3,
                                      block=1024)
    y = rows[:]
    assert not torch.allclose(x, y)
    assert torch.allclose((x * x).mean(0), (y * y).mean(0), rtol=0.1)
    for t in (x, y):
        assert torch.allclose(torch.linalg.norm(t, dim=1), torch.ones(n), atol=1e-5)
    same = [((t[:-kc] - t[kc:]) ** 2).sum(1).mean() for t in (x, y)]  # rows of one centre
    other = [((t[:-1] - t[1:]) ** 2).sum(1).mean() for t in (x, y)]  # neighbouring centres
    assert abs(same[0] - same[1]) < 0.05 * same[0] and abs(other[0] - other[1]) < 0.05 * other[0]
    assert same[1] < 0.6 * other[1]
    assert torch.allclose(torch.linalg.norm(pool, dim=1), torch.ones(NQ), atol=1e-5)


@pytest.mark.parametrize("block", [100, 65536])
def test_exact_topk_and_recall_read_the_row_source_as_a_tensor(block):
    rows, pool = make()
    x = whole(rows)
    k = 10
    gt = common.exact_topk(pool, x, k, block=block)
    assert torch.equal(common.exact_topk(pool, rows, k, block=block), gt)
    # answers with some of the true neighbours swapped for other rows
    ids = gt.clone()
    ids[::3, -3:] = (ids[::3, -3:] + N // 2) % N
    answers = [(np.arange(0, NQ // 2), ids[:NQ // 2].numpy(), np.zeros((NQ // 2, k))),
               (np.arange(NQ // 2, NQ), ids[NQ // 2:].numpy(), np.zeros((NQ // 2, k)))]
    recall = harness.load(REPO, "e2e_metrics", "recall")
    on_rows, on_x = (recall.read(types.SimpleNamespace(mix={"k": k}, pool=pool, corpus=c,
                                                       answers=answers)) for c in (rows, x))
    assert on_rows == on_x and 0.5 < on_rows < 1.0


def test_the_harness_finds_the_maker_by_name():
    cfg = {"n": N, "d": D, "num_queries": NQ,
           "corpus": {"maker": "fullrank_stream", "params": PARAMS}}
    rows, pool = harness.make_data(REPO, cfg, SEED, torch.device("cpu"))
    ref_rows, ref_pool = make()
    assert type(rows).__name__ == "Rows" and torch.equal(pool, ref_pool)
    assert torch.equal(rows[0:N], ref_rows[0:N])
