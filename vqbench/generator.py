"""The one traffic generator: a mix file's parameters → the stream of pool
rows a closed loop sends, cut into batches.

A mix (``traffic/<name>.json``) gives ``batch`` (queries a batch), ``k``,
``nprobe`` (IVF cells; null otherwise), ``loop`` ("closed": one client,
the next batch sent when the last answer is in hand), ``passes`` (passes
over the pool made before the window; a window that outruns them starts
over) and ``judge_batches`` (batches whose answers the reference judges
where it samples; null: every answer).  Each pass is a fresh permutation
of the pool and the batches run on across passes, so every query is sent
equally often, no two batches of a window hold the same queries, and
every seed gives the same sizes in another order."""

from __future__ import annotations

import numpy as np

LOOPS = ("closed",)


def stream(pool: int, mix: dict, seed: int) -> np.ndarray:
    """``mix["passes"]`` permutations of the pool's rows, end to end, cut to
    a whole number of batches → (batches · batch,) int64."""
    if mix["loop"] not in LOOPS:
        raise ValueError(f"loop {mix['loop']!r}: the generator makes {LOOPS}")
    b = mix["batch"]
    if not 0 < b <= pool * mix["passes"]:
        raise ValueError(f"batch {b} against {mix['passes']} passes over a pool of {pool}")
    rng = np.random.default_rng([int(seed), 1])
    rows = np.concatenate([rng.permutation(pool) for _ in range(mix["passes"])])
    return rows[:len(rows) - len(rows) % b]


def batches(pool: int, mix: dict, seed: int, count: int) -> list:
    """The first ``count`` batches of the stream (int64 arrays of pool rows)."""
    rows, b = stream(pool, mix, seed), mix["batch"]
    n = len(rows) // b
    return [rows[(j % n) * b:(j % n + 1) * b] for j in range(count)]
