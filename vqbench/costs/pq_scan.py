"""The least time of a PQ scan with top-k (``csrc/pq_scan.cu`` and the
top-k fold of ``csrc/topk.cuh``), counted from the shapes alone: Q queries,
N rows of M one-byte codes, K codewords of dsub dims, k kept.

Copied from ``chip_smoke.py::pq_bound`` at commit 6e0cbc3: the lesser of
the two routes' bounds, each the larger of the bytes (codes, codebooks and
queries read once, the (Q, k) top-k written once) and the operations.  The
table route: 2·K·D products a query for its lookup tables, in the
operands' type, and one lone f32 add per (query, row, subspace); the
decode route: 2·Q·N·D products in the operands' type.  Whichever route
the program takes, the bound is the lesser one."""

from __future__ import annotations

from vqbench.costs import peaks


def bound_s(q: int, n: int, m: int, kk: int, dsub: int, k: int, bf16: bool = True,
            **_) -> float:
    d = m * dsub
    nbytes = n * m + m * kk * dsub * 4 + q * d * 4 + q * k * 8
    rate = peaks.OPS_PER_S["bf16" if bf16 else "f32"]
    table = peaks.bound_s(nbytes, 2.0 * q * kk * d / rate
                          + float(q) * n * m / peaks.OPS_PER_S["f32 add"])
    decode = peaks.bound_s(nbytes, 2.0 * q * n * d / rate)
    return min(table, decode)
