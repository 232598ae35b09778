"""The least time of an IVF search over packed codes (``csrc/packed_scan.cu``
in gather mode), counted from what IVF semantics need, whatever the kernel
scans: the larger of

* the bytes of the union of the batch's probed lists, codes at their coded
  bits and the factors the L2 scan reads, read once, the queries read once
  and the (Q, k) top-k written once, at the memory rate; and
* 2 operations per coded dimension of every (query, row of that query's
  own probed lists) pair, in the operands' type (bf16 on the tensor cores).

The memory rate and peaks are ``peaks.py``'s; the split into bytes and
operations is that of ``chip_smoke.py::packed_bound`` at commit 6e0cbc3,
with the rows counted per probed list instead of per scanned tile."""

from __future__ import annotations

from vqbench.costs import peaks


def bound_s(q: int, rows_per_query_sum: int, union_rows: int, coded_dims: int, code_bits: int,
            factors_per_row: int, k: int, bf16: bool = True, **_) -> float:
    nbytes = (union_rows * (code_bits / 8.0 + 4 * factors_per_row) + q * (coded_dims + 1) * 4
              + q * k * 8)
    ops = 2.0 * rows_per_query_sum * coded_dims
    return peaks.bound_s(nbytes, ops / peaks.OPS_PER_S["bf16" if bf16 else "f32"])
