"""The least time of a flat exhaustive search over packed codes
(``csrc/packed_scan.cu`` in its dense mode, the variance prune on or off),
counted from what a flat search must do, whatever the prune skips: the
larger of

* the bytes of every row, codes at their coded bits and the factors the L2
  scan reads (2 a segment: the rescale and the L2 shift), read once, the
  queries read once and the (Q, k) top-k written once, at the memory rate;
  and
* 2 operations per coded dimension of every (query, row) pair, in the
  operands' type (bf16 on the tensor cores).

The memory rate and peaks are ``peaks.py``'s; the split into bytes and
operations is that of ``packed_scan.py``, with every row counted."""

from __future__ import annotations

from vqbench.costs import peaks


def bound_s(q: int, n: int, coded_dims: int, code_bits: int, factors_per_row: int, k: int,
            bf16: bool = True, **_) -> float:
    nbytes = n * (code_bits / 8.0 + 4 * factors_per_row) + q * (coded_dims + 1) * 4 + q * k * 8
    ops = 2.0 * q * n * coded_dims
    return peaks.bound_s(nbytes, ops / peaks.OPS_PER_S["bf16" if bf16 else "f32"])
