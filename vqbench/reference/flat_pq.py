"""Plain reference of a flat PQ index searched by L2: the fit, the encode,
the decode and the exact scan over every row.

The fit and the encode are frozen copies of ``vq_tpu_torch/methods/pq.py``
(``fit``, ``encode_chunked``) at commit 6e0cbc3, op for op; the scan is
plain: every row decoded to f32 and its squared distance to each query.

``judge`` works every stage out again from the rows and the seeds alone and
holds the program's output of each stage against its own: the codebooks
against its fit, the codes against its encode with its own codebooks, the
answers against the distances of its own decoded rows.  It takes nothing
the program made.  ``control`` is this reference in the program's place
one precision lower: TF32 where the program computes in f32 (fit, encode),
float8 e4m3 where it scans in bf16.
"""

from __future__ import annotations

import numpy as np
import torch

from vqbench.reference import common, kmeans

_ENCODE_ELEMS = 1 << 28


def fit(x: torch.Tensor, qcfg: dict) -> torch.Tensor:
    """(M, 2^B, D/M) codebooks: Lloyd on ≤ max_points_per_centroid·2^B rows."""
    m, kk = qcfg["num_subquantizers"], 1 << qcfg["num_bits"]
    km = qcfg["kmeans"]
    xs = kmeans.sample_rows(x, km["max_points_per_centroid"] * kk, qcfg["seed"])
    n, d = xs.shape
    sub = xs.reshape(n, m, d // m).transpose(0, 1)
    return kmeans.kmeans_batched(kmeans.generator(qcfg["seed"], x.device), sub, kk, km["iters"],
                                 km["max_points_per_centroid"], km["init"]).contiguous()


def encode(cb: torch.Tensor, x: torch.Tensor, chunk: int = 65536) -> torch.Tensor:
    """(N, D) → (N, M) uint8 codes: each subvector's nearest codeword."""
    m, kk, dsub = cb.shape
    c2 = torch.sum(cb * cb, dim=-1)
    chunk = max(1, min(chunk, _ENCODE_ELEMS // (m * kk)))
    out = torch.empty((x.shape[0], m), dtype=torch.uint8, device=cb.device)
    for st in range(0, x.shape[0], chunk):
        xc = x[st:st + chunk].to(torch.float32)
        ip = torch.einsum("cmd,mkd->cmk", xc.reshape(-1, m, dsub), cb)
        out[st:st + xc.shape[0]] = torch.argmin(c2[None] - 2.0 * ip, dim=-1).to(torch.uint8)
    return out


def decode(cb: torch.Tensor, codes: torch.Tensor, block: int = 262144) -> torch.Tensor:
    """(N, M) codes → (N, D) f32 rows, block by block."""
    m = cb.shape[0]
    sub = torch.arange(m, device=cb.device)
    out = torch.empty((codes.shape[0], m * cb.shape[2]), dtype=torch.float32, device=cb.device)
    for i0 in range(0, codes.shape[0], block):
        out[i0:i0 + block] = cb[sub[None, :], codes[i0:i0 + block].long()].reshape(-1, out.shape[1])
    return out


def _deviation(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |Δ| over max |ref|; 1.0 for another shape."""
    if tuple(prog.shape) != tuple(ref.shape):
        return 1.0
    return float((prog.to(torch.float32) - ref).abs().max() / ref.abs().max())


def judge(x, q, state, answers, cfg, traffic, seed: int = 0) -> dict:
    """The numbers compared: fit (the program's codebooks against this
    reference's fit, max |Δ| over max |c|), codes (share of code entries
    that differ from this reference's encode with its own codebooks), gap
    and score_err (``common.judge_answers`` against its own decoded rows:
    every answer, or ``traffic["judge_batches"]`` batches drawn from
    ``seed``)."""
    cb = fit(x, cfg["quantizer"])
    out = {"fit": _deviation(state["codebooks"], cb)}
    codes = encode(cb, x)
    prog = state["codes"]
    out["codes"] = (float((codes != prog).float().mean()) if prog.shape == codes.shape
                    else 1.0)
    xr = decode(cb, codes)
    del codes
    if traffic.get("judge_batches"):
        answers = [answers[i] for i in common.sample_batches(len(answers),
                                                             traffic["judge_batches"], seed)]
    out.update(common.judge_answers(q, xr, answers, traffic["k"]))
    return out


def control(x, q, cfg, traffic, batches, qblock: int = 2048):
    """This reference in the program's place, one precision lower → (the
    state in the form ``systems/flat_pq.py::state`` gives, answers to
    ``batches``)."""
    with common.tf32(True):
        cb = fit(x, cfg["quantizer"])
        codes = encode(cb, x)
    xr8 = common.rows_fp8(decode(cb, codes))
    k = traffic["k"]
    ids = np.empty((q.shape[0], k), dtype=np.int64)
    vals = np.empty((q.shape[0], k), dtype=np.float32)
    for p0 in range(0, q.shape[0], qblock):
        ids[p0:p0 + qblock], vals[p0:p0 + qblock] = common.control_topk(q[p0:p0 + qblock], xr8, k)
    return {"codebooks": cb, "codes": codes}, [(b, ids[b], vals[b]) for b in batches]
