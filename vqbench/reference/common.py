"""What every plain reference of the benchmark shares: f32 distances, the
exact top-k, the precision switches of the control, and the numbers that
judge a search's answers.  Plain torch; imports nothing of the program.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn value
BIG = 1e30  # a reading that fails every limit (an id out of range, a duplicate)


@contextlib.contextmanager
def tf32(on: bool):
    """Matrix products in TF32 (the control's f32 stages) or in f32."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """Each row scaled to the e4m3 range, rounded to float8_e4m3fn and back
    to f32 at its scale: the control's scan operands."""
    scale = torch.clamp(t.abs().amax(dim=1, keepdim=True), min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def sqdist_rows(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(P, D) × (n, D) → (P, n) squared L2 distances, f32."""
    return (torch.sum(q * q, dim=1)[:, None] - 2.0 * (q @ x.T)
            + torch.sum(x * x, dim=1)[None, :])


def distances(q: torch.Tensor, xr: torch.Tensor, block: int = 262144) -> torch.Tensor:
    """(P, n) distances of the queries to the rows ``xr`` (f32 (n, D)), made
    block by block of rows."""
    out = torch.empty((q.shape[0], xr.shape[0]), dtype=torch.float32, device=q.device)
    for i0 in range(0, xr.shape[0], block):
        out[:, i0:i0 + block] = sqdist_rows(q, xr[i0:i0 + block])
    return out


def rows_fp8(xr: torch.Tensor, block: int = 262144) -> torch.Tensor:
    """``round_fp8`` of every row of xr, block by block."""
    out = torch.empty_like(xr)
    for i0 in range(0, xr.shape[0], block):
        out[i0:i0 + block] = round_fp8(xr[i0:i0 + block])
    return out


def exact_topk(q: torch.Tensor, x: torch.Tensor, k: int, block: int = 65536):
    """Exact (P, k) nearest rows of x in f32, ascending distance → ids int64."""
    best_d = best_i = None
    for i0 in range(0, x.shape[0], block):
        d = sqdist_rows(q, x[i0:i0 + block])
        dv, di = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
        di = di + i0
        if best_d is not None:
            dv, di = torch.cat([best_d, dv], 1), torch.cat([best_i, di], 1)
            dv, j = torch.topk(dv, k, dim=1, largest=False)
            di = torch.gather(di, 1, j)
        best_d, best_i = dv, di
    return best_i


def sample_batches(n: int, want: int, seed: int):
    """``want`` of ``n`` batch indices drawn from ``seed``, the first and the
    last always among them, ascending."""
    if n <= want:
        return list(range(n))
    rng = np.random.default_rng(seed)
    mid = rng.choice(np.arange(1, n - 1), size=max(0, want - 2), replace=False)
    return sorted({0, n - 1, *mid.tolist()})


def stack_answers(answers):
    """[(pool rows (B,), ids (B, k), scores (B, k))] → the three stacked."""
    return (np.concatenate([np.asarray(a[0], dtype=np.int64) for a in answers]),
            np.concatenate([np.asarray(a[1], dtype=np.int64) for a in answers]),
            np.concatenate([np.asarray(a[2], dtype=np.float32) for a in answers]))


def _judge_block(dist, rows, ids, scores, kth):
    n = dist.shape[1]
    if ids.numel() == 0:
        return 0.0, 0.0
    srt = torch.sort(ids, dim=1).values
    if bool(((ids < 0) | (ids >= n)).any()) or bool((srt[:, 1:] == srt[:, :-1]).any()):
        return BIG, BIG
    d_ids = dist[rows[:, None], ids]
    gap = torch.nan_to_num(torch.clamp(d_ids - kth[:, None], min=0), nan=BIG, posinf=BIG)
    err = torch.nan_to_num((scores - d_ids).abs(), nan=BIG, posinf=BIG)
    return float(gap.max()), float(err.max())


def judge_answers(q: torch.Tensor, xr: torch.Tensor, answers, k: int, masks=None,
                  qblock: int = 2048, ablock: int = 65536) -> dict:
    """The search's two numbers over ``answers`` [(pool rows (B,), ids (B, k),
    scores (B, k))], against the f32 distances of the pool ``q`` to the
    reference's rows ``xr`` (n, D), in row-id order:

    gap        the widest margin by which a returned row lies farther than
               the k-th nearest candidate (0 when every answer is a true
               top-k under the reference's scores up to ties); an id out of
               range, returned twice for one query, or a row of fewer than
               k ids reads ``BIG``;
    score_err  the widest |returned distance − the reference's distance of
               that row|.

    ``masks`` (one per answer, (n,) bool) restricts the candidates (an IVF
    batch's probed rows), and each answer is judged on its own; without it
    every row is one, and the pool is judged ``qblock`` queries at a time
    against every answer that asked them."""
    if any(np.asarray(a[1]).shape[1:] != (k,) for a in answers):
        return {"gap": BIG, "score_err": BIG}
    dev = q.device
    gap = err = 0.0
    if masks is None:
        rows, ids, scores = stack_answers(answers)
        srt = np.argsort(rows, kind="stable")
        cut = np.searchsorted(rows[srt], np.arange(0, q.shape[0] + qblock, qblock))
        for b, p0 in enumerate(range(0, q.shape[0], qblock)):
            if cut[b] == cut[b + 1]:
                continue
            dist = distances(q[p0:p0 + qblock], xr)
            kth = torch.topk(dist, k, dim=1, largest=False).values[:, -1]
            for s0 in range(cut[b], cut[b + 1], ablock):
                sel = srt[s0:min(cut[b + 1], s0 + ablock)]
                r = torch.as_tensor(rows[sel] - p0, device=dev)
                g, e = _judge_block(dist, r, torch.as_tensor(ids[sel], device=dev),
                                    torch.as_tensor(scores[sel], device=dev), kth[r])
                gap, err = max(gap, g), max(err, e)
            del dist
        return {"gap": gap, "score_err": err}
    for (rows, ids, scores), mask in zip(answers, masks):
        r = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=dev)
        dist = distances(q[r], xr)
        cand = torch.where(mask[None, :], dist, torch.full((1, 1), np.inf, device=dev))
        kth = torch.topk(cand, k, dim=1, largest=False).values[:, -1]
        g, e = _judge_block(dist, torch.arange(r.shape[0], device=dev),
                            torch.as_tensor(np.asarray(ids, dtype=np.int64), device=dev),
                            torch.as_tensor(np.asarray(scores, dtype=np.float32), device=dev),
                            kth)
        gap, err = max(gap, g), max(err, e)
    return {"gap": gap, "score_err": err}


def control_topk(q: torch.Tensor, xr8: torch.Tensor, k: int, mask=None):
    """The control's answers: the top-k of the queries (rounded to e4m3
    here) against rows already rounded (``rows_fp8``), products
    accumulated in f32, among ``mask``'s rows where given → (ids, scores)
    numpy."""
    dist = distances(round_fp8(q), xr8)
    if mask is not None:
        dist = torch.where(mask[None, :], dist, torch.full((1, 1), np.inf, device=q.device))
    vals, ids = torch.topk(dist, k, dim=1, largest=False)
    return ids.cpu().numpy(), vals.cpu().numpy()


def recall_at_k(gt: torch.Tensor, answers, k: int, block: int = 16384) -> float:
    """Mean |returned ∩ exact top-k| / k over every answer (``gt`` (P, k)
    int64 of the pool, answers as in ``judge_answers``)."""
    rows, ids, _ = stack_answers(answers)
    hits = 0
    for i0 in range(0, rows.shape[0], block):
        g = gt[torch.as_tensor(rows[i0:i0 + block], device=gt.device)][:, :k]
        r = torch.as_tensor(ids[i0:i0 + block, :k], device=gt.device)
        hits += int((r[:, :, None] == g[:, None, :]).any(dim=2).sum())
    return hits / max(ids[:, :k].size, 1)
