"""Plain reference of a flat index over SAQ codes in the norm-ordered
packed tile layout, searched by L2 over every row.

The SAQ fit, the encode and the packed layout are frozen copies of the
program's (``reference/saq.py``; the row sampler below is that of
``vq_tpu_torch/data/sampling.py::host_sample_rows``); the norm order is the
program's stable sort by Σ_s ‖o_s‖², the segments' rotated inputs' squared
norms (``methods/saq.py::_row_norm_key``); the scan is plain: every row
decoded to f32, its squared distance to each judged query, the exact
top-k.

The corpus may be larger than the card (``corpora/fullrank_stream.py``), so
``judge`` works in one streamed pass over the rows, ``BLOCK`` rows at a
time (the program's encode chunk, so each block's products have the
program's shapes), and never holds an (N, D) tensor: it fits SAQ again on
its own sample, encodes each block, holds the program's packed words and
factors of the block's rows (found through the program's ``perm``)
against its own, decodes the block and keeps, for each judged query, its
distance to each returned row and a running top-k of its distances to
every row.  It takes nothing the program made.  ``control`` is this
reference in the program's place one precision lower: TF32 for the f32
fit and encode, float8 e4m3 for the bf16 scan.
"""

from __future__ import annotations

import numpy as np
import torch

from vqbench.reference import common, kmeans, saq

SAQ_SAMPLE = 200_000  # rows the program's SAQ fit trains on
BLOCK = saq.ENCODE_CHUNK
QBLOCK = 2048  # judged queries a distance block


def sample_rows(x, cap: int, seed: int, device) -> torch.Tensor:
    """≤ cap rows of x as f32 on ``device``: a tensor's drawn on its device
    (``kmeans.sample_rows``), any other row source's by the sorted draw
    ``default_rng(seed).choice(n, cap, replace=False)``."""
    if isinstance(x, torch.Tensor):
        return kmeans.sample_rows(x, cap, seed).to(device)
    n = x.shape[0]
    rows = x[:] if n <= cap else x[np.sort(np.random.default_rng(seed).choice(n, cap,
                                                                          replace=False))]
    return torch.as_tensor(rows).to(device=device, dtype=torch.float32)


def fit(x, cfg: dict, device):
    q = cfg["quantizer"]
    return saq.fit(sample_rows(x, SAQ_SAMPLE, q["seed"], device), q)


def encode_block(plan, params, xb: torch.Tensor, rounds: int):
    """Rows → (per segment (n, ln) int32 codes, per segment (n,) rescales,
    the (n,) norm keys Σ_s ‖o_s‖² in segment order), op for op as
    ``saq.encode`` on one chunk."""
    xp = (xb.to(torch.float32) - params.mean) @ params.rot
    codes, scales = [], []
    key = torch.zeros((xb.shape[0],), dtype=torch.float32, device=xb.device)
    for s, (st, ln, b) in enumerate(zip(plan.starts, plan.lens, plan.bits)):
        o = xp[:, st:st + ln] @ params.seg_rots[s]
        c, r = saq.caq_encode(o, b, rounds)
        nrm = torch.linalg.norm(o, dim=1)
        key = key + nrm * nrm
        codes.append(c)
        scales.append(r)
    return codes, scales, key


def block_factors(plan, params, codes, scales, norms: torch.Tensor) -> torch.Tensor:
    """(2S+1, n) factor rows of ``saq.layout`` for rows in any order: the
    rescales, the L2 shifts 2·mean_s·r̂_s + ‖r̂_s‖², the rows' norms."""
    mean_p = params.mean @ params.rot
    r2 = []
    for s, (st, ln, b) in enumerate(zip(plan.starts, plan.lens, plan.bits)):
        val = saq.values(codes[s], scales[s], b)
        r2.append(2.0 * (val @ (mean_p[st:st + ln] @ params.seg_rots[s]))
                  + torch.sum(val * val, dim=1))
    return torch.stack(list(scales) + r2 + [norms])


def _deviation(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |Δ| over max |ref|; 1.0 for another shape."""
    if tuple(prog.shape) != tuple(ref.shape):
        return 1.0
    return float((prog.to(torch.float32) - ref).abs().max() / ref.abs().max())


def _fit_deviation(state, plan, params) -> float:
    if tuple(map(tuple, state["plan"])) != tuple(map(tuple, plan)):
        return 1.0
    mean = _deviation(state["mean"], params.mean)
    # an eigenvector's sign is arbitrary: compare each column at its sign
    sign = torch.where(torch.sum(state["rot"] * params.rot, dim=0) < 0, -1.0, 1.0)
    rot = float((state["rot"] - sign * params.rot).abs().max())
    segs = max(float((a - b).abs().max()) for a, b in zip(state["seg_rots"], params.seg_rots))
    return max(mean, rot, segs)


def scan_order(keys: torch.Tensor) -> torch.Tensor:
    """Scan position → row id: the stable sort by norm key (rows in their
    order up to one tile, as the program leaves them)."""
    if keys.shape[0] <= saq.TILE:
        return torch.arange(keys.shape[0], device=keys.device)
    return torch.argsort(keys, stable=True)


def _positions(state, n: int, device):
    """(the program's scan order as int64, its inverse), or None when its
    ``perm`` is no permutation of the n rows."""
    perm = state["perm"]
    order = (torch.arange(n, device=device) if perm is None
             else torch.as_tensor(perm, device=device).to(torch.int64))
    if tuple(order.shape) != (n,) or not bool(
            (torch.sort(order).values == torch.arange(n, device=device)).all()):
        return None
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=device)
    return order, inv


def word_codes(words: torch.Tensor, beff: int, pos: torch.Tensor) -> torch.Tensor:
    """The (len(pos), ln) int64 indices that ``saq.pack_words``'s words hold
    at scan positions ``pos``: within a 512-row tile, position l lies in
    word row l mod 512/u, shift slot l div 512/u, u = 32 // beff."""
    rt = saq.TILE // (32 // beff)
    local = pos % saq.TILE
    w = words[(pos // saq.TILE) * rt + local % rt].to(torch.int64) & 0xFFFFFFFF
    return (w >> (beff * (local // rt))[:, None]) & ((1 << beff) - 1)


class _Stages:
    """The stage numbers, accumulated block by block: the share of code
    entries the program's words hold otherwise, and the widest |Δ| of each
    factor row beside that row's largest |value|."""

    def __init__(self, state, plan, n: int):
        self.plan, self.n_pad = plan, n + (-n) % saq.TILE
        self.words, self.factors = state["words"], state["factors"]
        self.bad = self.total = 0
        self.fdiff = self.fmax = None
        self.shapes_ok = len(self.words) == len(plan.lens) and all(
            tuple(w.shape) == (self.n_pad // (32 // saq.choose_beff(b, ln)), ln)
            for w, ln, b in zip(self.words, plan.lens, plan.bits))
        self.factors_ok = tuple(self.factors.shape) == (2 * len(plan.lens) + 1, self.n_pad)

    def add(self, pos, codes, fac) -> None:
        if self.shapes_ok:
            for s, (w, ln, b) in enumerate(zip(self.words, self.plan.lens, self.plan.bits)):
                got = word_codes(w, saq.choose_beff(b, ln), pos)
                self.bad += int((got != codes[s].to(torch.int64)).sum())
                self.total += got.numel()
        if self.factors_ok:
            diff = (self.factors[:, pos].to(torch.float32) - fac).abs().amax(dim=1)
            big = fac.abs().amax(dim=1)
            self.fdiff = diff if self.fdiff is None else torch.maximum(self.fdiff, diff)
            self.fmax = big if self.fmax is None else torch.maximum(self.fmax, big)

    def numbers(self) -> dict:
        words = self.bad / self.total if self.shapes_ok and self.total else 1.0
        factors = (float((self.fdiff / torch.clamp(self.fmax, min=1e-30)).max())
                   if self.factors_ok and self.fdiff is not None else 1.0)
        return {"words": words, "factors": factors}


class _Answers:
    """The judged answers against the reference's distances, streamed over
    blocks of decoded rows: each judged query's distance to each row it was
    given and its running k nearest distances (``common.judge_answers``'
    ``gap`` and ``score_err`` at the end)."""

    def __init__(self, q, answers, k: int, n: int):
        dev = q.device
        self.k = k
        self.valid = bool(answers) and all(np.asarray(a[1]).shape[1:] == (k,) for a in answers)
        if not self.valid:
            return
        rows, ids, scores = common.stack_answers(answers)
        self.ids = torch.as_tensor(ids, device=dev)
        srt = torch.sort(self.ids, dim=1).values
        self.valid = not bool(((self.ids < 0) | (self.ids >= n)).any()) and not bool(
            (srt[:, 1:] == srt[:, :-1]).any())
        self.q = q[torch.as_tensor(rows, device=dev)]
        self.scores = torch.as_tensor(scores, device=dev)
        self.d_ids = torch.full(self.ids.shape, np.nan, dtype=torch.float32, device=dev)
        self.best = torch.empty((self.q.shape[0], 0), dtype=torch.float32, device=dev)

    def add(self, i0: int, xr: torch.Tensor) -> None:
        if not self.valid or self.q.shape[0] == 0:
            return
        i1 = i0 + xr.shape[0]
        for p0 in range(0, self.q.shape[0], QBLOCK):
            p1 = min(self.q.shape[0], p0 + QBLOCK)
            d = common.sqdist_rows(self.q[p0:p1], xr)
            near = torch.topk(d, min(self.k, d.shape[1]), dim=1, largest=False).values
            both = torch.cat([self.best[p0:p1], near], dim=1)
            keep = torch.topk(both, min(self.k, both.shape[1]), dim=1, largest=False).values
            if p0 == 0:
                best = torch.empty((self.q.shape[0], keep.shape[1]), dtype=torch.float32,
                                   device=d.device)
            best[p0:p1] = keep
            ids = self.ids[p0:p1]
            hit = (ids >= i0) & (ids < i1)
            r, c = torch.nonzero(hit, as_tuple=True)
            self.d_ids[p0:p1][r, c] = d[r, ids[r, c] - i0]
        self.best = best

    def numbers(self) -> dict:
        if not self.valid:
            return {"gap": common.BIG, "score_err": common.BIG}
        if self.ids.numel() == 0:
            return {"gap": 0.0, "score_err": 0.0}
        kth = self.best[:, -1]
        gap = torch.nan_to_num(torch.clamp(self.d_ids - kth[:, None], min=0), nan=common.BIG,
                               posinf=common.BIG)
        err = torch.nan_to_num((self.scores - self.d_ids).abs(), nan=common.BIG,
                               posinf=common.BIG)
        return {"gap": float(gap.max()), "score_err": float(err.max())}


def judge(x, q, state, answers, cfg, traffic, seed: int = 0, block: int = BLOCK) -> dict:
    """The numbers compared, each the program's output of a stage against
    this reference's own: fit (max |Δ| over max |value|, an eigenvector at
    its sign, 1.0 for another plan), layout (share of scan positions whose
    row's norm key differs from the key of the row this reference's stable
    sort puts there; 1.0 if the program's order is no permutation), words
    (share of code entries, row by row, that the program's packed words
    hold otherwise), factors (the widest |Δ| of a factor row, row by row,
    over its largest |value|), gap and score_err (``common.judge_answers``'
    definitions over ``traffic["judge_batches"]`` batches drawn from
    ``seed``, every answer where it is null), from one pass over x in
    ``block``-row blocks."""
    dev, n = q.device, x.shape[0]
    plan, params = fit(x, cfg, dev)
    out = {"fit": _fit_deviation(state, plan, params)}
    order = _positions(state, n, dev)
    stages = _Stages(state, plan, n) if order is not None else None
    if traffic.get("judge_batches"):
        answers = [answers[i] for i in common.sample_batches(len(answers),
                                                             traffic["judge_batches"], seed)]
    judged = _Answers(q, answers, traffic["k"], n)
    keys = torch.empty((n,), dtype=torch.float32, device=dev)
    for i0 in range(0, n, block):
        xb = torch.as_tensor(x[i0:i0 + block]).to(device=dev, dtype=torch.float32)
        i1 = i0 + xb.shape[0]
        codes, scales, key = encode_block(plan, params, xb, cfg["quantizer"]["caq_rounds"])
        keys[i0:i1] = key
        if stages is not None:
            stages.add(order[1][i0:i1], codes,
                       block_factors(plan, params, codes, scales, torch.linalg.norm(xb, dim=1)))
        del xb
        judged.add(i0, saq.decode(plan, params, codes, scales, 0, i1 - i0))
    if stages is None:
        out.update(layout=1.0, words=1.0, factors=1.0)
    else:
        out["layout"] = float((keys[order[0]] != keys[scan_order(keys)]).float().mean())
        out.update(stages.numbers())
    out.update(judged.numbers())
    return out


def control(x, q, cfg, traffic, batches, block: int = BLOCK):
    """This reference in the program's place, one precision lower → (the
    state in the form ``systems/flat_saq.py::state`` gives, answers to
    ``batches``): fit and encode in TF32, the scan over float8 rows, and
    the packed layout in its own norm order, built from its codes kept a
    byte an entry."""
    dev, n, k = q.device, x.shape[0], traffic["k"]
    with common.tf32(True):
        plan, params = fit(x, cfg, dev)
    codes8 = [torch.empty((n, ln), dtype=torch.uint8, device=dev) for ln in plan.lens]
    scales = [torch.empty((n,), dtype=torch.float32, device=dev) for _ in plan.lens]
    keys = torch.empty((n,), dtype=torch.float32, device=dev)
    norms = torch.empty((n,), dtype=torch.float32, device=dev)
    sizes = [len(b) for b in batches]
    q8 = common.round_fp8(q[torch.as_tensor(np.concatenate(batches), device=dev)])
    best_d = torch.empty((q8.shape[0], 0), dtype=torch.float32, device=dev)
    best_i = torch.empty((q8.shape[0], 0), dtype=torch.int64, device=dev)
    for i0 in range(0, n, block):
        xb = torch.as_tensor(x[i0:i0 + block]).to(device=dev, dtype=torch.float32)
        i1 = i0 + xb.shape[0]
        with common.tf32(True):
            codes, sc, key = encode_block(plan, params, xb, cfg["quantizer"]["caq_rounds"])
        keys[i0:i1] = key
        norms[i0:i1] = torch.linalg.norm(xb, dim=1)
        for s in range(len(plan.lens)):
            codes8[s][i0:i1], scales[s][i0:i1] = codes[s].to(torch.uint8), sc[s]
        d = common.sqdist_rows(q8, common.round_fp8(saq.decode(plan, params, codes, sc, 0,
                                                               i1 - i0)))
        dv, di = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
        best_d, j = torch.topk(torch.cat([best_d, dv], 1), min(k, best_d.shape[1] + dv.shape[1]),
                               dim=1, largest=False)
        best_i = torch.gather(torch.cat([best_i, di + i0], 1), 1, j)
    order = scan_order(keys)
    n_pad = n + (-n) % saq.TILE
    words = [torch.empty((n_pad // (32 // saq.choose_beff(b, ln)), ln), dtype=torch.int32,
                         device=dev) for ln, b in zip(plan.lens, plan.bits)]
    fac = torch.empty((2 * len(plan.lens) + 1, n_pad), dtype=torch.float32, device=dev)
    step = max(saq.TILE, block - block % saq.TILE)  # layout chunks of whole tiles
    with common.tf32(True):
        for p0 in range(0, n, step):
            ids = order[p0:p0 + step]
            w, f = saq.layout(plan, params, [c[ids].to(torch.int32) for c in codes8],
                              [r[ids] for r in scales], norms[ids])
            for s, (ln, b) in enumerate(zip(plan.lens, plan.bits)):
                u = 32 // saq.choose_beff(b, ln)
                words[s][p0 // u:p0 // u + w[s].shape[0]] = w[s]
            fac[:, p0:p0 + f.shape[1]] = f
    del codes8
    ids_np, vals_np = best_i.cpu().numpy(), best_d.cpu().numpy()
    cuts = np.cumsum([0] + sizes)
    answers = [(b, ids_np[c0:c1], vals_np[c0:c1])
               for b, c0, c1 in zip(batches, cuts[:-1], cuts[1:])]
    state = {"plan": tuple(plan), "mean": params.mean, "rot": params.rot,
             "seg_rots": params.seg_rots, "words": tuple(words), "factors": fac,
             "perm": order.to(torch.int32)}
    return state, answers
