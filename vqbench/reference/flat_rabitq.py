"""Plain reference of a flat index over Extended RaBitQ codes in the packed
tile layout (B ≤ 4: tile-ordered words), searched by L2 over every row.

The fit, the encode and the layout are frozen copies of the program's
(``reference/rabitq.py``); the scan is plain: each row's estimator distance
to each judged query in f32 (``rabitq.distances``), the exact top-k of
those.

The corpus may be larger than the card (``corpora/fullrank_stream.py``), so
``judge`` works in one streamed pass over the rows, ``BLOCK`` rows at a
time (the program's pack chunk, encoded in its encode chunks, so each
block's products have the program's shapes), and never holds an (N, D)
tensor: it takes the centroid in its own chunked pass, encodes each block,
holds the program's words and factors of the block's rows against its own,
and keeps, for each judged query, its distance to each returned row and a
running top-k of its distances to every row.  It takes nothing the
program made.  ``control`` is this reference in the program's place one
precision lower: TF32 for the f32 centroid (its chunk sums as a product)
and encode, float8 e4m3 for the bf16 scan.
"""

from __future__ import annotations

import numpy as np
import torch

from vqbench.reference import common, flat_saq, rabitq, saq

TILE = 512
BLOCK = rabitq.PACK_CHUNK


def fit(x, cfg: dict, device, summed=rabitq.chunk_sum) -> rabitq.Params:
    return rabitq.fit(x, cfg["quantizer"], device, summed)


def block_layout(params: rabitq.Params, idx, nrm, t, norms):
    """A block of rows → (its (rows, D) int64 code indices, its (3, rows)
    factor rows: α, c2, the rows' norms), the scale and shift worked out
    over the block padded to whole tiles, as the program's pack chunk."""
    n = idx.shape[0]
    pad = (-n) % TILE
    if pad:
        idx = torch.nn.functional.pad(idx, (0, 0, 0, pad))
        nrm, t = torch.nn.functional.pad(nrm, (0, pad)), torch.nn.functional.pad(t, (0, pad))
    _, alpha, c2 = rabitq.scale_shift(params, idx, nrm, t)
    return idx[:n], torch.stack([alpha[:n], c2[:n], norms])


def _fit_deviation(state, params) -> float:
    """max |Δ| over max |value| of the centroid, the rotation and the levels;
    1.0 for another shape."""
    return max(flat_saq._deviation(state["centroid"], params.centroid),
               flat_saq._deviation(state["rotation"], params.rotation),
               flat_saq._deviation(state["levels"], params.levels))


class _Stages:
    """The stage numbers, accumulated block by block: the share of code
    entries the program's words hold otherwise, and the widest |Δ| of each
    factor row beside that row's largest |value|, over the rows whose codes
    agree (a row whose codes differ has other factors by right, and counts
    in ``words``; 1.0 where no row agrees)."""

    def __init__(self, state, n: int, d: int, bits: int):
        self.beff = saq.choose_beff(bits, d)
        n_pad = n + (-n) % TILE
        self.words, self.factors = state["words"], state["factors"]
        self.bad = self.total = self.rows_same = 0
        self.fdiff = self.fmax = None
        self.shapes_ok = len(self.words) == 1 and tuple(self.words[0].shape) == (
            n_pad // (32 // self.beff), d)
        self.factors_ok = tuple(self.factors.shape) == (3, n_pad)

    def add(self, i0: int, idx, fac) -> None:
        pos = torch.arange(i0, i0 + idx.shape[0], device=idx.device)
        same = torch.ones_like(pos, dtype=torch.bool)
        if self.shapes_ok:
            differ = flat_saq.word_codes(self.words[0], self.beff, pos) != idx.to(torch.int64)
            self.bad += int(differ.sum())
            self.total += differ.numel()
            same = ~differ.any(dim=1)
        self.rows_same += int(same.sum())
        if self.factors_ok:
            diff = torch.where(same[None, :], (self.factors[:, pos].to(torch.float32) - fac).abs(),
                               0.0).amax(dim=1)
            big = fac.abs().amax(dim=1)
            self.fdiff = diff if self.fdiff is None else torch.maximum(self.fdiff, diff)
            self.fmax = big if self.fmax is None else torch.maximum(self.fmax, big)

    def numbers(self) -> dict:
        words = self.bad / self.total if self.shapes_ok and self.total else 1.0
        factors = (float((self.fdiff / torch.clamp(self.fmax, min=1e-30)).max())
                   if self.factors_ok and self.rows_same else 1.0)
        return {"words": words, "factors": factors}


class _Answers(flat_saq._Answers):
    """``flat_saq._Answers`` over the estimator's distances of a block of
    rows (given whole, (judged queries, rows)) instead of decoded rows."""

    def add(self, i0: int, d: torch.Tensor) -> None:
        if not self.valid or self.q.shape[0] == 0:
            return
        i1 = i0 + d.shape[1]
        near = torch.topk(d, min(self.k, d.shape[1]), dim=1, largest=False).values
        both = torch.cat([self.best, near], dim=1)
        self.best = torch.topk(both, min(self.k, both.shape[1]), dim=1, largest=False).values
        hit = (self.ids >= i0) & (self.ids < i1)
        r, c = torch.nonzero(hit, as_tuple=True)
        self.d_ids[r, c] = d[r, self.ids[r, c] - i0]


def judge(x, q, state, answers, cfg, traffic, seed: int = 0, block: int = BLOCK) -> dict:
    """The numbers compared, each the program's output of a stage against
    this reference's own: fit (max |Δ| over max |value| of the centroid,
    the rotation and the levels), words (share of code entries, row by
    row, that the program's words hold otherwise), factors (the widest |Δ|
    of a factor row, α, c2 or the norm, over its largest |value|, on the
    rows whose codes agree), gap and
    score_err (``common.judge_answers``' definitions over
    ``traffic["judge_batches"]`` batches drawn from ``seed``, every answer
    where it is null), from one pass over x in ``block``-row blocks (a
    multiple of the encode chunk)."""
    dev, (n, d) = q.device, x.shape
    params = fit(x, cfg, dev)
    out = {"fit": _fit_deviation(state, params)}
    stages = _Stages(state, n, d, cfg["quantizer"]["num_bits"])
    if traffic.get("judge_batches"):
        answers = [answers[i] for i in common.sample_batches(len(answers),
                                                             traffic["judge_batches"], seed)]
    judged = _Answers(q, answers, traffic["k"], n)
    for i0 in range(0, n, block):
        xb = torch.as_tensor(x[i0:i0 + block]).to(device=dev, dtype=torch.float32)
        idx, nrm, t = rabitq.encode(params, xb)
        idx, fac = block_layout(params, idx, nrm, t, rabitq.row_norms(xb))
        del xb
        stages.add(i0, idx, fac)
        if judged.valid and judged.q.shape[0]:
            s_hat = params.levels[idx.long()]
            judged.add(i0, rabitq.distances(params, judged.q, s_hat, fac[0], nrm))
    out.update(stages.numbers())
    out.update(judged.numbers())
    return out


def _tf32_sum(xb: torch.Tensor) -> torch.Tensor:
    """A chunk's column sums as a product with a ones row, in TF32."""
    with common.tf32(True):
        return (torch.ones((1, xb.shape[0]), dtype=torch.float32, device=xb.device)
                @ xb)[0].to(torch.float64)


def control(x, q, cfg, traffic, batches, block: int = BLOCK):
    """This reference in the program's place, one precision lower → (the
    state in the form ``systems/flat_rabitq.py::state`` gives, answers to
    ``batches``): the centroid's sums and the encode in TF32, the scan over
    float8 operands, the words and factors written in place."""
    dev, (n, d), k = q.device, x.shape, traffic["k"]
    bits = cfg["quantizer"]["num_bits"]
    params = fit(x, cfg, dev, summed=_tf32_sum)
    block = max(TILE, block - block % TILE)  # words written a whole tile at a time
    beff = saq.choose_beff(bits, d)
    u = 32 // beff
    n_pad = n + (-n) % TILE
    words = torch.empty((n_pad // u, d), dtype=torch.int32, device=dev)
    fac = torch.empty((3, n_pad), dtype=torch.float32, device=dev)
    sizes = [len(b) for b in batches]
    qj = q[torch.as_tensor(np.concatenate(batches), device=dev)]
    best_d = torch.empty((qj.shape[0], 0), dtype=torch.float32, device=dev)
    best_i = torch.empty((qj.shape[0], 0), dtype=torch.int64, device=dev)
    for i0 in range(0, n, block):
        xb = torch.as_tensor(x[i0:i0 + block]).to(device=dev, dtype=torch.float32)
        i1 = i0 + xb.shape[0]
        with common.tf32(True):
            idx, nrm, t = rabitq.encode(params, xb)
        idx, f = block_layout(params, idx, nrm, t, rabitq.row_norms(xb))
        pad = (-idx.shape[0]) % TILE
        words[i0 // u:(i1 + pad) // u] = saq.pack_words(
            torch.nn.functional.pad(idx, (0, 0, 0, pad)), beff)
        fac[:, i0:i1] = f
        fac[:, i1:i1 + pad] = torch.tensor([[0.0], [0.0], [1.0]], device=dev)
        dist = rabitq.distances(params, qj, params.levels[idx.long()], f[0], nrm,
                                fp8=common.round_fp8)
        dv, di = torch.topk(dist, min(k, dist.shape[1]), dim=1, largest=False)
        best_d, j = torch.topk(torch.cat([best_d, dv], 1), min(k, best_d.shape[1] + dv.shape[1]),
                               dim=1, largest=False)
        best_i = torch.gather(torch.cat([best_i, di + i0], 1), 1, j)
    ids_np, vals_np = best_i.cpu().numpy(), best_d.cpu().numpy()
    cuts = np.cumsum([0] + sizes)
    answers = [(b, ids_np[c0:c1], vals_np[c0:c1])
               for b, c0, c1 in zip(batches, cuts[:-1], cuts[1:])]
    state = {"centroid": params.centroid, "rotation": params.rotation, "levels": params.levels,
             "words": (words,), "factors": fac}
    return state, answers

