"""Plain reference of an IVF index over flat-encoded SAQ codes in the
packed tile layout, searched by L2 with the probed-tile semantics: a
batch's candidates are all rows of the 512-row tiles (rows sorted by
coarse cell) that overlap a cell some query of the batch probes.

The coarse pass, the SAQ fit, the encode and the packed layout are frozen
copies of the program's (``reference/kmeans.py``, ``reference/saq.py``);
the scan is plain: every row decoded to f32, its squared distance to each
query, the exact top-k among the batch's candidates.

``judge`` works every stage out again from the rows and the seeds alone and
holds the program's output of each stage against its own: the coarse
centroids and the SAQ fit against its fits; the layout (rows in cell
order) against its assignment to its own centroids; the codes in the
packed words and the factors, row by row, against its encode with its own
fit; the answers against the distances of its own decoded rows, among the
candidates of its own routing.  It takes nothing the program made.
``control`` is this reference in the program's place one precision lower:
TF32 for the f32 stages, float8 e4m3 for the bf16 scan.
"""

from __future__ import annotations

import numpy as np
import torch

from vqbench.reference import common, kmeans, saq

SAQ_SAMPLE = 200_000  # rows the program's SAQ fit trains on


def coarse(x: torch.Tensor, icfg: dict) -> torch.Tensor:
    """min(K, N // 2) centroids: Lloyd on max(200,000, 256·K) rows."""
    km = icfg["kmeans"]
    k = min(icfg["num_clusters"], max(1, x.shape[0] // 2))
    cap = min(x.shape[0], max(200_000, km["max_points_per_centroid"] * k))
    xs = kmeans.sample_rows(x, cap, km["seed"])
    return kmeans.kmeans_batched(kmeans.generator(km["seed"], x.device), xs[None], k,
                                 km["iters"], km["max_points_per_centroid"],
                                 km["init"])[0].contiguous()


def fit_saq(x: torch.Tensor, cfg: dict):
    return saq.fit(kmeans.sample_rows(x, SAQ_SAMPLE, cfg["ivf"]["kmeans"]["seed"]),
                   cfg["quantizer"])


def tile_ranges(asn_sorted: torch.Tensor):
    """First and last cell of each 512-row tile of cell-sorted rows."""
    n = asn_sorted.shape[0]
    starts = torch.arange(-(-n // saq.TILE), device=asn_sorted.device) * saq.TILE
    return asn_sorted[starts], asn_sorted[torch.clamp(starts + saq.TILE, max=n) - 1]


def candidates(qb, centroids, nprobe, first, last, order) -> torch.Tensor:
    """(n,) bool by row id: the rows of every tile that overlaps a cell
    probed by some query of the batch ``qb``."""
    k_cl = centroids.shape[0]
    probes = torch.topk(-kmeans.sqdist(qb, centroids), min(nprobe, k_cl), dim=1).indices
    probed = torch.zeros((k_cl,), dtype=torch.bool, device=qb.device)
    probed[probes.reshape(-1)] = True
    pref = torch.cumsum(probed.to(torch.int64), 0)
    lo = torch.where(first > 0, pref[(first - 1).clamp(min=0)], torch.zeros_like(first))
    tiles = pref[last] - lo > 0
    n = order.shape[0]
    mask = torch.empty((n,), dtype=torch.bool, device=qb.device)
    mask[order] = tiles.repeat_interleave(saq.TILE)[:n]
    return mask


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


def _is_permutation(ids: torch.Tensor, n: int) -> bool:
    return tuple(ids.shape) == (n,) and bool(
        (torch.sort(ids).values == torch.arange(n, device=ids.device)).all())


def unpack_words(words: torch.Tensor, beff: int, n_pad: int) -> torch.Tensor:
    """``saq.pack_words``'s inverse: (n_pad/u, ln) int32 words → (n_pad, ln)
    int64 indices, by position."""
    u = 32 // beff
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = beff * torch.arange(u, dtype=torch.int64, device=words.device)
    idx = (w[:, None, :] >> shifts[None, :, None]) & ((1 << beff) - 1)
    return idx.reshape(n_pad // saq.TILE, saq.TILE // u, u, -1).transpose(1, 2).reshape(n_pad, -1)


def _code_mismatch(state, plan, codes, order, prog_order) -> float:
    """Share of code entries, row by row, in which the program's packed
    words differ from this reference's codes (1.0 for another shape)."""
    n = order.shape[0]
    n_pad = n + (-n) % saq.TILE
    pw = state["words"]
    if len(pw) != len(plan.lens):
        return 1.0
    bad = total = 0
    for s, (ln, b) in enumerate(zip(plan.lens, plan.bits)):
        u = 32 // saq.choose_beff(b, ln)
        if tuple(pw[s].shape) != (n_pad // u, ln):
            return 1.0
        prog = torch.empty((n, ln), dtype=torch.int64, device=order.device)
        prog[prog_order] = unpack_words(pw[s], 32 // u, n_pad)[:n]
        ref = torch.empty_like(prog)
        ref[order] = codes[s].to(torch.int64)
        bad += int((prog != ref).sum())
        total += prog.numel()
    return bad / total


def _factor_deviation(prog_fac, fac, order, prog_order) -> float:
    """The widest |Δ| of a factor row, row by row, over that factor row's
    largest |value| (1.0 for another shape)."""
    if tuple(prog_fac.shape) != tuple(fac.shape):
        return 1.0
    n = order.shape[0]
    prog = torch.empty((fac.shape[0], n), dtype=torch.float32, device=fac.device)
    prog[:, prog_order] = prog_fac[:, :n].to(torch.float32)
    ref = torch.empty_like(prog)
    ref[:, order] = fac[:, :n]
    scale = torch.clamp(ref.abs().amax(dim=1), min=1e-30)
    return float(((prog - ref).abs().amax(dim=1) / scale).max())


def decoded_rows(plan, params, codes, scales, order, block: int = 131072) -> torch.Tensor:
    """Every row decoded to f32, in row-id order."""
    n = order.shape[0]
    xr = torch.empty((n, params.rot.shape[0]), dtype=torch.float32, device=order.device)
    for i0 in range(0, n, block):
        i1 = min(n, i0 + block)
        xr[order[i0:i1]] = saq.decode(plan, params, codes, scales, i0, i1)
    return xr


def build(x: torch.Tensor, cfg: dict):
    """This reference's index: centroids, the rows' cells, their cell
    order, the SAQ fit, the codes in that order, tile ranges."""
    cent = coarse(x, cfg["ivf"])
    asn = kmeans.assign(x, cent)
    order = torch.argsort(asn, stable=True)
    plan, params = fit_saq(x, cfg)
    codes, scales = saq.encode(plan, params, x[order], cfg["quantizer"]["caq_rounds"])
    first, last = tile_ranges(asn[order])
    return cent, asn, order, plan, params, codes, scales, first, last


def judge(x, q, state, answers, cfg, traffic, seed: int = 0) -> dict:
    """The numbers compared, each the program's output of a stage against
    this reference's own: centroids and fit (max |Δ| over max |value|, an
    eigenvector at its sign, 1.0 for another plan), layout (share of
    sorted positions whose row lies, by this reference's assignment, in
    another cell than the row this reference's stable sort puts there; 1.0
    if the program's order is no permutation), words (share of code
    entries, row by row, that the program's packed words hold otherwise),
    factors (the widest |Δ| of a factor row, row by row, over its largest
    |value|), gap and score_err (``common.judge_answers`` on
    ``traffic["judge_batches"]`` batches drawn from ``seed``)."""
    cent, asn, order, plan, params, codes, scales, first, last = build(x, cfg)
    out = {"centroids": _deviation(state["centroids"], cent),
           "fit": _fit_deviation(state, plan, params)}
    prog_order = state["ids_sorted"].long()
    if _is_permutation(prog_order, x.shape[0]):
        out["layout"] = float((asn[prog_order] != asn[order]).float().mean())
        out["words"] = _code_mismatch(state, plan, codes, order, prog_order)
        _, fac = saq.layout(plan, params, codes, scales, torch.linalg.norm(x[order], dim=1))
        out["factors"] = _factor_deviation(state["factors"], fac, order, prog_order)
        del fac
    else:
        out.update(layout=1.0, words=1.0, factors=1.0)
    del asn
    xr = decoded_rows(plan, params, codes, scales, order)
    del codes, scales
    picked = common.sample_batches(len(answers), traffic["judge_batches"], seed)
    sub = [answers[i] for i in picked]
    masks = [candidates(q[torch.as_tensor(np.asarray(a[0]), device=q.device)], cent,
                        traffic["nprobe"], first, last, order) for a in sub]
    out.update(common.judge_answers(q, xr, sub, traffic["k"], masks))
    return out


def control(x, q, cfg, traffic, batches):
    """This reference in the program's place, one precision lower → (the
    state in the form ``systems/ivf_packed_saq.py::state`` gives, answers
    to ``batches``)."""
    with common.tf32(True):
        cent, _, order, plan, params, codes, scales, first, last = build(x, cfg)
        words, fac = saq.layout(plan, params, codes, scales, torch.linalg.norm(x[order], dim=1))
        masks = [candidates(q[torch.as_tensor(b, device=q.device)], cent, traffic["nprobe"],
                            first, last, order) for b in batches]
    xr8 = common.rows_fp8(decoded_rows(plan, params, codes, scales, order))
    answers = [(b, *common.control_topk(q[torch.as_tensor(b, device=q.device)], xr8,
                                        traffic["k"], mask))
               for b, mask in zip(batches, masks)]
    state = {"centroids": cent, "ids_sorted": order, "plan": tuple(plan), "mean": params.mean,
             "rot": params.rot, "seg_rots": params.seg_rots, "words": words, "factors": fac}
    return state, answers
