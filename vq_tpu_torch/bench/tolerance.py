"""The bar at which a hand-written kernel agrees with its plain PyTorch
version in f32 mode — shared by ``chip_smoke.py`` and the headline's
``exactness_assert`` (``bench/headline.py``).

Kernel and plain scores differ only in the order of their f32 sums (PQ:
per-subspace table entries vs one length-D dot product; packed: the same
products, summed by another tiling).  The rounding error of a sum is
relative to the magnitude of its terms, not of the result (an L2 score
2·q·x̂ − ‖x̂‖² can be near 0 while its terms are not); for D=1536 the worst
case is ~D·2⁻²⁴ ≈ 1e-4 of that magnitude.  So scores agree within
``F32_RTOL`` times a per-query bound on |terms|, and ids must agree only
where the scores are separated by more than that.
"""

from __future__ import annotations

import torch

from vq_tpu_torch.kernels import packed_scan as pk

F32_RTOL = 1e-4


def f32_tol(q: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """(Q, 1) tolerance of a PQ scan: F32_RTOL · (‖q‖² + 2·Σ_m max_c
    ‖c_mc‖²), which bounds |2·q·x̂| + ‖x̂‖² for every row."""
    x_max = torch.sum(torch.amax(torch.sum(cb * cb, dim=-1), dim=-1))
    return F32_RTOL * (torch.sum(q * q, dim=1, keepdim=True) + 2.0 * x_max)


def packed_tol(a: dict) -> torch.Tensor:
    """(Q, 1) f32 tolerance of a packed scan (``a``: packed_scan_topk's
    arguments): F32_RTOL times a bound on the magnitude of the score's terms,
    c·‖q‖·max‖x̂‖ + |qa| (+ max |L2 shift|; over the least row norm for NIP),
    x̂ a row's scaled values."""
    fac = a["factors"]
    n = fac.shape[1]
    r2 = torch.zeros((n,), device=fac.device)
    li = 0
    for w, seg in zip(a["words"], a["segs"]):
        lv = None
        if seg.dequant in ("perdim", "shared"):
            lv, li = a["lv_tables"][li], li + 1
        for r0 in range(0, n, 16384):
            r1 = min(n, r0 + 16384)
            rows = w[r0:r1] if seg.dequant == "values" else w[r0 // seg.u:r1 // seg.u]
            scale = fac[seg.scale_col, r0:r1] if seg.scale_col >= 0 else None
            r2[r0:r1] += torch.sum(pk.dequant_seg(rows, seg, lv, scale) ** 2, dim=1)
    qx = torch.linalg.norm(a["q_cat"], dim=1, keepdim=True) * torch.sqrt(r2.max())
    qa = a["qa"].abs()[:, None]
    if a["metric_kind"] == "l2":
        shift = sum(fac[c] for c in a["r2_cols"]).abs().max()
        return F32_RTOL * (2.0 * qx + qa + shift)
    tol = F32_RTOL * (qx + qa)
    if a["metric_kind"] == "nip":
        tol = tol / torch.clamp(fac[a["norm_col"]], min=1e-30).min()
    return tol


def topk_agreement(got_s, got_i, ref_s, ref_i, k: int, tol) -> dict:
    """A kernel's top-k (got_*) against the plain version's top-(k+1)
    (ref_*), maximize form: ``scores`` — every score within ``tol`` (the
    largest error in ``err``); ``sets`` — the id sets equal at every query
    whose k-th/(k+1)-th gap exceeds ``tol``; ``order`` — the ids equal
    position by position at every query whose adjacent gaps all do;
    ``separated`` / ``ordered`` count those queries."""
    err = (got_s - ref_s[:, :k]).abs()
    gaps = ref_s[:, :-1] - ref_s[:, 1:]
    sep = (gaps[:, k - 1:k] > tol)[:, 0]
    sets_eq = (torch.sort(got_i, 1).values == torch.sort(ref_i[:, :k], 1).values).all(1)
    ordered = (gaps[:, :k] > tol).all(1)
    pos_eq = (got_i == ref_i[:, :k]).all(1)
    return dict(err=float(err.max()) if err.numel() else 0.0,
                worst=float((err / tol).max()) if err.numel() else 0.0,
                scores=bool((err <= tol).all()), sets=bool((sets_eq | ~sep).all()),
                order=bool((pos_eq | ~ordered).all()), separated=int(sep.sum()),
                ordered=int(ordered.sum()))
