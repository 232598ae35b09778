"""CAQ encoder, batched — counterpart of ``vq_tpu/kernels/caq.py``.

The JAX package runs this as XLA code, so it is ported as plain torch:

* per-vector symmetric range v_mx = max|o_i|, mid-rise uniform code on the
  v_mx = 1 grid, ô_j = (c_j + 0.5)·δ − 1 with δ = 2/2^b;
* code adjustment maximizing cos(o, ô) by ±1 coordinate steps, as batched
  Jacobi rounds: every coordinate's ±1 test at once, then an exact
  recompute of ⟨o,ô⟩ and ‖ô‖², and the round is kept for a row only if its
  true cosine improved (the guard against interacting moves);
* two stored factors per (vector, segment): rescale = ‖o‖²/⟨o,ô⟩ (with v_mx
  folded in) and o_l2norm = ‖o‖; ``fac_error`` is the ε-bound on the
  inner-product estimate, kept for tests.

The derived-codebook variant (``*_levels``) replaces the grid by sorted
per-dimension level tables (D, L).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_CONST_EPSILON = 1.9  # the CAQ error-bound constant (kConstEpsilon)


class CAQCode(NamedTuple):
    codes: torch.Tensor  # (N, D) int32 in [0, 2^b)
    rescale: torch.Tensor  # (N,) — multiply dequantized unit-grid ô to estimate o
    o_l2norm: torch.Tensor  # (N,) — ‖o‖
    fac_error: torch.Tensor  # (N,) — ε-bound on |⟨q,o⟩ − rescale·⟨q,ô⟩|·‖o‖/‖q‖


def _dequant_unit(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Mid-rise dequantization on the v_mx=1 grid: (c + .5)·δ − 1, δ=2/2^b."""
    delta = 2.0 / (1 << bits)
    return (codes.to(torch.float32) + 0.5) * delta - 1.0


def _keep_if_better(codes, ip, l2, new_codes, new_ip, new_l2):
    """Keep a row's round only if its true cosine² improved."""
    better = new_ip * new_ip * l2 > ip * ip * new_l2
    return (torch.where(better[:, None], new_codes, codes), torch.where(better, new_ip, ip),
            torch.where(better, new_l2, l2))


def _choose_step(codes, cmax, g_up, g_dn):
    can_up = (codes < cmax) & (g_up > 0)
    can_dn = (codes > 0) & (g_dn > 0)
    one = torch.ones_like(codes)
    step = torch.where(can_up & (g_up >= g_dn), one, torch.where(can_dn, -one, 0 * one))
    return torch.clamp(codes + step, 0, cmax)


def _adjust_round(o, codes, bits, ip, l2):
    """One Jacobi adjustment round.  o: (N, D) normalized by v_mx."""
    delta = 2.0 / (1 << bits)
    cmax = (1 << bits) - 1
    oa = _dequant_unit(codes, bits)
    l2_wo = l2[:, None] - oa * oa  # ‖ô‖² without coord j

    def gain(step):
        new_oa = oa + step * delta
        new_ip = ip[:, None] + step * delta * o
        new_l2 = l2_wo + new_oa * new_oa
        return new_ip * new_ip * l2[:, None] - ip[:, None] * ip[:, None] * new_l2

    new_codes = _choose_step(codes, cmax, gain(1.0), gain(-1.0))
    oa = _dequant_unit(new_codes, bits)
    return _keep_if_better(codes, ip, l2, new_codes, torch.sum(o * oa, dim=1),
                           torch.sum(oa * oa, dim=1))


def _fac_error(o_l2sqr_lead, o_l2sqr, ip, l2, d):
    cos_term = torch.where(ip * ip > 0,
                           (o_l2sqr * l2) / torch.clamp(ip * ip, min=1e-38) - 1.0,
                           torch.zeros_like(ip))
    return o_l2sqr_lead * _CONST_EPSILON * torch.sqrt(torch.clamp(cos_term, min=0.0)
                                                      / max(d - 1, 1))


def caq_encode(o: torch.Tensor, bits: int, rounds: int = 6) -> CAQCode:
    """Encode (N, D) vectors at `bits` per dim with CAQ code adjustment.
    Reconstruction: ô = rescale · ((codes + .5)·2/2^b − 1)."""
    o = o.to(torch.float32)
    d = o.shape[1]
    v_mx = torch.amax(torch.abs(o), dim=1)
    v_safe = torch.clamp(v_mx, min=1e-20)
    ou = o / v_safe[:, None]
    delta = 2.0 / (1 << bits)
    cmax = (1 << bits) - 1
    codes = torch.clamp(torch.floor((ou + 1.0) / delta), 0, cmax).to(torch.int32)
    oa = _dequant_unit(codes, bits)
    ip = torch.sum(ou * oa, dim=1)
    l2 = torch.sum(oa * oa, dim=1)
    for _ in range(rounds):
        codes, ip, l2 = _adjust_round(ou, codes, bits, ip, l2)
    o_l2sqr = torch.sum(ou * ou, dim=1)
    rescale_unit = torch.where(ip != 0, o_l2sqr / ip, torch.zeros_like(ip))
    o_l2norm = torch.linalg.norm(o, dim=1)
    return CAQCode(codes=codes, rescale=rescale_unit * v_safe, o_l2norm=o_l2norm,
                   fac_error=_fac_error(o_l2norm ** 2, o_l2sqr, ip, l2, d))


def caq_decode(codes: torch.Tensor, rescale: torch.Tensor, bits: int) -> torch.Tensor:
    """(N, D) codes + (N,) rescale → (N, D) reconstruction of o."""
    return _dequant_unit(codes, bits) * rescale[:, None]


# ---------------------------------------------------------------------------
# derived-codebook variant: per-dim sorted level tables instead of the grid
# ---------------------------------------------------------------------------


def _dequant_levels(codes: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """(N, D) codes + (D, L) sorted level tables → (N, D) values."""
    dims = torch.arange(levels.shape[0], device=codes.device)
    return levels[dims[None, :], codes.long()]


def _adjust_round_levels(o, codes, levels, ip, l2, cmax):
    """One Jacobi round over per-dim level tables (±1 level index)."""
    oa = _dequant_levels(codes, levels)
    l2_wo = l2[:, None] - oa * oa
    ip_wo = ip[:, None] - o * oa

    def gain(step):
        v_new = _dequant_levels(torch.clamp(codes + step, 0, cmax), levels)
        new_ip = ip_wo + o * v_new
        new_l2 = l2_wo + v_new * v_new
        return new_ip * new_ip * l2[:, None] - ip[:, None] * ip[:, None] * new_l2

    new_codes = _choose_step(codes, cmax, gain(1), gain(-1))
    oa = _dequant_levels(new_codes, levels)
    return _keep_if_better(codes, ip, l2, new_codes, torch.sum(o * oa, dim=1),
                           torch.sum(oa * oa, dim=1))


def caq_encode_levels(o: torch.Tensor, levels: torch.Tensor, rounds: int = 6) -> CAQCode:
    """CAQ encode against per-dim sorted level tables (D, L): nearest level
    first, then adjustment rounds; the same two factors as ``caq_encode``."""
    o = o.to(torch.float32)
    d = o.shape[1]
    cmax = levels.shape[1] - 1
    # nearest sorted level = #midpoints ≤ o (JAX: Σ o >= mids)
    mids = (0.5 * (levels[:, 1:] + levels[:, :-1])).contiguous()  # (D, L-1)
    codes = torch.searchsorted(mids, o.T.contiguous(), right=True).T.to(torch.int32)
    oa = _dequant_levels(codes, levels)
    ip = torch.sum(o * oa, dim=1)
    l2 = torch.sum(oa * oa, dim=1)
    for _ in range(rounds):
        codes, ip, l2 = _adjust_round_levels(o, codes, levels, ip, l2, cmax)
    o_l2sqr = torch.sum(o * o, dim=1)
    rescale = torch.where(ip != 0, o_l2sqr / ip, torch.zeros_like(ip))
    return CAQCode(codes=codes, rescale=rescale, o_l2norm=torch.sqrt(o_l2sqr),
                   fac_error=_fac_error(o_l2sqr, o_l2sqr, ip, l2, d))


def caq_decode_levels(codes: torch.Tensor, rescale: torch.Tensor,
                      levels: torch.Tensor) -> torch.Tensor:
    """(N, D) codes + (N,) rescale + (D, L) levels → (N, D) estimate of o."""
    return _dequant_levels(codes, levels) * rescale[:, None]


def caq_cosine(o: torch.Tensor, codes: torch.Tensor, bits: int) -> torch.Tensor:
    """cos(o, ô) per vector — the quantity code adjustment maximizes."""
    oa = _dequant_unit(codes, bits)
    ip = torch.sum(o * oa, dim=1)
    return ip / torch.clamp(torch.linalg.norm(o, dim=1) * torch.linalg.norm(oa, dim=1),
                            min=1e-20)
