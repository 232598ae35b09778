"""Plain SAQ (uniform CAQ grid, greedy allocation) and its packed layout.

Frozen copies, op for op, of the program's ``methods/saq.py`` (``_pca``,
``_blocks_table``, ``_uniform_caq_mse_table``, ``_allocate_greedy``,
``make_plan``, ``fit``, ``encode``, ``_convert_rows``), ``kernels/caq.py``
(``caq_encode``) and ``kernels/packed_scan.py`` (``choose_beff``,
``pack_words``) at commit 6e0cbc3, kept to what a uniform-grid SAQ with the
greedy allocator uses.  The bit allocation is the numpy one (the program
prefers its native copy of the same loop).  ``decode`` is plain: the
segments' values rotated back to the original space.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

TILE = 512
ENCODE_CHUNK = 65536


class Plan(NamedTuple):
    starts: Tuple[int, ...]
    lens: Tuple[int, ...]
    bits: Tuple[int, ...]


class Params(NamedTuple):
    mean: torch.Tensor  # (D,)
    rot: torch.Tensor  # (D, D)
    seg_rots: Tuple[torch.Tensor, ...]


def _pca(x):
    mean = torch.mean(x, dim=0)
    xc = x - mean
    w, v = torch.linalg.eigh(xc.T @ xc / x.shape[0])
    order = torch.argsort(-w, stable=True)
    return mean, v[:, order].contiguous(), w[order]


def _blocks_table(xb, rots, mb):
    o = torch.bmm(xb, rots)
    v_mx = torch.clamp(torch.amax(torch.abs(o), dim=2, keepdim=True), min=1e-20)
    ou = o / v_mx
    out = [torch.mean(o * o, dim=1)]
    for b in range(1, mb + 1):
        delta = 2.0 / (1 << b)
        codes = torch.clamp(torch.floor((ou + 1.0) / delta), 0, (1 << b) - 1)
        oau = (codes + 0.5) * delta - 1.0
        ip = torch.sum(ou * oau, dim=2)
        ousq = torch.sum(ou * ou, dim=2)
        rescale = torch.where(torch.abs(ip) > 1e-20, ousq / ip, torch.zeros_like(ip))
        oa = oau * rescale[..., None] * v_mx
        out.append(torch.mean((o - oa) ** 2, dim=1))
    return torch.stack(out, dim=2)


def _mse_table(x_rot, max_bits, block_dims, seed):
    d = x_rot.shape[1]
    rng = np.random.default_rng(seed)
    nfull, rem = d // block_dims, d % block_dims
    dev = x_rot.device
    cols = []
    if nfull:
        rots = np.stack([np.linalg.qr(rng.standard_normal((block_dims, block_dims)))[0]
                         for _ in range(nfull)]).astype(np.float32)
        xb = x_rot[:, : nfull * block_dims].reshape(-1, nfull, block_dims).transpose(0, 1)
        t = _blocks_table(xb.contiguous(), torch.from_numpy(rots).to(dev), max_bits)
        cols.append(t.reshape(nfull * block_dims, max_bits + 1).cpu().numpy())
    if rem:
        r = np.linalg.qr(rng.standard_normal((rem, rem)))[0].astype(np.float32)
        xb = x_rot[:, nfull * block_dims:][None].contiguous()
        t = _blocks_table(xb, torch.from_numpy(r)[None].to(dev), max_bits)
        cols.append(t.reshape(rem, max_bits + 1).cpu().numpy())
    return np.concatenate(cols, axis=0)


def _allocate_greedy(block_mse, block_lens, budget_bits, max_bits):
    nb = len(block_lens)
    bits = np.zeros(nb, dtype=np.int64)
    spent = 0
    while True:
        gains = np.full(nb, -np.inf)
        for i in range(nb):
            b = bits[i]
            if b < max_bits and spent + block_lens[i] <= budget_bits:
                gains[i] = (block_mse[i, b] - block_mse[i, b + 1]) / block_lens[i]
        best = int(np.argmax(gains))
        if not np.isfinite(gains[best]) or gains[best] <= 0:
            break
        bits[best] += 1
        spent += int(block_lens[best])
    return bits


def make_plan(d: int, mse_table, scfg: dict) -> Plan:
    block = scfg["block_dims"]
    nb = (d + block - 1) // block
    block_lens = np.array([min(block, d - i * block) for i in range(nb)], dtype=np.int64)
    block_mse = np.stack([mse_table[i * block: i * block + block_lens[i]].sum(axis=0)
                          for i in range(nb)])
    bits = _allocate_greedy(block_mse, block_lens, int(round(scfg["bits_per_dim"] * d)),
                            scfg["max_bits"])
    starts: List[int] = []
    lens: List[int] = []
    seg_bits: List[int] = []
    pos = 0
    for i in range(nb):
        ln, b = int(block_lens[i]), int(bits[i])
        if b > 0:
            if seg_bits and seg_bits[-1] == b and starts[-1] + lens[-1] == pos:
                lens[-1] += ln
            else:
                starts.append(pos)
                lens.append(ln)
                seg_bits.append(b)
        pos += ln
    if not starts:
        starts, lens, seg_bits = [0], [min(block, d)], [1]
    return Plan(tuple(starts), tuple(lens), tuple(seg_bits))


def fit(xs: torch.Tensor, scfg: dict) -> Tuple[Plan, Params]:
    """Plan and params from the training rows ``xs`` (PCA, per-block MSE
    table of the uniform CAQ encoder, greedy allocation, per-segment
    seeded rotations)."""
    if scfg["allocator"] != "greedy" or scfg["codebook"] != "uniform" or not scfg["use_pca"]:
        raise ValueError("the reference covers SAQ with PCA, the uniform grid and greedy "
                         "allocation only")
    mean, rot, _ = _pca(xs)
    x_rot = (xs - mean) @ rot
    plan = make_plan(xs.shape[1], _mse_table(x_rot, scfg["max_bits"], scfg["block_dims"],
                                             scfg["seed"]), scfg)
    rng = np.random.default_rng(scfg["seed"])
    seg_rots = tuple(
        torch.from_numpy(np.linalg.qr(rng.standard_normal((ln, ln)))[0].astype(np.float32))
        .to(xs.device) for ln in plan.lens)
    return plan, Params(mean, rot, seg_rots)


# ----------------------------------------------------------------- CAQ
def _dequant_unit(codes, bits):
    return (codes.to(torch.float32) + 0.5) * (2.0 / (1 << bits)) - 1.0


def _adjust_round(o, codes, bits, ip, l2):
    delta = 2.0 / (1 << bits)
    cmax = (1 << bits) - 1
    oa = _dequant_unit(codes, bits)
    l2_wo = l2[:, None] - oa * oa

    def gain(step):
        new_oa = oa + step * delta
        new_ip = ip[:, None] + step * delta * o
        new_l2 = l2_wo + new_oa * new_oa
        return new_ip * new_ip * l2[:, None] - ip[:, None] * ip[:, None] * new_l2

    g_up, g_dn = gain(1.0), gain(-1.0)
    can_up = (codes < cmax) & (g_up > 0)
    can_dn = (codes > 0) & (g_dn > 0)
    one = torch.ones_like(codes)
    step = torch.where(can_up & (g_up >= g_dn), one, torch.where(can_dn, -one, 0 * one))
    new_codes = torch.clamp(codes + step, 0, cmax)
    oa = _dequant_unit(new_codes, bits)
    new_ip, new_l2 = torch.sum(o * oa, dim=1), torch.sum(oa * oa, dim=1)
    better = new_ip * new_ip * l2 > ip * ip * new_l2
    return (torch.where(better[:, None], new_codes, codes), torch.where(better, new_ip, ip),
            torch.where(better, new_l2, l2))


def caq_encode(o: torch.Tensor, bits: int, rounds: int):
    """(N, L) → (codes (N, L) int32, rescale (N,)): mid-rise grid on the
    per-vector range, then ``rounds`` Jacobi ±1 rounds on cos(o, ô)."""
    o = o.to(torch.float32)
    v_safe = torch.clamp(torch.amax(torch.abs(o), dim=1), min=1e-20)
    ou = o / v_safe[:, None]
    delta = 2.0 / (1 << bits)
    codes = torch.clamp(torch.floor((ou + 1.0) / delta), 0, (1 << bits) - 1).to(torch.int32)
    oa = _dequant_unit(codes, bits)
    ip = torch.sum(ou * oa, dim=1)
    l2 = torch.sum(oa * oa, dim=1)
    for _ in range(rounds):
        codes, ip, l2 = _adjust_round(ou, codes, bits, ip, l2)
    o_l2sqr = torch.sum(ou * ou, dim=1)
    rescale_unit = torch.where(ip != 0, o_l2sqr / ip, torch.zeros_like(ip))
    return codes, rescale_unit * v_safe


def encode(plan: Plan, params: Params, x: torch.Tensor, rounds: int):
    """Rows of x in the given order → per segment ((N, ln) int32 codes,
    (N,) rescale), encoded ``ENCODE_CHUNK`` rows at a time."""
    n = x.shape[0]
    codes = [torch.empty((n, ln), dtype=torch.int32, device=x.device) for ln in plan.lens]
    scales = [torch.empty((n,), dtype=torch.float32, device=x.device) for _ in plan.lens]
    for i0 in range(0, n, ENCODE_CHUNK):
        xp = (x[i0:i0 + ENCODE_CHUNK] - params.mean) @ params.rot
        for s, (st, ln, b) in enumerate(zip(plan.starts, plan.lens, plan.bits)):
            c, r = caq_encode(xp[:, st:st + ln] @ params.seg_rots[s], b, rounds)
            codes[s][i0:i0 + c.shape[0]] = c
            scales[s][i0:i0 + c.shape[0]] = r
    return codes, scales


def values(codes: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """One segment's reconstruction in its rotated code space."""
    return _dequant_unit(codes, bits) * scale[:, None]


def decode(plan: Plan, params: Params, codes, scales, i0: int, i1: int) -> torch.Tensor:
    """Rows [i0, i1) back in the original space, f32."""
    d = params.rot.shape[0]
    xp = torch.zeros((i1 - i0, d), dtype=torch.float32, device=params.rot.device)
    for s, (st, ln, b) in enumerate(zip(plan.starts, plan.lens, plan.bits)):
        xp[:, st:st + ln] = values(codes[s][i0:i1], scales[s][i0:i1], b) @ params.seg_rots[s].T
    return xp @ params.rot.T + params.mean


# ------------------------------------------------------- packed layout
def choose_beff(bits: int, ln: int) -> int:
    beff = next(p for p in (1, 2, 4, 8, 16) if bits <= p)
    while ln % 128 != 0 and TILE // (32 // beff) < 32 and beff < 16:
        beff *= 2
    return beff


def pack_words(idx: torch.Tensor, beff: int) -> torch.Tensor:
    """(N, ln) indices, N a multiple of 512 → (N/u, ln) int32 tile-ordered
    words: within each 512-row tile, word r's shift slot j holds tile-local
    row j·(512/u) + r, u = 32 // beff."""
    n, ln = idx.shape
    u = 32 // beff
    rt = TILE // u
    idx = idx.to(torch.int64).reshape(n // TILE, u, rt, ln).transpose(1, 2)
    idx = idx.reshape(n // u, u, ln)
    shifts = beff * torch.arange(u, dtype=torch.int64, device=idx.device)
    acc = torch.sum(idx << shifts[None, :, None], dim=1)
    return torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(torch.int32)


def layout(plan: Plan, params: Params, codes, scales, norms: torch.Tensor):
    """→ (per-segment words, factors (2S+1, N_pad)): rows padded with zero
    codes and scale 0 to a multiple of 512; factor rows the segments'
    rescales, their L2 shifts 2·mean_s·r̂_s + ‖r̂_s‖², the rows' norms (1.0
    in the pad)."""
    n = norms.shape[0]
    n_pad = n + (-n) % TILE
    pad = n_pad - n
    mean_p = params.mean @ params.rot
    words, scale_rows, r2_rows = [], [], []
    for s, (st, ln, b) in enumerate(zip(plan.starts, plan.lens, plan.bits)):
        c = torch.nn.functional.pad(codes[s], (0, 0, 0, pad))
        r = torch.nn.functional.pad(scales[s], (0, pad))
        words.append(pack_words(c, choose_beff(b, ln)))
        val = values(c, r, b)
        mean_s = mean_p[st:st + ln] @ params.seg_rots[s]
        scale_rows.append(r)
        r2_rows.append(2.0 * (val @ mean_s) + torch.sum(val * val, dim=1))
    nrm = torch.ones((n_pad,), dtype=torch.float32, device=norms.device)
    nrm[:n] = norms
    return words, torch.stack(scale_rows + r2_rows + [nrm])
