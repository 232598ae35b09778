"""Sharded search and training steps over a device mesh — counterpart of
``vq_tpu/dist/sharded.py``.

The compressed corpus is row-sharded over the mesh (``mesh.shard_rows``),
codebooks and queries are replicated, each shard runs the same scan (the
port's kernels on a card) over its rows under its own device, and the
per-shard top-k candidates merge exactly at the root: an all-gather and a
final top-k (k candidates a shard ⊇ the global top-k).  Lloyd sums are
summed over the shards (``mesh.psum``).  Under a process group each rank
scans its own shards and every rank makes the same collective calls in
the same order (a call one rank skipped would leave the others waiting),
so every rank gets the merged result.

Merges keep the port's result contract: maximize-form scores, ordered by
score descending then id ascending (``kernels/topk.ordered_topk``), empty
slots −inf with id 0.  With ``overlap_chunks`` = 1 that is the order of
``lax.top_k`` over the shard-ordered candidates; the running merge of
overlap chunks orders ties by id too, so a result never depends on the
chunk count.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from vq_tpu_torch.core.config import Metric
from vq_tpu_torch.dist.mesh import Mesh, all_gather, on, psum, replicate, shard_rows, unzip
from vq_tpu_torch.kernels.adc import exact_topk, scan_codes_topk, scan_generic_topk
from vq_tpu_torch.kernels.kmeans import lloyd_partials, lloyd_update
from vq_tpu_torch.kernels.topk import ordered_topk


def per_shard(mesh: Mesh, x, rows: bool = False) -> tuple:
    """``x`` as one tensor per shard: a sequence of P tensors as it is (None
    at the shards of other ranks), else an array replicated
    (``rows=False``) or row-sharded (``rows=True``)."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} shards for a mesh of {mesh.size}")
        return tuple(x)
    return shard_rows(mesh, x) if rows else replicate(mesh, x)


def merge_topk(s_cat: torch.Tensor, i_cat: torch.Tensor, k: int,
               by_position: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of concatenated maximize-form candidates (Q, n) → (Q, k), empty
    slots −inf with id 0.  Ties go to the lower id, or with ``by_position``
    to the earlier column (``lax.top_k``'s rule), whose id is then taken."""
    num_q, n = s_cat.shape
    if n < k:  # fewer candidates than k: the missing slots are empty
        s_cat = torch.nn.functional.pad(s_cat, (0, k - n), value=-math.inf)
        i_cat = torch.nn.functional.pad(i_cat, (0, k - n), value=0)
    if by_position:
        ts, pos = ordered_topk(s_cat, k)
        ti = torch.gather(i_cat, 1, pos.long())
    else:
        ts, ti = ordered_topk(s_cat, k, i_cat)
    return ts, torch.where(ts > -math.inf, ti.to(torch.int32), torch.zeros_like(ti,
                                                                              dtype=torch.int32))


def _natural(s: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Maximize form ↔ the metric's natural value (L2 flips the sign)."""
    return -s if metric == Metric.L2 else s


def _merge_local_topk(mesh: Mesh, scores: Sequence[torch.Tensor], ids: Sequence[torch.Tensor],
                      k: int, metric: Metric):
    """All-gather the shards' natural-form (Q, k) candidates at the root and
    take the global top-k → natural-form (scores, ids) on the root."""
    ms, mi = _fold(mesh, None, [None if s is None else (_natural(s, metric), i)
                                for s, i in zip(scores, ids)], k)
    return _natural(ms, metric), mi


def _fold(mesh: Mesh, run, parts, k: int):
    """Fold the shards' maximize-form (scores, ids) into the running top-k at
    the root (``run`` None: the first chunk); ``parts`` holds None at the
    shards of other ranks."""
    with on(mesh.root):
        scores, ids = unzip(parts)
        s_all = all_gather(mesh, scores)
        i_all = all_gather(mesh, ids)
        if run is not None:
            s_all = torch.cat([run[0], s_all], dim=1)
            i_all = torch.cat([run[1], i_all], dim=1)
        return merge_topk(s_all, i_all, k)


def merge_chunks(mesh: Mesh, chunks: int, scan_chunk: Callable, k: int):
    """The maximize-form top-k over ``chunks`` chunks of every shard's rows:
    ``scan_chunk(p, c)`` → local shard p's (scores, global ids) of chunk c,
    each chunk folded into the running top-k at the root.  Chunk c+1's
    scans are issued before chunk c's merge, so on a card the merge's
    copies queue behind work already issued, not ahead of it."""
    run = None
    pending = mesh.each(lambda p: scan_chunk(p, 0))
    for c in range(chunks):
        parts = pending
        if c + 1 < chunks:
            pending = mesh.each(lambda p, c=c: scan_chunk(p, c + 1))
        run = _fold(mesh, run, parts, k)
    return run


def _sharded_scan(mesh: Mesh, queries, codes, norms, scan_fn: Callable, k: int,
                  metric: Metric, true_n: Optional[int], overlap_chunks: int,
                  extra_args: Sequence[tuple] = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared machinery of the row-sharded scans with the cross-shard merge.

    ``scan_fn(p, q, codes_c, norms_c, num_valid, *extra) → natural-form
    (scores, local ids)`` over one chunk of shard p's rows, run under shard
    p's device; ``extra_args`` holds one tuple per shard (e.g. its
    codebooks).  Pad rows (global id ≥ true_n) get −inf before the merge,
    so they never take a candidate slot.  With C = ``overlap_chunks`` > 1
    each shard scans its rows in C chunks whose candidates fold into a
    running top-k (``merge_chunks``)."""
    codes = per_shard(mesh, codes, rows=True)
    q = per_shard(mesh, queries)
    if metric == Metric.NIP and norms is None:
        raise ValueError("Metric.NIP requires norms")
    norms = per_shard(mesh, norms, rows=True) if norms is not None else (None,) * mesh.size
    extra_args = tuple(extra_args) or ((),) * mesh.size
    n_loc = codes[mesh.local_shards[0]].shape[0]
    true_n = n_loc * mesh.size if true_n is None else int(true_n)
    chunks = max(1, min(overlap_chunks, n_loc))
    while n_loc % chunks:
        chunks -= 1
    csz = n_loc // chunks

    def scan_chunk(p, c):
        row0 = c * csz
        with on(mesh.devices[p]):
            nv = min(max(true_n - p * n_loc - row0, 0), csz)
            nc = None if norms[p] is None else norms[p][row0:row0 + csz]
            s, i = scan_fn(p, q[p], codes[p][row0:row0 + csz], nc, nv, *extra_args[p])
            gid = i + (p * n_loc + row0)
            s = torch.where(gid >= true_n, torch.full_like(s, -math.inf), _natural(s, metric))
            return s, gid

    s, i = merge_chunks(mesh, chunks, scan_chunk, k)
    return _natural(s, metric), i


def sharded_scan_topk(mesh: Mesh, queries, codes, codebooks, k: int,
                      metric: Metric = Metric.L2, norms=None, true_n: Optional[int] = None,
                      tile_rows: int = 2048, use_bf16: bool = True,
                      overlap_chunks: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC search over a row-sharded PQ corpus with the cross-shard merge.

    codes: one (N_pad/P, M) tensor per local shard (``shard_rows``), or an
    (N_pad, M) array that is sharded here; ``true_n`` masks the pad rows
    (global ids ≥ true_n never surface).  Each shard runs
    ``adc.scan_codes_topk`` (on a card: the fused PQ kernel at k ≤ 128,
    the score kernel above).  Returns (Q, k) scores and GLOBAL ids on the
    mesh's root.  overlap_chunks > 1 scans each shard in chunks and merges
    each chunk's candidates into the running result (exact)."""
    cbs = per_shard(mesh, codebooks)

    def scan_fn(p, q, codes_c, norms_c, nv, cb):
        return scan_codes_topk(q, codes_c, cb, k, metric=metric, norms=norms_c,
                               tile_rows=tile_rows, use_bf16=use_bf16, num_valid=nv)

    return _sharded_scan(mesh, queries, codes, norms, scan_fn, k, metric, true_n,
                         overlap_chunks, extra_args=[(cb,) for cb in cbs])


def sharded_generic_scan_topk(mesh: Mesh, queries, codes, decode_fn, k: int,
                              metric: Metric = Metric.L2, norms=None,
                              true_n: Optional[int] = None, tile_rows: int = 4096,
                              use_bf16: bool = True,
                              overlap_chunks: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded decode→score→top-k scan for ANY quantizer: each shard runs
    ``adc.scan_generic_topk`` with the method's ``decode_fn``, and the
    candidates merge exactly across the mesh.  ``decode_fn`` is one
    callable, or one per shard (a decoder closes over parameters on one
    device: ``mesh.replicate_quantizer`` gives each shard its own)."""
    fns = tuple(decode_fn) if isinstance(decode_fn, (list, tuple)) else (decode_fn,) * mesh.size

    def scan_fn(p, q, codes_c, norms_c, nv):
        return scan_generic_topk(q, codes_c, fns[p], k, metric=metric, norms=norms_c,
                                 tile_rows=tile_rows, use_bf16=use_bf16, num_valid=nv)

    return _sharded_scan(mesh, queries, codes, norms, scan_fn, k, metric, true_n,
                         overlap_chunks)


def sharded_exact_topk(mesh: Mesh, queries, x, k: int, metric: Metric = Metric.L2,
                       true_n: Optional[int] = None,
                       tile_rows: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact brute-force top-k over a row-sharded raw corpus (the sharded
    ground truth), in f32."""
    def scan_fn(p, q, x_c, norms_c, nv):
        return exact_topk(q, x_c, k, metric=metric, tile_rows=tile_rows, num_valid=nv)

    return _sharded_scan(mesh, queries, x, None, scan_fn, k, metric, true_n, 1)


def dp_lloyd_step(mesh: Mesh, x, centroids) -> torch.Tensor:
    """One data-parallel Lloyd iteration over a row-sharded training set →
    (k, d) centroids on the root.

    Each shard sums its rows by cluster in a fixed order
    (``kmeans.lloyd_partials``: a stable sort and ``segment_reduce``), the
    partial sums and counts are summed over the shards in shard order
    (``mesh.psum``), so the step is bit-equal from run to run, and equal
    under a process group to the one-process mesh of as many shards."""
    xs = per_shard(mesh, x, rows=True)
    cs = per_shard(mesh, centroids)

    def partials(p):
        with on(mesh.devices[p]):
            return lloyd_partials(xs[p][None].to(torch.float32), cs[p][None].to(torch.float32))

    sums, counts = unzip(mesh.each(partials))
    with on(mesh.root):
        c0 = cs[mesh.local_shards[0]].to(torch.float32)[None]
        return lloyd_update(psum(mesh, sums), psum(mesh, counts), c0)[0]
