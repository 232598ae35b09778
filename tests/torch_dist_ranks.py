"""The rank program of ``tests/test_torch_dist_multiprocess.py``.

``run_rank`` is the target of each spawned process: it joins a gloo group
through ``vq_tpu_torch.dist.maybe_init_distributed`` (a ``file://``
rendezvous, so parallel test workers never share a port), builds a CPU mesh
of its own shards that spans the group, runs ``run_cases`` and writes what
each case returned to ``rank<r>.pt``.  The test runs the same
``run_cases`` on a one-process mesh of as many shards and compares.

This module imports torch, numpy and the port only: a spawned process
re-imports it, and must not import JAX.
"""

from __future__ import annotations

import os
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

# what every rank of a group runs and returns, in this order; each a case
# of the tests
CASES = (
    "all_gather", "psum",
    "scan L2 k=10", "scan L2 k=10 overlap 2", "scan L2 k=256", "scan IP k=20 overlap 2",
    "scan NIP k=10",
    "generic NIP k=10", "generic NIP k=10 overlap 2",
    "exact k=10",
    "dp_lloyd_step",
    "ShardedFlatPQIndex (given codebooks)", "ShardedFlatPQIndex NIP (own fit)",
    "ShardedFlatIndex SQ overlap 2",
    "ShardedPackedFlatIndex SAQ", "ShardedPackedFlatIndex SAQ overlap 2",
    "ShardedIVFIndex SQ union", "ShardedIVFIndex SQ windows",
    "ShardedIvfPackedIndex SAQ",
)


def make_inputs(seed: int = 0) -> dict:
    """Seeded host inputs: a ragged PQ corpus (N=2003, D=32, Q=9) and a
    packed one (N=3000, D=64, lognormal row scale)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2003, 32)).astype(np.float32)
    q = rng.standard_normal((9, 32)).astype(np.float32)
    xb = (rng.standard_normal((3000, 64)) * np.exp(0.5 * rng.standard_normal((3000, 1)))
          ).astype(np.float32)
    qb = (xb[rng.integers(0, 3000, 9)] + 0.1 * rng.standard_normal((9, 64))).astype(np.float32)
    return dict(x=x, q=q, xb=xb, qb=qb)


def run_cases(mesh, inp: dict) -> dict:
    """Every case of ``CASES`` on ``mesh`` → {case: tuple of numpy arrays}.
    ``inp`` holds ``make_inputs``'s arrays and the PQ codebooks and codes
    (``codebooks``: M=4, K=64; ``codes`` of ``x``)."""
    from vq_tpu_torch.core.config import (
        IVFConfig,
        KMeansConfig,
        Metric,
        PQConfig,
        SAQConfig,
        SearchConfig,
        SQConfig,
    )
    from vq_tpu_torch.dist import (
        ShardedFlatIndex,
        ShardedFlatPQIndex,
        ShardedIVFIndex,
        ShardedIvfPackedIndex,
        ShardedPackedFlatIndex,
    )
    from vq_tpu_torch.dist.mesh import all_gather, pad_rows_to_multiple, psum, shard_rows
    from vq_tpu_torch.dist.sharded import (
        dp_lloyd_step,
        sharded_exact_topk,
        sharded_generic_scan_topk,
        sharded_scan_topk,
    )
    from vq_tpu_torch.methods.pq import PQ
    from vq_tpu_torch.methods.saq import SAQ
    from vq_tpu_torch.methods.sq import SQ
    from vq_tpu_torch.convert import pq_from_numpy

    p_cnt, cpu = mesh.size, "cpu"
    x, q, xb, qb = inp["x"], inp["q"], inp["xb"], inp["qb"]
    n = len(x)
    norms = np.linalg.norm(x, axis=1).astype(np.float32)
    out = {}

    def arrays(*ts):
        return tuple(t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in ts)

    blocks = mesh.each(lambda p: torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * p)
    out["all_gather"] = arrays(all_gather(mesh, blocks), all_gather(mesh, blocks, dim=0))
    # (1e8 + 1) − 1e8 = 0 in f32: a sum in another order gives another value
    vals = (1e8, 1.0, -1e8, 0.5)
    out["psum"] = arrays(psum(mesh, mesh.each(
        lambda p: torch.tensor([vals[p % 4], p], dtype=torch.float32))))

    codes_p = pad_rows_to_multiple(inp["codes"], p_cnt * 2)
    norms_p = np.pad(norms, (0, len(codes_p) - n), constant_values=1.0)
    codes_sh, norms_sh = shard_rows(mesh, codes_p), shard_rows(mesh, norms_p)
    for name, metric, k, chunks in (("scan L2 k=10", Metric.L2, 10, 1),
                                    ("scan L2 k=10 overlap 2", Metric.L2, 10, 2),
                                    ("scan L2 k=256", Metric.L2, 256, 1),
                                    ("scan IP k=20 overlap 2", Metric.IP, 20, 2),
                                    ("scan NIP k=10", Metric.NIP, 10, 1)):
        out[name] = arrays(*sharded_scan_topk(
            mesh, q, codes_sh, inp["codebooks"], k, metric,
            norms=norms_sh if metric == Metric.NIP else None, true_n=n, use_bf16=False,
            overlap_chunks=chunks))

    sq = SQ(SQConfig(num_bits=8), device=cpu).fit(x)
    sq_codes = pad_rows_to_multiple(sq.compress(x), p_cnt * 2)
    for name, chunks in (("generic NIP k=10", 1), ("generic NIP k=10 overlap 2", 2)):
        out[name] = arrays(*sharded_generic_scan_topk(
            mesh, q, sq_codes, sq.decode_fn(), 10, Metric.NIP, norms=norms_p, true_n=n,
            use_bf16=False, overlap_chunks=chunks))
    out["exact k=10"] = arrays(*sharded_exact_topk(mesh, q, pad_rows_to_multiple(x, p_cnt), 10,
                                                   true_n=n))
    out["dp_lloyd_step"] = arrays(dp_lloyd_step(mesh, x[:n // p_cnt * p_cnt], x[:8].copy()))

    def index_case(index, data, queries, k=10, **kw):
        ids, scores = index.search_with_scores(queries, k, **kw)
        return arrays(ids, scores, index.memory_footprint(), index.reconstruction_mse(data))

    f32 = SearchConfig(use_bf16=False)
    pq_cfg = PQConfig(num_subquantizers=4, num_bits=6, kmeans=KMeansConfig(iters=6))
    given = ShardedFlatPQIndex(pq_from_numpy(inp["codebooks"], pq_cfg, device=cpu), f32,
                               mesh).fit(x)
    out["ShardedFlatPQIndex (given codebooks)"] = index_case(given, x, q, 40)
    own = ShardedFlatPQIndex(PQ(pq_cfg, seed=0, device=cpu), SearchConfig(
        metric=Metric.NIP, use_bf16=False), mesh).fit(x)
    out["ShardedFlatPQIndex NIP (own fit)"] = index_case(own, x, q)
    flat = ShardedFlatIndex(SQ(SQConfig(num_bits=8), device=cpu), f32, mesh).fit(x)
    out["ShardedFlatIndex SQ overlap 2"] = index_case(flat, x, q, overlap_chunks=2)

    def saq():
        return SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True), device=cpu)

    packed = ShardedPackedFlatIndex(saq(), f32, mesh).fit(xb)
    out["ShardedPackedFlatIndex SAQ"] = index_case(packed, xb, qb)
    out["ShardedPackedFlatIndex SAQ overlap 2"] = index_case(packed, xb, qb, overlap_chunks=2)
    kmc = KMeansConfig(iters=4)
    ivf = ShardedIVFIndex(SQ(SQConfig(num_bits=8), device=cpu), IVFConfig(16, 4, kmc), f32,
                          mesh).fit(xb)
    out["ShardedIVFIndex SQ union"] = index_case(ivf, xb, qb)
    out["ShardedIVFIndex SQ windows"] = index_case(ivf, xb, qb, strategy="windows")
    ivfp = ShardedIvfPackedIndex(saq(), IVFConfig(16, 3, kmc), f32, mesh).fit(xb)
    out["ShardedIvfPackedIndex SAQ"] = index_case(ivfp, xb, qb)
    assert tuple(out) == CASES
    return out


def run_rank(rank: int, world: int, work: str, layouts: dict) -> None:
    """One rank: join the gloo group of ``world`` ranks (rendezvous file in
    ``work``), then for each layout (name → shards per rank) run the cases
    on a mesh of this rank's shards; also what only a group shows (the
    mesh's owners, the exchanges made, ``save`` refused, fits that differ
    between ranks refused, the dryrun).
    Writes ``rank<r>.pt``, or the traceback to ``rank<r>.err``."""
    from vq_tpu_torch.core.config import KMeansConfig, PQConfig, SAQConfig
    from vq_tpu_torch.dist import (
        ShardedFlatPQIndex,
        ShardedPackedFlatIndex,
        make_mesh,
        maybe_init_distributed,
    )
    from vq_tpu_torch.dist.dryrun import dryrun_multichip
    from vq_tpu_torch.methods.pq import PQ
    from vq_tpu_torch.methods.saq import SAQ

    torch.set_num_threads(1)
    os.environ["VQ_DIST_INIT"] = "1"
    work = Path(work)
    try:
        maybe_init_distributed(device="cpu", init_method=f"file://{work / 'rendezvous'}",
                               rank=rank, world_size=world, timeout_s=60.0)
        inp = dict(np.load(work / "inputs.npz"))
        got = {}
        for name, per_rank in layouts.items():
            mesh = make_mesh(devices=["cpu"] * per_rank[rank])
            got[name] = run_cases(mesh, inp)
            got[name]["mesh"] = (mesh.owners, mesh.local_shards, mesh.ranks.exchanges)
        index = ShardedPackedFlatIndex(SAQ(SAQConfig(bits_per_dim=2.0), device="cpu"),
                                       mesh=mesh).fit(inp["xb"])  # the last layout's mesh
        try:
            index.save(str(work / f"saved{rank}.pkl"))
            got["save"] = "saved"
        except RuntimeError as e:
            got["save"] = str(e)
        # a seed per rank: the fits differ, and every rank must refuse them
        pq = PQ(PQConfig(num_subquantizers=4, num_bits=6, kmeans=KMeansConfig(iters=2)),
                seed=rank, device="cpu")
        try:
            ShardedFlatPQIndex(pq, mesh=mesh).fit(inp["x"])
            got["diverged"] = "fitted"
        except RuntimeError as e:
            got["diverged"] = str(e)
        dryrun_multichip(layouts[name][rank], "cpu")
        got["dryrun"] = "ok"
        torch.save(got, work / f"rank{rank}.pt")
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
