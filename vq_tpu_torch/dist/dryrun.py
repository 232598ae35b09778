"""One step of every sharded path on an n-shard mesh at toy sizes — the
port's counterpart of ``__graft_entry__.py::dryrun_multichip``.

    python -m vq_tpu_torch.dist.dryrun 8 cpu     # 8 shards on the CPU
    python -m vq_tpu_torch.dist.dryrun 4 cuda    # 4 shards on one card

The same eight steps at the same sizes: a data-parallel Lloyd step, the
sharded PQ scan, the sharded exact scan, the overlapped merge, the sharded
IVF index, the generic sharded flat index, the sharded packed index and the
sharded probed-tile IVF index.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch


def _check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what} does not hold")


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> None:
    """Run the eight steps on ``make_mesh(devices=[device] * n_devices)``, or
    with ``device=None`` on one shard per visible card (n_devices of them:
    fewer raises); prints ``dryrun_multichip(n): ok``.  Under a process
    group each rank lists its own devices, so the mesh holds every rank's
    shards, and every rank checks the merged results on its root."""
    from vq_tpu_torch.core.config import (
        IVFConfig,
        KMeansConfig,
        Metric,
        SAQConfig,
        SearchConfig,
        SQConfig,
    )
    from vq_tpu_torch.dist.mesh import make_mesh, pad_rows_to_multiple, replicate, shard_rows
    from vq_tpu_torch.dist.sharded import dp_lloyd_step, sharded_exact_topk, sharded_scan_topk
    from vq_tpu_torch.dist.sharded_index import ShardedFlatIndex
    from vq_tpu_torch.dist.sharded_ivf import ShardedIVFIndex
    from vq_tpu_torch.dist.sharded_ivf_packed import ShardedIvfPackedIndex
    from vq_tpu_torch.dist.sharded_packed import ShardedPackedFlatIndex
    from vq_tpu_torch.methods.saq import SAQ
    from vq_tpu_torch.methods.sq import SQ

    mesh = (make_mesh(n_devices) if device is None
            else make_mesh(devices=[device] * n_devices))
    root, p_cnt = mesh.root, mesh.size  # under a process group: every rank's shards
    rng = np.random.default_rng(0)
    n, d, m, kcb = 16 * p_cnt + 3, 32, 4, 16  # ragged n exercises pad masking
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((8, d)).astype(np.float32)
    codes = rng.integers(0, kcb, (n, m)).astype(np.uint8)
    codebooks = rng.standard_normal((m, kcb, d // m)).astype(np.float32)

    # 1. training step: a data-parallel Lloyd iteration (psum over the mesh)
    c1 = dp_lloyd_step(mesh, shard_rows(mesh, pad_rows_to_multiple(x, p_cnt)),
                       replicate(mesh, x[:8]))
    _check(c1.shape == (8, d) and bool(torch.isfinite(c1).all()), "finite (8, d) centroids")

    # 2. search step: the corpus-sharded ADC scan + cross-shard top-k merge
    qs, cbs = replicate(mesh, q), replicate(mesh, codebooks)
    _, i = sharded_scan_topk(mesh, qs, shard_rows(mesh, pad_rows_to_multiple(codes, p_cnt)),
                             cbs, k=5, metric=Metric.L2, true_n=n, tile_rows=64)
    _check(bool((i < n).all()), "PQ scan ids < n")

    # 3. the sharded exact scan (ground truth)
    _, i2 = sharded_exact_topk(mesh, qs, shard_rows(mesh, pad_rows_to_multiple(x, p_cnt)),
                               k=5, metric=Metric.L2, true_n=n)
    _check(bool((i2 < n).all()), "exact scan ids < n")

    # 4. the overlapped merge: each shard in 4 chunks, merged chunk by chunk
    _, i3 = sharded_scan_topk(mesh, qs,
                              shard_rows(mesh, pad_rows_to_multiple(codes, p_cnt * 4)),
                              cbs, k=5, metric=Metric.L2, true_n=n, tile_rows=64,
                              overlap_chunks=4)
    _check(torch.equal(i3, i), "overlap_chunks=4 = 1")

    # 5. sharded IVF: inverted lists spread over the mesh, queries routed by
    # the coarse assignment, exact cross-shard merge
    ivf = ShardedIVFIndex(SQ(SQConfig(num_bits=8), device=root),
                          IVFConfig(num_clusters=8, nprobe=4, kmeans=KMeansConfig(iters=4)),
                          mesh=mesh).fit(x)
    ids_ivf, _ = ivf.search_with_scores(q, k=5)
    _check(ids_ivf.shape == (8, 5) and bool((ids_ivf < n).all()), "sharded IVF ids")

    # 6. the generic sharded flat index (decode_fn scan + merge)
    gen = ShardedFlatIndex(SQ(SQConfig(num_bits=8), device=root), mesh=mesh).fit(x)
    ids_g, _ = gen.search_with_scores(q, k=5)
    _check(ids_g.shape == (8, 5) and bool((ids_g < n).all()), "sharded flat ids")

    # 7. the packed kernel per shard (local norm order, overlapped merge)
    nb = 1024 * p_cnt + 3  # ≥ 2 tiles a shard, so overlap chunks split
    xb = (rng.standard_normal((nb, d)) * np.exp(0.5 * rng.standard_normal((nb, 1)))
          ).astype(np.float32)
    pk = ShardedPackedFlatIndex(SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True), device=root),
                                SearchConfig(use_bf16=False), mesh=mesh).fit(xb)
    ids_p, _ = pk.search_with_scores(q, k=5, overlap_chunks=2)
    _check(ids_p.shape == (8, 5) and bool((ids_p < nb).all()), "sharded packed ids")

    # 8. the sharded probed-tile IVF: per-shard tile masks, the gather mode
    sivf = ShardedIvfPackedIndex(SAQ(SAQConfig(bits_per_dim=2.0, use_pca=True), device=root),
                                 IVFConfig(num_clusters=8, nprobe=3,
                                           kmeans=KMeansConfig(iters=4)),
                                 SearchConfig(use_bf16=False), mesh=mesh).fit(xb)
    ids_si, _ = sivf.search_with_scores(q, k=5)
    _check(ids_si.shape == (8, 5) and bool((ids_si < nb).all()), "sharded IVF-packed ids")
    print(f"dryrun_multichip({n_devices}): ok", flush=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                     sys.argv[2] if len(sys.argv) > 2 else None)
