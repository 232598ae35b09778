"""JAX-package state (as numpy arrays) → the port's state.

With these, both packages search the same codes with the same parameters:
the caller takes ``np.asarray`` of the JAX objects (this module never
imports jax or the JAX package) and hands the arrays over.  Like every
entry point of the port, each function puts its tensors on the card unless
``device=`` says otherwise.

    cfg = config_from_jax(jax_saq.cfg)                      # port SAQConfig

    params = pq_params_from_numpy(np.asarray(jax_pq.params.codebooks), "cuda")
    index = flat_index_from_numpy(codebooks, codes, norms, num_rows,
                                  jax_index.search_cfg, jax_pq.cfg)
    saq = saq_from_numpy(jax_saq.plan, jax.tree_util.tree_map(np.asarray,
                         jax_saq.params), jax_saq.cfg)
    packed = packed_corpus_from_numpy(words, factors, ...)   # (N, F) factors
    index = ivf_packed_index_from_numpy(saq, np.asarray(jax_index.centroids), ...)
    ra = rankaware_from_numpy(params, jax_ra.bits, jax_ra.layout, jax_ra.cfg)
    index = ivf_index_from_numpy(quantizer, np.asarray(jax_ivf.centroids), ...)

The sharded indexes go onto a port mesh (``dist.make_mesh``) of the JAX
mesh's size: ``sharded_packed_index_from_state(quantizer, jax_index._state(),
mesh)`` and ``sharded_ivf_packed_index_from_state`` take the JAX index's
``_state()`` dict (its stacked per-shard leaves; the pickled JAX quantizer
in it is not read), ``sharded_ivf_index_from_numpy`` its lists and routing
tables, ``sharded_flat_*`` its codes and norms.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from vq_tpu_torch.core import config as _config
from vq_tpu_torch.core.config import (
    LVQConfig,
    OPQConfig,
    PQConfig,
    RaBitQConfig,
    RankAwareConfig,
    SAQConfig,
    SearchConfig,
    SQConfig,
)
from vq_tpu_torch._device import resolve_device
from vq_tpu_torch.core.ffd import FFDLayout
from vq_tpu_torch.dist.mesh import put
from vq_tpu_torch.dist.sharded_index import ShardedFlatIndex, ShardedFlatPQIndex
from vq_tpu_torch.dist.sharded_ivf import ShardedIVFIndex
from vq_tpu_torch.dist.sharded_ivf_packed import ShardedIvfPackedIndex
from vq_tpu_torch.dist.sharded_packed import ShardedPackedFlatIndex, check_num_shards
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.index.ivf import IvfQuantizedIndex
from vq_tpu_torch.index.ivf_packed import IvfPackedFlatIndex
from vq_tpu_torch.kernels.packed_scan import PackedCorpus
from vq_tpu_torch.methods.lvq import LVQ, LVQParams
from vq_tpu_torch.methods.opq import OPQ, OPQParams
from vq_tpu_torch.methods.pq import PQ, PQParams
from vq_tpu_torch.methods.rabitq import RaBitQ, RaBitQParams
from vq_tpu_torch.methods.rankaware import RankAware, RankAwareParams
from vq_tpu_torch.methods.saq import SAQ, SAQParams, SAQPlan
from vq_tpu_torch.methods.sq import SQ, SQParams


def config_from_jax(cfg):
    """A JAX config object (any dataclass of ``vq_tpu/core/config.py``) →
    the port's config of the same class name, field by field; nested
    configs (``kmeans``) and ``Metric`` values convert too.  Reads only the
    object's dataclass fields and class name."""
    cls = getattr(_config, type(cfg).__name__, None)
    if cls is None or not dataclasses.is_dataclass(cls):
        raise TypeError(f"no port config named {type(cfg).__name__}")

    def _conv(v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return config_from_jax(v)
        if isinstance(v, enum.Enum):
            return _config.Metric(v.value)
        return v

    return cls(**{f.name: _conv(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)})


def _tensor(a, device, dtype=np.float32) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a, dtype=dtype), device=device)


def pq_params_from_numpy(codebooks: np.ndarray, device=None) -> PQParams:
    """``PQParams.codebooks`` (M, K, dsub) → f32 tensor on ``device``."""
    cb = np.asarray(codebooks, dtype=np.float32)
    if cb.ndim != 3:
        raise ValueError(f"codebooks must be (M, K, dsub), got {cb.shape}")
    return PQParams(codebooks=torch.tensor(cb, device=resolve_device(device)))


def codes_from_numpy(codes: np.ndarray, device=None) -> torch.Tensor:
    """PQ codes (N, M) → a tensor of the same dtype: uint8 (K ≤ 256) or
    uint16 (K ≤ 65536), as the JAX package stores them whatever the values."""
    c = np.asarray(codes)
    if c.ndim != 2:
        raise ValueError(f"codes must be (N, M), got {c.shape}")
    if c.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PQ codes must be uint8 or uint16, got {c.dtype}")
    return torch.tensor(np.ascontiguousarray(c), device=resolve_device(device))


def pq_from_numpy(codebooks: np.ndarray, cfg: PQConfig, seed: int = 0,
                  device=None) -> PQ:
    """A fitted ``PQ`` quantizer holding the given codebooks."""
    pq = PQ(cfg, seed=seed, device=resolve_device(device))
    pq.params = pq_params_from_numpy(codebooks, pq.device)
    pq._dim = pq.params.codebooks.shape[0] * pq.params.codebooks.shape[2]
    return pq


def flat_index_from_numpy(codebooks: np.ndarray, codes: np.ndarray, norms: np.ndarray,
                          num_rows: int, search_cfg: SearchConfig, pq_cfg: PQConfig,
                          device=None) -> FlatQuantizedIndex:
    """The state of a JAX ``FlatQuantizedIndex(PQ)`` (``codes``, ``norms``,
    ``num_rows``, search config; ``vq_tpu/index/flat.py``) → a port index."""
    pq = pq_from_numpy(codebooks, pq_cfg, device=device)
    return flat_index_of(pq, codes_from_numpy(codes, pq.device), norms, num_rows, search_cfg)


def flat_index_of(quantizer, codes, norms: np.ndarray, num_rows: int,
                  search_cfg: SearchConfig) -> FlatQuantizedIndex:
    """A port index over a fitted port quantizer and a JAX index's byte
    rows and norms; the quantizer's scan layout is built as ``fit`` does."""
    index = FlatQuantizedIndex(quantizer, search_cfg)
    index.codes = (codes if isinstance(codes, torch.Tensor) else
                   torch.tensor(np.ascontiguousarray(codes), device=quantizer.device))
    index.norms = _tensor(norms, quantizer.device)
    index.num_rows = int(num_rows)
    index._scan_cache = quantizer.prepare_scan(index.codes, norms=index.norms)
    return index


def saq_from_numpy(plan, params, cfg: SAQConfig, device=None) -> SAQ:
    """A fitted ``SAQ`` from a JAX ``SAQPlan`` (or anything with its fields)
    and ``SAQParams`` of numpy arrays."""
    dev = resolve_device(device)
    saq = SAQ(cfg, device=dev)
    saq.plan = SAQPlan(dim=int(plan.dim), seg_starts=tuple(map(int, plan.seg_starts)),
                       seg_lens=tuple(map(int, plan.seg_lens)),
                       seg_bits=tuple(map(int, plan.seg_bits)))
    saq.params = SAQParams(
        pca_mean=_tensor(params.pca_mean, dev), pca_rot=_tensor(params.pca_rot, dev),
        seg_rots=tuple(_tensor(r, dev) for r in params.seg_rots),
        seg_levels=tuple(_tensor(lv, dev) for lv in params.seg_levels))
    saq._dim = saq.plan.dim
    return saq


def rabitq_from_numpy(params, cfg: RaBitQConfig, device=None) -> RaBitQ:
    """A fitted ``RaBitQ`` from JAX ``RaBitQParams`` of numpy arrays."""
    dev = resolve_device(device)
    rb = RaBitQ(cfg, device=dev)
    rb.params = RaBitQParams(centroid=_tensor(params.centroid, dev),
                             rotation=_tensor(params.rotation, dev),
                             levels=_tensor(params.levels, dev))
    rb._dim = rb.params.centroid.shape[0]
    return rb


def packed_corpus_from_numpy(words, factors: np.ndarray, num_rows: int, tile_stats=None,
                             perm=None, has_norms: bool = False, prune_hint: bool = False,
                             device=None) -> PackedCorpus:
    """A JAX ``PackedCorpus`` → the port's: words as they are (int32 words,
    f32 value planes), factors transposed from (N, F) to (F, N)."""
    dev = resolve_device(device)
    ws = tuple(torch.tensor(np.ascontiguousarray(w), device=dev) for w in words)
    return PackedCorpus(
        words=ws, factors=_tensor(np.asarray(factors).T, dev), num_rows=int(num_rows),
        tile_stats=None if tile_stats is None else _tensor(tile_stats, dev),
        has_norms=has_norms, perm=None if perm is None else _tensor(perm, dev, np.int32),
        prune_hint=prune_hint)


def ivf_packed_index_from_numpy(quantizer, centroids: np.ndarray, ids_sorted: np.ndarray,
                                cl_first: np.ndarray, cl_last: np.ndarray, words,
                                factors: np.ndarray, num_rows: int, tile_stats=None,
                                has_norms: bool = False, prune_hint: bool = False,
                                ivf_cfg=None, search_cfg=None) -> IvfPackedFlatIndex:
    """The state of a JAX ``IvfPackedFlatIndex`` (``vq_tpu/index/ivf_packed.py``)
    → a port index over the fitted port ``quantizer`` (``saq_from_numpy``,
    ``rabitq_from_numpy``), on the quantizer's device: the centroids, the
    row order, the per-tile cluster ranges and the order-preserving cache
    (words as they are, factors transposed to (F, N)); the configs through
    ``config_from_jax``.  Both packages then search the same cache."""
    dev = quantizer.device
    index = IvfPackedFlatIndex(quantizer, config_from_jax(ivf_cfg or _config.IVFConfig()),
                               config_from_jax(search_cfg or SearchConfig()))
    index.centroids = _tensor(centroids, dev)
    index.ids_sorted = _tensor(ids_sorted, dev, np.int32)
    index.cl_first = _tensor(cl_first, dev, np.int32)
    index.cl_last = _tensor(cl_last, dev, np.int32)
    index.num_rows = int(num_rows)
    index.cache = packed_corpus_from_numpy(words, factors, num_rows, tile_stats,
                                           has_norms=has_norms, prune_hint=prune_hint,
                                           device=dev)
    return index


def sq_from_numpy(params, dim: int, cfg: SQConfig, device=None) -> SQ:
    """A fitted ``SQ`` from JAX ``SQParams`` (lo, scale) of numpy arrays."""
    sq = SQ(cfg, device=resolve_device(device))
    sq.params = SQParams(lo=_tensor(params.lo, sq.device), scale=_tensor(params.scale, sq.device))
    sq._dim = int(dim)
    return sq


def lvq_from_numpy(params, cfg: LVQConfig, device=None) -> LVQ:
    """A fitted ``LVQ`` from JAX ``LVQParams`` (mean) of numpy arrays."""
    lvq = LVQ(cfg, device=resolve_device(device))
    lvq.params = LVQParams(mean=_tensor(params.mean, lvq.device))
    lvq._dim = lvq.params.mean.shape[0]
    return lvq


def opq_from_numpy(params, cfg: OPQConfig, seed: int = 0, device=None) -> OPQ:
    """A fitted ``OPQ`` from JAX ``OPQParams`` (rotation, codebooks)."""
    opq = OPQ(cfg, seed=seed, device=resolve_device(device))
    opq.params = OPQParams(rotation=_tensor(params.rotation, opq.device),
                           codebooks=_tensor(params.codebooks, opq.device))
    opq._dim = opq.params.rotation.shape[0]
    return opq


def rankaware_from_numpy(params, bits, layout, cfg: RankAwareConfig, device=None) -> RankAware:
    """A fitted ``RankAware`` from JAX ``RankAwareParams`` of numpy arrays, its
    (D,) bit widths and its FFD layout (a NamedTuple of numpy, or None)."""
    ra = RankAware(cfg, device=resolve_device(device))
    ra.params = RankAwareParams(mean=_tensor(params.mean, ra.device),
                                rotation=_tensor(params.rotation, ra.device),
                                codebooks=_tensor(params.codebooks, ra.device))
    ra.bits = np.asarray(bits, dtype=np.int64)
    ra.layout = None if layout is None else FFDLayout(
        bits=np.asarray(layout.bits, np.int64), byte_idx=np.asarray(layout.byte_idx, np.int64),
        shift=np.asarray(layout.shift, np.int64), n_bytes=int(layout.n_bytes))
    ra._dim = ra.params.mean.shape[0]
    return ra


def ivf_index_from_numpy(quantizer, centroids: np.ndarray, codes_sorted: np.ndarray,
                         ids_sorted: np.ndarray, norms_sorted: np.ndarray, offsets: np.ndarray,
                         sizes: np.ndarray, inv_perm: np.ndarray, assignment: np.ndarray,
                         ivf_cfg=None, search_cfg=None) -> IvfQuantizedIndex:
    """The state of a JAX ``IvfQuantizedIndex`` (``vq_tpu/index/ivf.py``) →
    a port index over the fitted port ``quantizer``, on its device: the
    centroids, the padded cluster-sorted codes, ids and norms, the CSR
    offsets and sizes, the inverse permutation and the assignment, with
    the JAX arrays' dtypes (so the footprints compare byte for byte); the
    configs through ``config_from_jax``."""
    dev = quantizer.device
    index = IvfQuantizedIndex(quantizer, config_from_jax(ivf_cfg or _config.IVFConfig()),
                              config_from_jax(search_cfg or SearchConfig()))
    index.centroids = _tensor(centroids, dev)
    index.codes_sorted = torch.tensor(np.ascontiguousarray(codes_sorted), device=dev)
    index.ids_sorted = _tensor(ids_sorted, dev, np.int32)
    index.norms_sorted = _tensor(norms_sorted, dev)
    index.offsets = _tensor(offsets, dev, np.int32)
    index.sizes = _tensor(sizes, dev, np.int32)
    index._inv_perm = _tensor(inv_perm, dev, np.int64)
    index._assignment = _tensor(assignment, dev, np.int32)
    index.max_cluster = int(np.max(sizes))
    index.num_rows = int(len(assignment))
    return index


# ------------------------------------------------------------------ sharded
def sharded_flat_pq_index_from_numpy(codebooks: np.ndarray, codes: np.ndarray,
                                     norms: np.ndarray, num_rows: int, search_cfg, pq_cfg,
                                     mesh) -> ShardedFlatPQIndex:
    """A JAX ``ShardedFlatPQIndex``'s codes and norms (``np.asarray`` of the
    sharded arrays: padded rows included, cut here at ``num_rows``) and PQ
    codebooks → a port index on ``mesh``, re-padded and sharded there."""
    pq = pq_from_numpy(codebooks, config_from_jax(pq_cfg), device=mesh.root)
    index = ShardedFlatPQIndex(pq, config_from_jax(search_cfg), mesh)
    index.add_sharded(np.asarray(codes)[:num_rows], np.asarray(norms)[:num_rows], num_rows)
    return index


def sharded_flat_index_of(quantizer, codes: np.ndarray, norms: np.ndarray, num_rows: int,
                          search_cfg, mesh) -> ShardedFlatIndex:
    """A JAX ``ShardedFlatIndex``'s codes and norms (cut at ``num_rows``) over
    a fitted port quantizer → a port index on ``mesh``."""
    index = ShardedFlatIndex(quantizer, config_from_jax(search_cfg), mesh)
    index._install(np.asarray(codes)[:num_rows], np.asarray(norms)[:num_rows], num_rows)
    return index


def _port_stacked(state: dict) -> dict:
    """A JAX sharded packed ``_state()``: factors (P, n_loc, F) → (P, F, n_loc)."""
    return {**state, "factors": np.ascontiguousarray(np.swapaxes(state["factors"], 1, 2))}


def sharded_packed_index_from_state(quantizer, state: dict, mesh) -> ShardedPackedFlatIndex:
    """A JAX ``ShardedPackedFlatIndex._state()`` over the fitted port
    ``quantizer`` → a port index on ``mesh`` (of the same shard count)
    holding the same per-shard caches."""
    check_num_shards(state, mesh)
    index = ShardedPackedFlatIndex(quantizer, config_from_jax(state["search_cfg"]), mesh)
    index._load_stacked(_port_stacked(state))
    return index


def sharded_ivf_packed_index_from_state(quantizer, state: dict, mesh) -> ShardedIvfPackedIndex:
    """A JAX ``ShardedIvfPackedIndex._state()`` over the fitted port
    ``quantizer`` → a port index on ``mesh`` (of the same shard count):
    the same centroids, per-shard caches, row ids and tile cluster ranges."""
    check_num_shards(state, mesh)
    index = ShardedIvfPackedIndex(quantizer, config_from_jax(state["ivf_cfg"]),
                                  config_from_jax(state["search_cfg"]), mesh)
    index._load_stacked(_port_stacked(state))
    return index


def sharded_ivf_index_from_numpy(quantizer, mesh, centroids: np.ndarray, codes_sh: np.ndarray,
                                 ids_sh: np.ndarray, norms_sh: np.ndarray, shard_of: np.ndarray,
                                 local_off: np.ndarray, sizes: np.ndarray, num_rows: int,
                                 ivf_cfg=None, search_cfg=None) -> ShardedIVFIndex:
    """A JAX ``ShardedIVFIndex``'s state (``np.asarray`` of ``codes_sh``,
    ``ids_sh``, ``norms_sh``: (P, rows, …) blocks; the (K,) ``shard_of``,
    ``local_off`` and ``sizes``; the centroids) over the fitted port
    ``quantizer`` → a port index on ``mesh``, shard p's block on its
    device."""
    index = ShardedIVFIndex(quantizer, config_from_jax(ivf_cfg or _config.IVFConfig()),
                            config_from_jax(search_cfg or SearchConfig()), mesh)
    devs = mesh.devices
    index.centroids = _tensor(centroids, mesh.root)
    index._install([put(np.asarray(c), d) for c, d in zip(codes_sh, devs)],
                   [put(np.asarray(i, np.int32), d) for i, d in zip(ids_sh, devs)],
                   [put(np.asarray(n, np.float32), d) for n, d in zip(norms_sh, devs)],
                   shard_of, local_off, sizes, num_rows)
    return index
