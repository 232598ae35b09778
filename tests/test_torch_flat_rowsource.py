"""``FlatQuantizedIndex.fit`` on a row source, the in-place packed layout and
the flat index's scan counter, on the CPU at small sizes.

* A row source (``vqbench/corpora/fullrank_stream.py``: rows made per
  request, blocks of 1,000 rows, off the 512-row tile) fitted with norm
  chunks of 700 rows builds the index that the same rows as one tensor
  build, bit for bit: codes, norms, words, factors, tile stats, ``perm``
  and answers, with and without the norm order;
* ``prepare_packed`` written in place equals the concatenating version it
  replaced (kept below as ``prepare_packed_concat``) bit for bit, for each
  dequant kind, norm order, norms, pad rows and chunk size;
* ``host_sample_rows`` keeps a tensor-returning source's sample a tensor
  and a numpy source's numpy, the same rows by the same draw;
* ``last_tiles_scanned`` is the plain twin's scanned count of the same
  search, every unit with the prune off, for SAQ, RaBitQ and RankAware;
* the build's spans.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vq_tpu_torch import Metric, PQConfig, RaBitQConfig, RankAwareConfig, SAQConfig, SearchConfig
from vq_tpu_torch.data.sampling import host_sample_rows
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.kernels.packed_scan import TILE, packed_scan_topk_plain, prune_units
from vq_tpu_torch.methods import packed as pr
from vq_tpu_torch.methods import saq as tsaq
from vq_tpu_torch.methods.pq import PQ
from vq_tpu_torch.methods.rabitq import RaBitQ
from vq_tpu_torch.methods.rankaware import RankAware
from vq_tpu_torch.methods.saq import SAQ
from vq_tpu_torch.utils import trace
from vqbench.corpora import fullrank_stream

torch.set_num_threads(1)
N, D, NQ = 5000, 64, 24  # 5000 = 9 tiles and a ragged 392
CFG = SAQConfig(bits_per_dim=2.0, block_dims=16)


@pytest.fixture(scope="module")
def source():
    rows, pool = fullrank_stream.make(N, D, NQ, 2**31 + 53, "cpu", block=1000,
                                      basis_seed=20261018)
    return rows, pool


def flat_index(cfg=CFG):
    return FlatQuantizedIndex(SAQ(cfg, device="cpu"),
                              SearchConfig(metric=Metric.L2, use_bf16=True))


@pytest.fixture(scope="module")
def both(source):
    rows, _ = source
    return flat_index().fit(rows, chunk_rows=700), flat_index().fit(rows[0:N])


def assert_same_cache(a, b):
    assert len(a.words) == len(b.words)
    for wa, wb in zip(a.words, b.words):
        assert wa.dtype == wb.dtype and torch.equal(wa, wb)
    assert torch.equal(a.factors, b.factors)
    assert torch.equal(a.tile_stats, b.tile_stats)
    assert (a.perm is None) == (b.perm is None)
    if a.perm is not None:
        assert a.perm.dtype == torch.int32 and torch.equal(a.perm, b.perm)
    assert (a.num_rows, a.has_norms, a.prune_hint) == (b.num_rows, b.has_norms, b.prune_hint)


def test_a_row_source_builds_the_tensors_index_bit_for_bit(source, both):
    rows, pool = source
    src, ten = both
    assert not isinstance(rows, torch.Tensor) and src.num_rows == ten.num_rows == N
    assert torch.equal(src.quantizer.params.pca_rot, ten.quantizer.params.pca_rot)
    assert src.quantizer.plan == ten.quantizer.plan
    assert torch.equal(src.codes, ten.codes)
    assert torch.equal(src.norms, ten.norms)
    assert torch.equal(ten.norms, torch.linalg.norm(rows[0:N], dim=-1))
    assert src.scan_cache.perm is not None
    assert_same_cache(src.scan_cache, ten.scan_cache)
    for k in (1, 10):
        ids_a, s_a = src.search_with_scores(pool, k)
        ids_b, s_b = ten.search_with_scores(pool, k)
        np.testing.assert_array_equal(ids_a, ids_b)
        np.testing.assert_array_equal(s_a, s_b)


def test_without_the_norm_order_too(both):
    src, ten = both
    a = src.quantizer.prepare_tile_cache(src.codes, norms=src.norms)
    b = ten.quantizer.prepare_tile_cache(ten.codes, norms=ten.norms)
    assert a.perm is None
    assert_same_cache(a, b)


def prepare_packed_concat(plan, params, codes, norms=None, row_chunk=131072, sort_rows=False,
                          num_valid_rows=None):
    """``methods/saq.py::prepare_packed`` as it was before it wrote in
    place: every chunk's parts kept in lists, then concatenated."""
    n = codes.shape[0]
    nv = n if num_valid_rows is None else int(num_valid_rows)
    perm = order = None
    if sort_rows and n > TILE:
        key = tsaq._row_norm_key(plan, codes)
        if nv < n:
            key = torch.where(torch.arange(n, device=codes.device) < nv, key,
                              torch.full_like(key, np.inf))
        order = torch.argsort(key, stable=True)
        if norms is not None:
            norms = norms[order]
        perm = order.to(torch.int32)
    row_chunk = max(TILE, row_chunk - row_chunk % TILE)
    n_pad = n + (-n) % TILE
    w_chunks, f_chunks, r_chunks, m_chunks = [], [], [], []
    for i0 in range(0, n_pad, row_chunk):
        i1 = min(i0 + row_chunk, n_pad)
        rows = codes[i0: min(i1, n)] if order is None else codes[order[i0: min(i1, n)]]
        if i1 > n:
            rows = torch.nn.functional.pad(rows, (0, 0, 0, i1 - max(i0, n)))
        w, f, r, m = tsaq._convert_rows(plan, params, rows)
        w_chunks.append(w)
        f_chunks.append(f)
        r_chunks.append(r)
        m_chunks.append(m)
    words = tuple(torch.cat([c[s] for c in w_chunks]) for s in range(plan.num_segments))
    nrm_row = torch.ones((n_pad,), dtype=torch.float32, device=codes.device)
    if norms is not None:
        nrm_row[:n] = norms.to(torch.float32)
    stats = tsaq._tile_stats(torch.cat(r_chunks), torch.cat(m_chunks), nv,
                             norms=nrm_row if norms is not None else None)
    fac = torch.cat([torch.cat(f_chunks, dim=1), nrm_row[None]], dim=0).contiguous()
    return tsaq.PackedCorpus(words=words, factors=fac, num_rows=n, tile_stats=stats,
                             has_norms=norms is not None, perm=perm,
                             prune_hint=pr.prune_hint_from_stats(stats))


@pytest.fixture(scope="module", params=[("uniform", 2.0), ("lloyd", 3.0)])
def fitted(request, source):
    """SAQ fits of each dequant kind (lloyd: "perdim" tables below 5 bits,
    a "values" plane at 5 and more) and their byte rows, on varied norms."""
    rows, _ = source
    x = rows[0:N] * (0.5 + torch.rand((N, 1), generator=torch.Generator().manual_seed(3)))
    codebook, bpd = request.param
    cfg = SAQConfig(bits_per_dim=bpd, block_dims=16, codebook=codebook)
    plan, params = tsaq.fit(x, cfg, device="cpu")
    kinds = {s.dequant for s in tsaq.packed_segspecs(plan, params)[0]}
    assert kinds == ({"uniform"} if codebook == "uniform" else {"perdim", "values"})
    return plan, params, tsaq.encode(plan, params, x), torch.linalg.norm(x, dim=1)


@pytest.mark.parametrize("sort_rows,with_norms,num_valid,row_chunk", [
    (False, False, None, 131072), (True, True, None, 131072), (True, False, None, 1024),
    (False, True, None, 1536), (True, True, N - 700, 2048), (False, False, N - 10, 512)])
def test_in_place_prepare_packed_equals_the_concatenating_one(fitted, sort_rows, with_norms,
                                                              num_valid, row_chunk):
    plan, params, codes, norms = fitted
    kw = dict(norms=norms if with_norms else None, row_chunk=row_chunk, sort_rows=sort_rows,
              num_valid_rows=num_valid)
    assert_same_cache(tsaq.prepare_packed(plan, params, codes, **kw),
                      prepare_packed_concat(plan, params, codes, **kw))


def test_fill_packed_equals_prepare_packed_on_off_size_chunks(fitted):
    plan, params, codes, _ = fitted
    chunks = [(i0, codes[i0:i0 + 1536]) for i0 in range(0, N, 1536)]
    assert_same_cache(tsaq.fill_packed(plan, params, N, chunks, "cpu", row_chunk=1024),
                      tsaq.prepare_packed(plan, params, codes))


class NumpyRows:
    """A row source over a numpy array that hands back numpy rows."""

    def __init__(self, a):
        self.a, self.shape = a, a.shape

    def __getitem__(self, key):
        return self.a[key]


@pytest.mark.parametrize("cap", [700, N])
def test_host_sample_rows_keeps_a_tensor_sources_sample_a_tensor(source, cap):
    rows, _ = source
    got = host_sample_rows(rows, cap, seed=7)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    want = host_sample_rows(NumpyRows(rows[0:N].numpy()), cap, seed=7)
    assert isinstance(want, np.ndarray) and want.shape == (min(cap, N), D)
    np.testing.assert_array_equal(got.numpy(), want)
    if cap < N:
        ids = np.sort(np.random.default_rng(7).choice(N, cap, replace=False))
        assert torch.equal(got, rows[ids])


def test_pq_fits_on_a_row_source(source):
    rows, pool = source
    index = FlatQuantizedIndex(PQ(PQConfig(num_subquantizers=8, num_bits=4), device="cpu"),
                               SearchConfig(metric=Metric.L2)).fit(rows, chunk_rows=700)
    assert index.codes.shape == (N, 8) and index.last_tiles_scanned == 0
    assert index.search_with_scores(pool, 5)[0].shape == (NQ, 5)
    assert index.last_tiles_scanned == index.last_scan_units == 0


PACKED = {"saq": lambda: SAQ(CFG, device="cpu"),
          "rabitq": lambda: RaBitQ(RaBitQConfig(num_bits=2), device="cpu"),
          "rankaware": lambda: RankAware(RankAwareConfig(bits_per_dim=2.0), device="cpu")}


@pytest.mark.parametrize("method", sorted(PACKED))
@pytest.mark.parametrize("prune", [True, False])
def test_last_tiles_scanned_is_the_plain_twins_count(source, prune, method):
    """Rows scaled by 0.25-4 give tiles of norm bands the prune can skip
    (unit rows' bands are too narrow for it here): shuffled where the
    layout norm-orders the rows (SAQ), in ascending order where it keeps
    them (RaBitQ, RankAware).  The count is the plain twin's of the same
    search; with the prune's hint off, every unit."""
    rows, pool = source
    quantizer = PACKED[method]()
    scale = torch.exp2(torch.linspace(-2.0, 2.0, N))
    if quantizer.norm_order:
        scale = scale[torch.randperm(N, generator=torch.Generator().manual_seed(5))]
    index = FlatQuantizedIndex(quantizer, SearchConfig(metric=Metric.L2, use_bf16=True)).fit(
        rows[0:N] * scale[:, None])
    cache = index.scan_cache
    assert cache.prune_hint
    cache.prune_hint = prune
    assert index.last_tiles_scanned == index.last_scan_units == 0
    index.search_with_scores(pool, 10)
    units = prune_units(NQ, cache.factors.shape[1], "cpu")
    assert index.last_scan_units == units == -(-N // TILE)
    if prune:
        args = pr.packed_scan_args(quantizer.packed_route(), pool, cache, 10, Metric.L2,
                                   use_bf16=False, prune=True)
        assert 0 < index.last_tiles_scanned == int(packed_scan_topk_plain(**args)[2]) < units
    else:
        assert index.last_tiles_scanned == units


def test_the_build_is_spanned(source):
    rows, _ = source
    trace.reset()
    flat_index().fit(rows, chunk_rows=700)
    rec = trace.recent("build", 1)
    assert len(rec) == 1
    assert set(rec[0]) == {"build", "build.fit", "build.encode", "build.norms", "build.pack"}
    assert rec[0]["build"] >= sum(v for k, v in rec[0].items() if k != "build")
