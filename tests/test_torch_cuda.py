"""The port's routing and device rules on a card (marked ``cuda``; skipped
without one).

The kernels' results against their plain versions (edge cases and the main
path's shapes) are checked by ``chip_smoke.py``; this file checks that the
CUDA path reaches the kernels and stays on the card.  It imports no jax,
so it also runs where only the port's dependencies are installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from vq_tpu_torch import IVFConfig, KMeansConfig, LVQConfig, Metric, OPQConfig, PQConfig
from vq_tpu_torch import RaBitQConfig, RankAwareConfig, SAQConfig, SQConfig
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.index.ivf import IvfQuantizedIndex
from vq_tpu_torch.index.ivf_packed import IvfPackedFlatIndex
from vq_tpu_torch.kernels import packed_scan as pk
from vq_tpu_torch.kernels import pq_scan as ps
from vq_tpu_torch.kernels.adc import scan_codes_topk
from vq_tpu_torch.methods.lvq import LVQ
from vq_tpu_torch.methods.opq import OPQ
from vq_tpu_torch.methods.pq import PQ
from vq_tpu_torch.methods.rabitq import RaBitQ
from vq_tpu_torch.methods.rankaware import RankAware
from vq_tpu_torch.methods.saq import SAQ
from vq_tpu_torch.methods.sq import SQ

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, n=20000, q=45, m=8, kk=256, dsub=8, seed=7):
    rng = np.random.default_rng(seed)
    queries = rng.standard_normal((q, m * dsub)).astype(np.float32)
    codes = rng.integers(0, kk, (n, m)).astype(np.uint8)
    cb = rng.standard_normal((m, kk, dsub)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (queries, codes, cb))


# M=256 at K=256: one query's table exceeds shared memory; the kernels still
# run (reading the tables from global memory), nothing falls back to plain
# code.  k ≤ 128 takes the fused kernel, k > 128 the score kernel; bf16 at
# dsub 2 and 8 the decode route, f32 the table route.
@pytest.mark.parametrize("m,dsub", [(8, 8), (256, 2)])
@pytest.mark.parametrize("k,fused,score", [(10, 1, 0), (100, 1, 0), (200, 0, 1)])
@pytest.mark.parametrize("use_bf16", [False, True])
def test_scan_codes_topk_routes_through_kernels(dev, m, dsub, k, fused, score, use_bf16):
    q, codes, cb = _inputs(dev, m=m, dsub=dsub)
    ps.reset_launch_counts()
    _, ids = scan_codes_topk(q, codes, cb, k, Metric.L2, use_bf16=use_bf16)
    assert ids.shape == (45, k) and ids.is_cuda
    assert (ps.pq_scan_topk_fused.launches, ps.pq_score_all.launches) == (fused, score)


def test_nip_stays_on_the_plain_path(dev):
    q, codes, cb = _inputs(dev)
    ps.reset_launch_counts()
    norms = torch.ones(codes.shape[0], device=dev)
    scan_codes_topk(q, codes, cb, 10, Metric.NIP, norms=norms)
    assert ps.pq_scan_topk_fused.launches == 0 and ps.pq_score_all.launches == 0


def test_wrapper_rejects_bad_inputs_on_the_card(dev):
    q, codes, cb = _inputs(dev)
    with pytest.raises(ValueError):
        ps.pq_scan_topk_fused(q, codes.to(torch.int32), cb, 10)
    with pytest.raises(ValueError):
        ps.pq_scan_topk_fused(q, codes, cb, 129)
    with pytest.raises(ValueError):
        ps.pq_score_all(q.cpu(), codes, cb)


def test_pq_on_a_card_corpus_stays_on_the_card(dev):
    x = torch.randn((3000, 32), generator=torch.Generator(dev).manual_seed(0), device=dev)
    cfg = PQConfig(4, 8, KMeansConfig(iters=3))
    index = FlatQuantizedIndex(PQ(cfg)).fit(x)
    assert index.device.type == "cuda" and index.codes.is_cuda
    assert index.quantizer.params.codebooks.is_cuda and index.norms.is_cuda
    ps.reset_launch_counts()
    ids, _ = index.search_with_scores(x[:5], 10)
    assert ids.shape == (5, 10) and ps.pq_scan_topk_fused.launches == 1
    with pytest.raises(ValueError, match="given to code on cpu"):
        PQ(cfg, device="cpu").fit(x)
    cpu_index = FlatQuantizedIndex(PQ(cfg)).fit(x.cpu())
    with pytest.raises(ValueError, match="given to code on cpu"):
        cpu_index.search_with_scores(x[:5], 10)


@pytest.mark.parametrize("name", ["saq", "rabitq"])
def test_packed_search_routes_through_the_kernel(dev, name):
    """k ≤ 128 launches the packed kernel once per search; use_packed=False
    and k > 128 take the plain streaming scan (as the JAX package sends
    them to XLA); everything stays on the card."""
    from vq_tpu_torch.methods import rabitq as rb_mod
    from vq_tpu_torch.methods import saq as saq_mod

    x = torch.randn((3000, 64), generator=torch.Generator(dev).manual_seed(1), device=dev)
    q = (SAQ(SAQConfig(bits_per_dim=2.0, block_dims=16)) if name == "saq"
         else RaBitQ(RaBitQConfig(num_bits=2)))
    index = FlatQuantizedIndex(q).fit(x)
    assert index.codes.is_cuda and index._scan_cache.factors.is_cuda
    pk.reset_launch_counts()
    for k in (1, 10, 128):
        ids, _ = index.search_with_scores(x[:7], k)
        assert ids.shape == (7, k)
    assert pk.packed_scan_topk.launches == 3
    if name == "saq":
        _, ids = saq_mod.scan_topk(q.plan, q.params, x[:7], index.codes, 10, Metric.L2,
                                   use_packed=False)
    else:
        _, ids = rb_mod.scan_topk(q.params, x[:7], index.codes, 10, Metric.L2,
                                  q.cfg.num_bits, use_packed=False)
    assert ids.is_cuda and ids.shape == (7, 10)
    _, ids = q.scan_topk(x[:7], index.codes, 129, Metric.L2, cache=index._scan_cache)
    assert ids.is_cuda and ids.shape == (7, 129) and pk.packed_scan_topk.launches == 3


def test_packed_wrapper_rejects_bad_inputs_on_the_card(dev):
    seg = pk.make_segspec(2, 32, "uniform", -1)
    q = torch.zeros((3, 32), device=dev)
    qa = torch.zeros((3,), device=dev)
    words = torch.zeros((32, 32), dtype=torch.int32, device=dev)
    fac = torch.ones((1, 512), device=dev)
    pk.packed_scan_topk(q, qa, (words,), fac, (), (seg,), 5, metric_kind="ip")
    with pytest.raises(ValueError):
        pk.packed_scan_topk(q, qa, (words,), fac, (), (seg,), 129, metric_kind="ip")
    with pytest.raises(ValueError):
        pk.packed_scan_topk(q.cpu(), qa, (words,), fac, (), (seg,), 5, metric_kind="ip")
    with pytest.raises(ValueError):
        pk.packed_scan_topk(q, qa, (words.float(),), fac, (), (seg,), 5, metric_kind="ip")


def test_host_corpus_goes_to_the_card_by_default(dev):
    """No device and a numpy corpus: the card."""
    x = np.random.default_rng(3).standard_normal((2000, 32)).astype(np.float32)
    index = FlatQuantizedIndex(SAQ(SAQConfig(bits_per_dim=2.0, block_dims=16))).fit(x)
    assert index.device.type == "cuda" and index._scan_cache.factors.is_cuda
    assert index.search(x[:3], 5).shape == (3, 5)


@pytest.mark.parametrize("name", ["saq", "rabitq"])
def test_ivf_packed_search_launches_the_gather_kernel(dev, name):
    """One gather launch per search (no dense launch), everything on the
    card; the full probe equals the unmasked kernel bit for bit."""
    x = torch.randn((6000, 64), generator=torch.Generator(dev).manual_seed(2), device=dev)
    q = (SAQ(SAQConfig(bits_per_dim=2.0, block_dims=16)) if name == "saq"
         else RaBitQ(RaBitQConfig(num_bits=2)))
    index = IvfPackedFlatIndex(q, IVFConfig(16, 2, KMeansConfig(iters=3))).fit(x)
    assert index.cache.factors.is_cuda and index.cache.perm is None
    pk.reset_launch_counts()
    ids, _ = index.search_with_scores(x[:5], 10)
    assert ids.shape == (5, 10) and 0 < index.last_tiles_scanned <= 12
    assert (pk.packed_scan_topk.gather_launches, pk.packed_scan_topk.launches) == (1, 0)
    _, full, _ = index._search(x[:5], 10, 16)
    s, pos = q.packed_scan_raw(x[:5], index.cache, 10, Metric.L2)
    assert torch.equal(full, index.ids_sorted[pos.long()].to(full.dtype))


def test_packed_kernel_at_a_partial_query_block(dev):
    """Q = 70: one full 64-query block and a partial one, in bf16 and f32;
    each call launches the kernel once and stays on the card, and the
    gather mode over every tile returns the dense kernel's result."""
    from vq_tpu_torch.methods import packed as pr

    x = torch.randn((6000, 64), generator=torch.Generator(dev).manual_seed(4), device=dev)
    q = SAQ(SAQConfig(bits_per_dim=2.0, block_dims=16))
    cache = FlatQuantizedIndex(q).fit(x)._scan_cache
    every = torch.ones((cache.factors.shape[1] // 512,), dtype=torch.int32, device=dev)
    pk.reset_launch_counts()
    for bf16 in (True, False):
        a = pr.packed_scan_args(q.packed_route(), x[:70], cache, 10, Metric.L2,
                                use_bf16=bf16)
        s, ids = pk.packed_scan_topk(**a)
        assert ids.is_cuda and ids.shape == (70, 10) and bool((ids < 6000).all())
        assert bool(torch.isfinite(s).all())
        gs, gi = pk.packed_scan_topk(**a, tile_mask=every)
        assert torch.equal(gi, ids) and torch.equal(gs, s)
    assert (pk.packed_scan_topk.launches, pk.packed_scan_topk.gather_launches) == (2, 2)


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("nq", [64, 128])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_shared_kind_values_read_back_bit_for_bit(dev, bits, nq, gather):
    """The "shared" kind's bf16 values, read back through the scores: one-hot
    queries under IP with qa = 0 make each score one round_bf16(level × α).
    Of 3 tiles, 0 and 2 (the tile list [0, 2] in the gather mode) hold in
    each of 8 calls a window of 128 rows (tile row % 8 = the call) with
    every code at every dim and α in [0.5, 2); every other row has the most
    negative level at α = 1e4, so the window is the top-128 of every query.
    Over the calls every row of both tiles -- each shift slot, both passes
    -- comes back; ids, order and scores must equal the host's values (f32
    product, rounded to bf16), bit for bit, at width 64 (Q = 64) and 128."""
    from vq_tpu_torch.kernels._build import load_library

    n, d, k = 3 * pk.TILE, 72, 128
    rng = np.random.default_rng(100 * bits + nq)
    lv = np.sort(rng.uniform(-2.0, 2.0, 1 << bits)).astype(np.float32)
    lv[0] = -2.5
    seg = pk.make_segspec(bits, d, "shared", 0)
    dims = np.arange(nq) % d
    q = np.zeros((nq, d), dtype=np.float32)
    q[np.arange(nq), dims] = 1.0
    qt, qa = torch.from_numpy(q).to(dev), torch.zeros((nq,), device=dev)
    lvt = torch.from_numpy(lv).reshape(1, -1).to(dev)
    mask = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev) if gather else None
    rows = np.arange(n)
    pk.reset_launch_counts()
    for call in range(8):
        win = (rows // pk.TILE != 1) & (rows % 8 == call)
        codes = np.zeros((n, d), dtype=np.int64)
        codes[win] = (np.arange(128)[:, None] + np.arange(d)[None, :]) % (1 << bits)
        alpha = np.full((n,), 1e4, dtype=np.float32)
        alpha[win] = rng.uniform(0.5, 2.0, 128).astype(np.float32)
        words = pk.pack_words(torch.from_numpy(codes), bits, seg.beff).to(dev)
        fac = torch.from_numpy(alpha).reshape(1, n).to(dev)
        s, ids = pk.packed_scan_topk(qt, qa, (words,), fac, (lvt,), (seg,), k, family="rabitq",
                                     metric_kind="ip", tile_mask=mask)
        # the host's values of the window's rows at each query's dim, ranked
        # by score descending, then id ascending
        wr = rows[win]
        val = (torch.from_numpy(lv[codes[wr][:, dims].T]) * torch.from_numpy(alpha[wr])[None, :])
        val = val.to(torch.bfloat16).float()
        order = np.lexsort((np.broadcast_to(wr, val.shape), -val.numpy()), axis=1)
        want_s = torch.gather(val, 1, torch.from_numpy(order))
        want_i = torch.from_numpy(wr[order].astype(np.int32))
        assert torch.equal(ids.cpu(), want_i) and torch.equal(s.cpu(), want_s)
    width = pk.scan_width(nq)
    assert width == (64 if nq == 64 else 128)
    regs = load_library().vq_packed_register_table(2, seg.beff, width)
    assert pk.register_table(seg, width) == bool(regs)
    assert pk.packed_scan_topk.register_table_launches == (8 if regs else 0)
    assert pk.packed_scan_topk.launches_by_width == {width: 8}


def test_cuda_tile_mask_on_a_cpu_cache_raises(dev):
    seg = pk.make_segspec(2, 32, "uniform", -1)
    q, qa = torch.zeros((3, 32)), torch.zeros((3,))
    words, fac = torch.zeros((32, 32), dtype=torch.int32), torch.ones((1, 512))
    with pytest.raises(ValueError, match="tile_mask"):
        pk.packed_scan_topk(q, qa, (words,), fac, (), (seg,), 5, metric_kind="ip",
                            tile_mask=torch.ones((1,), dtype=torch.int32, device=dev))


@pytest.mark.parametrize("packing", ["dense", "ffd"])
def test_rankaware_routes_through_the_packed_kernel(dev, packing):
    """RankAware at k ≤ 128 launches the packed kernel (no per-row scale);
    k=200 takes the plain streaming scan; IvfPackedFlatIndex(RankAware)
    launches the gather mode once a search."""
    x = torch.randn((3000, 64), generator=torch.Generator(dev).manual_seed(5), device=dev)
    x = x * torch.linspace(3.0, 0.1, 64, device=dev)
    q = RankAware(RankAwareConfig(bits_per_dim=2.0, packing=packing))
    index = FlatQuantizedIndex(q).fit(x)
    assert index.codes.is_cuda and index._scan_cache.factors.is_cuda
    pk.reset_launch_counts()
    for k in (10, 128):
        ids, _ = index.search_with_scores(x[:7], k)
        assert ids.shape == (7, k)
    assert pk.packed_scan_topk.launches == 2
    ids, _ = index.search_with_scores(x[:7], 200)
    assert ids.shape == (7, 200) and pk.packed_scan_topk.launches == 2
    ivf = IvfPackedFlatIndex(RankAware(RankAwareConfig(bits_per_dim=2.0, packing=packing)),
                             IVFConfig(16, 2, KMeansConfig(iters=3))).fit(x)
    ivf.search_with_scores(x[:5], 10)
    assert pk.packed_scan_topk.gather_launches == 1


def test_opq_routes_through_the_fused_kernel(dev):
    x = torch.randn((3000, 32), generator=torch.Generator(dev).manual_seed(6), device=dev)
    q = OPQ(OPQConfig(4, 8, opq_iters=2, kmeans=KMeansConfig(iters=3)))
    index = FlatQuantizedIndex(q).fit(x)
    assert index.codes.is_cuda and q.params.rotation.is_cuda
    ps.reset_launch_counts()
    for k in (10, 100):
        index.search_with_scores(x[:5], k)
    assert (ps.pq_scan_topk_fused.launches, ps.pq_score_all.launches) == (2, 0)


@pytest.mark.parametrize("name", ["sq", "lvq"])
def test_generic_scan_stays_on_the_card_without_kernels(dev, name):
    x = torch.randn((3000, 32), generator=torch.Generator(dev).manual_seed(7), device=dev)
    q = SQ(SQConfig(8)) if name == "sq" else LVQ(LVQConfig(8))
    index = FlatQuantizedIndex(q).fit(x)
    assert index.codes.is_cuda
    ps.reset_launch_counts()
    pk.reset_launch_counts()
    ids, _ = index.search_with_scores(x[:5], 10)
    assert ids.shape == (5, 10)
    assert ps.pq_scan_topk_fused.launches == pk.packed_scan_topk.launches == 0


@pytest.mark.parametrize("name", ["pq", "saq"])
def test_residual_ivf_stays_on_the_card(dev, name):
    """IvfQuantizedIndex builds and searches on the card (plain torch list
    scans, no scan kernel), both strategies agreeing."""
    x = torch.randn((6000, 64), generator=torch.Generator(dev).manual_seed(8), device=dev)
    q = PQ(PQConfig(8, 8, KMeansConfig(iters=3))) if name == "pq" else SAQ(
        SAQConfig(bits_per_dim=2.0, block_dims=16))
    index = IvfQuantizedIndex(q, IVFConfig(16, 3, KMeansConfig(iters=3))).fit(x)
    assert index.codes_sorted.is_cuda and index.centroids.is_cuda
    ps.reset_launch_counts()
    pk.reset_launch_counts()
    ui, us = index.search_with_scores(x[:9], 10)
    wi, ws = index.search_with_scores(x[:9], 10, strategy="windows")
    assert ui.shape == (9, 10) and np.allclose(us, ws, rtol=1e-4, atol=1e-4)
    assert ps.pq_scan_topk_fused.launches == pk.packed_scan_topk.launches == 0
    assert index.decompress(np.arange(5)).is_cuda


def _same_ids_where_separated(got_i, want_i, want_s, rtol=1e-5):
    """ids equal wherever the reference's score at that rank is more than
    rtol · max|score| from its neighbours' (f32 sums in another order may
    swap rounding ties)."""
    tol = rtol * np.abs(want_s).max()
    sep = np.ones(want_i.shape, dtype=bool)
    gap = np.abs(np.diff(want_s, axis=1)) > tol
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(got_i[sep], want_i[sep])


def test_pq_nine_bits_keeps_uint16_codes_on_the_card(dev):
    """PQ at B=9 (512 codewords) on the card: uint16 codes in the flat and
    the residual IVF index, the plain scans (the kernels take uint8 codes,
    K ≤ 256), and the ids and footprint of the same index copied to the
    CPU.  f32 throughout (use_bf16 off), so the two devices score alike up
    to summation order."""
    from vq_tpu_torch import SearchConfig, convert

    x = torch.randn((3000, 16), generator=torch.Generator(dev).manual_seed(10), device=dev)
    cfg, scfg = PQConfig(4, 9, KMeansConfig(iters=3)), SearchConfig(use_bf16=False)
    flat = FlatQuantizedIndex(PQ(cfg), scfg).fit(x)
    ivf = IvfQuantizedIndex(PQ(cfg), IVFConfig(16, 3, KMeansConfig(iters=3)), scfg).fit(x)
    assert flat.codes.is_cuda and ivf.codes_sorted.is_cuda
    assert flat.codes.dtype == ivf.codes_sorted.dtype == torch.uint16
    ps.reset_launch_counts()
    pk.reset_launch_counts()
    got = {"flat": flat.search_with_scores(x[:9], 10),
           "union": ivf.search_with_scores(x[:9], 10),
           "windows": ivf.search_with_scores(x[:9], 10, strategy="windows")}
    assert ps.pq_scan_topk_fused.launches == ps.pq_score_all.launches == 0
    assert pk.packed_scan_topk.launches == pk.packed_scan_topk.gather_launches == 0

    def h(t):
        return t.cpu().numpy()

    flat_cpu = convert.flat_index_from_numpy(
        h(flat.quantizer.params.codebooks), h(flat.codes), h(flat.norms), flat.num_rows, scfg,
        cfg, device="cpu")
    ivf_cpu = convert.ivf_index_from_numpy(
        convert.pq_from_numpy(h(ivf.quantizer.params.codebooks), cfg, device="cpu"),
        h(ivf.centroids), h(ivf.codes_sorted), h(ivf.ids_sorted), h(ivf.norms_sorted),
        h(ivf.offsets), h(ivf.sizes), h(ivf._inv_perm), h(ivf._assignment), ivf.ivf_cfg, scfg)
    assert flat_cpu.codes.dtype == ivf_cpu.codes_sorted.dtype == torch.uint16
    assert flat_cpu.memory_footprint() == flat.memory_footprint()
    assert ivf_cpu.memory_footprint() == ivf.memory_footprint()
    qc = x[:9].cpu()
    want = {"flat": flat_cpu.search_with_scores(qc, 10),
            "union": ivf_cpu.search_with_scores(qc, 10),
            "windows": ivf_cpu.search_with_scores(qc, 10, strategy="windows")}
    for name, (wi, ws) in want.items():
        gi, gs = got[name]
        _same_ids_where_separated(gi, wi, ws)
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-5 * np.abs(ws).max())


def test_sq_sixteen_bits_in_the_residual_ivf_on_the_card(dev):
    """SQ at 16 bits stores uint16 codes too: the residual IVF index walks
    them on the card (both strategies) with the ids of its CPU copy."""
    from types import SimpleNamespace

    from vq_tpu_torch import SearchConfig, convert

    x = torch.randn((3000, 16), generator=torch.Generator(dev).manual_seed(11), device=dev)
    scfg = SearchConfig(use_bf16=False)
    ivf = IvfQuantizedIndex(SQ(SQConfig(16)), IVFConfig(16, 3, KMeansConfig(iters=3)),
                            scfg).fit(x)
    assert ivf.codes_sorted.is_cuda and ivf.codes_sorted.dtype == torch.uint16

    def h(t):
        return t.cpu().numpy()

    p = ivf.quantizer.params
    ivf_cpu = convert.ivf_index_from_numpy(
        convert.sq_from_numpy(SimpleNamespace(lo=h(p.lo), scale=h(p.scale)), 16, SQConfig(16),
                              device="cpu"),
        h(ivf.centroids), h(ivf.codes_sorted), h(ivf.ids_sorted), h(ivf.norms_sorted),
        h(ivf.offsets), h(ivf.sizes), h(ivf._inv_perm), h(ivf._assignment), ivf.ivf_cfg, scfg)
    assert ivf_cpu.memory_footprint() == ivf.memory_footprint()
    for strategy in ("union", "windows"):
        gi, gs = ivf.search_with_scores(x[:9], 10, strategy=strategy)
        wi, ws = ivf_cpu.search_with_scores(x[:9].cpu(), 10, strategy=strategy)
        _same_ids_where_separated(gi, wi, ws)
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-5 * np.abs(ws).max())
    np.testing.assert_allclose(h(ivf.decompress(np.arange(5))),
                               h(ivf_cpu.decompress(np.arange(5))), rtol=1e-6, atol=1e-6)


def test_kmeans_is_deterministic_on_the_card(dev):
    from vq_tpu_torch._device import make_generator
    from vq_tpu_torch.kernels.kmeans import kmeans, kmeans_batched

    x = torch.randn((20000, 32), generator=torch.Generator(dev).manual_seed(9), device=dev)
    cfg = KMeansConfig(iters=5)
    a = kmeans(make_generator(0, dev), x, 256, cfg)
    b = kmeans(make_generator(0, dev), x, 256, cfg)
    assert torch.equal(a, b)
    xs = x.reshape(20000, 4, 8).transpose(0, 1)
    assert torch.equal(kmeans_batched(make_generator(1, dev), xs, 64, cfg),
                       kmeans_batched(make_generator(1, dev), xs, 64, cfg))


def test_sharded_indexes_route_through_the_kernels_on_one_card(dev):
    """A mesh of 4 shards on one card: each sharded search launches its
    kernel once a shard (fused PQ at k ≤ 128, the score kernel above,
    packed, gather), the residual sharded IVF none; PQ equals the flat
    index bit for bit, everything stays on the card."""
    from vq_tpu_torch import SearchConfig
    from vq_tpu_torch.dist import (ShardedFlatPQIndex, ShardedIVFIndex, ShardedIvfPackedIndex,
                                   ShardedPackedFlatIndex, make_mesh)

    mesh = make_mesh(devices=["cuda"] * 4)
    assert mesh.root.index is not None and mesh.distinct() == (mesh.root,)
    x = torch.randn((6001, 64), generator=torch.Generator(dev).manual_seed(12), device=dev)
    pq = PQ(PQConfig(8, 8, KMeansConfig(iters=3))).fit(x)
    flat = FlatQuantizedIndex(pq).fit(x)
    spq = ShardedFlatPQIndex(pq, mesh=mesh).fit(x)
    assert all(c.is_cuda for c in spq.codes)
    for k in (10, 100):
        want = flat.search_with_scores(x[:9], k)
        ps.reset_launch_counts()
        got = spq.search_with_scores(x[:9], k)
        assert (ps.pq_scan_topk_fused.launches, ps.pq_score_all.launches) == (4, 0)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    ps.reset_launch_counts()
    spq.search_with_scores(x[:9], 200)
    assert ps.pq_scan_topk_fused.launches == 0 and ps.pq_score_all.launches >= 4
    saq = SAQ(SAQConfig(bits_per_dim=2.0, block_dims=16))
    spk = ShardedPackedFlatIndex(saq, SearchConfig(), mesh).fit(x)
    assert all(c.factors.is_cuda and c.perm.is_cuda for c in spk.shards)
    pk.reset_launch_counts()
    ids, _ = spk.search_with_scores(x[:9], 10)
    assert ids.shape == (9, 10) and int(ids.max()) < 6001
    assert pk.packed_scan_topk.launches == 4
    sivf = ShardedIvfPackedIndex(saq, IVFConfig(16, 3, KMeansConfig(iters=3)), mesh=mesh).fit(x)
    sivf.search_with_scores(x[:9], 10)
    assert (pk.packed_scan_topk.gather_launches, pk.packed_scan_topk.launches) == (4, 4)
    ivf = ShardedIVFIndex(SQ(SQConfig(8)), IVFConfig(16, 3, KMeansConfig(iters=3)),
                          mesh=mesh).fit(x)
    ps.reset_launch_counts()
    ids, _ = ivf.search_with_scores(x[:9], 10)
    assert ids.shape == (9, 10) and all(c.is_cuda for c in ivf.codes_sh)
    assert ps.pq_scan_topk_fused.launches == 0 and pk.packed_scan_topk.gather_launches == 4


def test_kernels_launch_on_their_tensors_card_not_the_current_one(dev):
    """Tensors on cuda:1 while cuda:0 is current: every kernel launches on
    cuda:1 (its attributes, occupancy and launch under the tensors' device)
    and returns what the same call on cuda:0 returns, bit for bit."""
    from vq_tpu_torch.methods import packed as pr

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    torch.cuda.set_device(d0)
    q, codes, cb = _inputs(d0)
    x = torch.randn((6000, 64), generator=torch.Generator(d0).manual_seed(13), device=d0)
    sq = SAQ(SAQConfig(bits_per_dim=2.0, block_dims=16))
    cache = FlatQuantizedIndex(sq).fit(x)._scan_cache
    a0 = pr.packed_scan_args(sq.packed_route(), x[:9], cache, 10, Metric.L2)
    mask = (torch.arange(cache.factors.shape[1] // 512, device=d0) % 2).to(torch.int32)
    want = [ps.pq_scan_topk_fused(q, codes, cb, 10), ps.pq_score_all(q, codes, cb),
            pk.packed_scan_topk(**a0), pk.packed_scan_topk(**a0, tile_mask=mask)]

    def on1(v):
        if isinstance(v, torch.Tensor):
            return v.to(d1)
        if isinstance(v, tuple):
            return tuple(on1(t) for t in v)
        return v

    a1 = {key: on1(v) for key, v in a0.items()}
    got = [ps.pq_scan_topk_fused(*on1((q, codes, cb)), 10),
           ps.pq_score_all(*on1((q, codes, cb))), pk.packed_scan_topk(**a1),
           pk.packed_scan_topk(**a1, tile_mask=mask.to(d1))]
    torch.cuda.synchronize(d1)
    assert torch.cuda.current_device() == 0
    for g, w in zip(got, want):
        for gt, wt in zip(g if isinstance(g, tuple) else (g,), w if isinstance(w, tuple) else (w,)):
            assert gt.device == d1 and torch.equal(gt.cpu(), wt.cpu())
