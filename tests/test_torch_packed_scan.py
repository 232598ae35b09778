"""The port's plain packed scan (kernels/packed_scan.py) against the JAX
Pallas kernel (vq_tpu/kernels/pallas_packed.py::packed_scan_topk) run in
interpret mode, on the same words, factors and level tables.

The inputs are made with numpy and packed by the JAX package; the port gets
them through ``convert.packed_corpus_from_numpy`` (factors transposed to
feature-major).  Both sides compute in f32 (``use_bf16=False``; one bf16
case rounds both sides' queries and values the same way).  Ids must be
equal, in lax.top_k's order; scores agree to 1e-5 of the largest |score|
(f32 sums of D = 92 products in another order).  With prune on, the
count of tiles scanned must equal JAX's.  The gather mode (``tile_mask``,
``mask_cap``) is held the same way against the Pallas gather kernel: only
masked-in tiles, in ascending order, take part, in the prune sequence too,
and ``mask_cap`` never changes a result.  The CUDA kernel itself runs only
on a card (chip_smoke.py holds it against this plain version there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.kernels import pallas_packed as jpp
from vq_tpu_torch import convert
from vq_tpu_torch.kernels import _build
from vq_tpu_torch.kernels import packed_scan as tps

torch.set_num_threads(1)

N, Q = 2048, 6
# (bits, ln, dequant, scale_col): all four kinds, a skinny 1-bit segment
# widened by choose_beff, a shared table
SEG_FAMILY = [(3, 32, "uniform", 0), (2, 16, "perdim", 1), (6, 24, "values", 2),
              (1, 20, "uniform", 3)]
RABITQ_FAMILY = [(2, 48, "shared", 0)]


def _case(layout, family, seed=0, ties=False):
    """Numpy inputs for both kernels.  Rows get a per-tile scale that falls
    tile by tile, so a later tile's prune bound can lose to the running
    k-th score; stats bound every row's value norm."""
    rng = np.random.default_rng(seed)
    segs = tuple(jpp.make_segspec(b, ln, kind, sc) for b, ln, kind, sc in layout)
    d = sum(s.ln for s in segs)
    words, lv, val_parts = [], [], []
    scale = np.repeat(np.array([2.0, 1.0, 0.5, 0.25]), N // 4).astype(np.float32)
    scale = scale * rng.uniform(0.8, 1.2, N).astype(np.float32)
    fac_cols = [scale] * len(segs)
    for s in segs:
        idx = rng.integers(0, 1 << s.bits, (N, s.ln))
        if ties:
            idx[:] = idx[0]
        if s.dequant == "values":
            v = rng.standard_normal((N, s.ln)).astype(np.float32)
            if ties:
                v[:] = v[0]
            words.append(v)
            val_parts.append(v)
            continue
        words.append(np.asarray(jpp.pack_words(jnp.asarray(idx), s.bits, s.beff, tile=512)))
        if s.dequant == "uniform":
            val_parts.append((idx + 0.5) * 2.0 / (1 << s.bits) - 1.0)
            continue
        rows = s.ln if s.dequant == "perdim" else 1
        t = np.sort(rng.standard_normal((rows, 1 << s.bits)).astype(np.float32), axis=1)
        lv.append(t)
        val_parts.append(t[np.arange(s.ln) % rows, idx])
    vals = np.concatenate(val_parts, axis=1) * scale[:, None]
    r2 = np.sum(vals ** 2, axis=1)
    shift = (r2 + rng.uniform(-0.1, 0.1, N)).astype(np.float32)
    norms = np.sqrt(r2).astype(np.float32) + 0.5
    factors = np.stack(fac_cols + [shift, norms], axis=1).astype(np.float32)
    rn = np.sqrt(r2).reshape(-1, 512)
    nn = norms.reshape(-1, 512)
    stats = np.stack([rn.min(1), rn.max(1), np.zeros(N // 512), nn.min(1), nn.max(1)],
                     axis=1).astype(np.float32)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    qa = rng.standard_normal(Q).astype(np.float32)
    # (A, B) with B = ‖q‖: a true bound for IP; for the parity check any row works
    qprune = np.stack([qa, np.linalg.norm(q, axis=1)], axis=1).astype(np.float32)
    nf = factors.shape[1]
    return dict(q=q, qa=qa, words=words, factors=factors, lv=lv, segs=segs, stats=stats,
                qprune=qprune, family=family, norm_col=nf - 1, r2_cols=(nf - 2,))


def _jax(c, k, metric_kind, prune=False, limit=None, use_bf16=False, tile_mask=None,
         mask_cap=None):
    out = jpp.packed_scan_topk(
        jnp.asarray(c["q"]), jnp.asarray(c["qa"]), tuple(jnp.asarray(w) for w in c["words"]),
        jnp.asarray(c["factors"]), tuple(jnp.asarray(t) for t in c["lv"]), c["segs"], k,
        family=c["family"], metric_kind=metric_kind, norm_col=c["norm_col"],
        r2_cols=c["r2_cols"], limit=None if limit is None else jnp.int32(limit),
        interpret=True, use_bf16=use_bf16, prune=prune,
        tile_stats=jnp.asarray(c["stats"]) if prune else None,
        qprune=jnp.asarray(c["qprune"]) if prune else None,
        tile_mask=None if tile_mask is None else jnp.asarray(tile_mask, jnp.int32),
        mask_cap=mask_cap)
    return [np.asarray(a) for a in out]


def _port(c, k, metric_kind, prune=False, limit=None, use_bf16=False, tile_mask=None,
          mask_cap=None):
    packed = convert.packed_corpus_from_numpy(c["words"], c["factors"], N, c["stats"],
                                              device="cpu")
    out = tps.packed_scan_topk(
        torch.from_numpy(c["q"]), torch.from_numpy(c["qa"]), packed.words, packed.factors,
        tuple(torch.from_numpy(t) for t in c["lv"]),
        tuple(tps.SegSpec(*s) for s in c["segs"]), k, family=c["family"],
        metric_kind=metric_kind, norm_col=c["norm_col"], r2_cols=c["r2_cols"], limit=limit,
        use_bf16=use_bf16, prune=prune, tile_stats=packed.tile_stats if prune else None,
        qprune=torch.from_numpy(c["qprune"]) if prune else None,
        tile_mask=None if tile_mask is None else torch.tensor(tile_mask, dtype=torch.int32),
        mask_cap=mask_cap)
    return [t.numpy() for t in out]


def _assert_same(j, t, k=None):
    """t's top-k equals the first k of j (an exact top-k's prefix is the
    smaller k's top-k)."""
    k = t[1].shape[1] if k is None else k
    js, ji = j[0][:, :k], j[1][:, :k]
    np.testing.assert_array_equal(t[1], ji)
    finite = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(t[0]), finite)
    scale = 1e-5 * max(1.0, float(np.abs(js[finite]).max(initial=0.0)))
    np.testing.assert_allclose(t[0][finite], js[finite], rtol=0, atol=scale)


@pytest.mark.parametrize("family,layout", [("seg", SEG_FAMILY), ("rabitq", RABITQ_FAMILY)])
@pytest.mark.parametrize("metric_kind", ["l2", "ip", "nip"])
def test_plain_matches_pallas(family, layout, metric_kind):
    """Dense and pruned scans at k=5 and 10 (the JAX kernel's k < 32 fold);
    with prune on, the tiles scanned equal JAX's."""
    c = _case(layout, family, seed=len(layout))
    for prune in (False, True):
        j = _jax(c, 10, metric_kind, prune=prune)
        for k in (5, 10):
            t = _port(c, k, metric_kind, prune=prune)
            _assert_same(j, t)
            if prune and k == 10:
                assert int(t[2]) == int(j[2]), (int(t[2]), int(j[2]))


def test_large_k_matches_pallas():
    """k = 32 and 100 against the JAX kernel's k ≥ 32 merge fold; prune on
    (the IP bound of the case holds for every row, so pruning is exact)."""
    c = _case(SEG_FAMILY, "seg", seed=8)
    j = _jax(c, 100, "ip", prune=True)
    for k in (32, 100):
        _assert_same(j, _port(c, k, "ip"))
    t = _port(c, 100, "ip", prune=True)
    _assert_same(j, t)
    assert int(t[2]) == int(j[2])


def test_prune_skips_tiles_and_keeps_the_result():
    """The case's falling row scale lets the IP bound skip later tiles; the
    result equals the dense scan's."""
    c = _case(RABITQ_FAMILY, "rabitq", seed=3)
    j = _jax(c, 5, "ip", prune=True)
    t = _port(c, 5, "ip", prune=True)
    assert int(t[2]) == int(j[2]) < N // 512
    _assert_same(j, t)
    np.testing.assert_array_equal(t[1], _port(c, 5, "ip")[1])


@pytest.mark.parametrize("limit", [1300, 3])
def test_limit_matches_pallas(limit):
    """Rows at or past `limit` are masked; with limit < k the tail of the
    result is −inf with id 0."""
    c = _case(SEG_FAMILY, "seg", seed=5)
    j, t = _jax(c, 10, "l2", limit=limit), _port(c, 10, "l2", limit=limit)
    _assert_same(j, t)
    assert (t[1] < limit).all()
    if limit < 10:
        assert np.isneginf(t[0][:, limit:]).all() and (t[1][:, limit:] == 0).all()


def test_bf16_mode_matches_pallas():
    """Both round queries and scaled values to bf16 and accumulate in f32."""
    c = _case(SEG_FAMILY, "seg", seed=6)
    _assert_same(_jax(c, 10, "ip", use_bf16=True), _port(c, 10, "ip", use_bf16=True))


def test_planted_ties_match_pallas():
    """Every row identical: all scores tie, ids must come out 0..k-1."""
    c = _case(SEG_FAMILY, "seg", seed=7, ties=True)
    c["factors"][:, :4] = 1.0  # equal scales, so equal rows
    j = _jax(c, 6, "ip")
    np.testing.assert_array_equal(_port(c, 6, "ip")[1], j[1])
    np.testing.assert_array_equal(j[1], np.tile(np.arange(6), (Q, 1)))
    np.testing.assert_array_equal(_port(c, 40, "ip")[1], np.tile(np.arange(40), (Q, 1)))


# (mask over the case's 4 tiles, limit): every tile, none, a random pick, one
# tile, and only the last tile made partial by `limit`
MASKS = {"all": ([1, 1, 1, 1], None), "none": ([0, 0, 0, 0], None),
         "random": ([1, 0, 1, 1], None), "one": ([0, 1, 0, 0], None),
         "last_partial": ([0, 0, 0, 1], 1800)}


@pytest.mark.parametrize("mask_name", list(MASKS))
def test_gather_matches_pallas(mask_name):
    """The plain twin's gather mode against the Pallas gather kernel at k=5
    and 10 (ids equal, scores to 1e-5 of the largest): every id lies in a
    masked-in tile below `limit`; all tiles equal the dense scan, no tile
    gives −inf with id 0."""
    mask, limit = MASKS[mask_name]
    c = _case(SEG_FAMILY, "seg", seed=9)
    j = _jax(c, 10, "l2", limit=limit, tile_mask=mask)
    for k in (5, 10):
        t = _port(c, k, "l2", limit=limit, tile_mask=mask)
        _assert_same(j, t)
    finite = np.isfinite(t[0])
    assert np.isin(t[1][finite] // 512, np.flatnonzero(mask)).all()
    assert (t[1][finite] < (limit or N)).all()
    if mask_name == "all":
        dense = _port(c, 10, "l2")
        np.testing.assert_array_equal(t[0], dense[0])
        np.testing.assert_array_equal(t[1], dense[1])
    if mask_name == "none":
        assert np.isneginf(t[0]).all() and (t[1] == 0).all()


@pytest.mark.parametrize("family,layout,metric_kind",
                         [("seg", SEG_FAMILY, "l2"), ("rabitq", RABITQ_FAMILY, "ip")])
def test_gather_prune_matches_pallas(family, layout, metric_kind):
    """Prune over a mask: the bound test and the count run over the
    masked-in tiles alone, so the count equals JAX's and is at most the
    masked-in count; the ids equal the unpruned gather's."""
    mask = [1, 0, 1, 1]
    c = _case(layout, family, seed=3)
    j = _jax(c, 5, metric_kind, prune=True, tile_mask=mask)
    t = _port(c, 5, metric_kind, prune=True, tile_mask=mask)
    _assert_same(j, t)
    assert int(t[2]) == int(j[2]) <= sum(mask), (int(t[2]), int(j[2]))
    np.testing.assert_array_equal(t[1], _port(c, 5, metric_kind, tile_mask=mask)[1])


@pytest.mark.parametrize("mask_cap", [2, 3])
def test_gather_mask_cap_never_changes_the_result(mask_cap):
    """A cap below the masked-in count (3) sends JAX to its full grid, one
    at the count to its short grid; the port ignores the cap: one result."""
    mask = [1, 0, 1, 1]
    c = _case(SEG_FAMILY, "seg", seed=4)
    t = _port(c, 5, "ip", tile_mask=mask, mask_cap=mask_cap)
    _assert_same(_jax(c, 5, "ip", tile_mask=mask, mask_cap=mask_cap), t)
    for a, b in zip(t, _port(c, 5, "ip", tile_mask=mask)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_tile_mask_is_jax_argsort(seed):
    """The wrapper's compaction: masked-in ids first, ascending (JAX's
    stable ``argsort(~mask)``), and their count."""
    mask = np.random.default_rng(seed).random(37) < [0.5, 0.05, 0.0][seed]
    ids, cnt = tps.compact_tile_mask(torch.from_numpy(mask.astype(np.int32)))
    assert ids.dtype == torch.int32 and cnt.shape == (1,)
    np.testing.assert_array_equal(ids.numpy(), np.argsort(~mask, kind="stable"))
    assert int(cnt[0]) == mask.sum()


def test_wrapper_validates_inputs_before_launch():
    c = _case(SEG_FAMILY, "seg")
    packed = convert.packed_corpus_from_numpy(c["words"], c["factors"], N, c["stats"],
                                              device="cpu")
    segs = tuple(tps.SegSpec(*s) for s in c["segs"])
    lv = tuple(torch.from_numpy(t) for t in c["lv"])
    q, qa = torch.from_numpy(c["q"]), torch.from_numpy(c["qa"])
    kw = dict(metric_kind="l2", family="seg", norm_col=c["norm_col"], r2_cols=c["r2_cols"],
              prune=False, tile_stats=None, qprune=None)
    tps._check_inputs(q, qa, packed.words, packed.factors, lv, segs, 10, **kw)
    with pytest.raises(ValueError, match="k="):
        tps._check_inputs(q, qa, packed.words, packed.factors, lv, segs, 129, **kw)
    with pytest.raises(ValueError, match="words must be"):
        tps._check_inputs(q, qa, (packed.words[0].to(torch.int64),) + packed.words[1:],
                          packed.factors, lv, segs, 10, **kw)
    with pytest.raises(ValueError, match="level table"):
        tps._check_inputs(q, qa, packed.words, packed.factors, (), segs, 10, **kw)
    with pytest.raises(ValueError, match="multiple of 512"):
        tps._check_inputs(q, qa, packed.words, packed.factors.T, lv, segs, 10, **kw)
    tps._check_inputs(q, qa, packed.words, packed.factors, lv, segs, 10, **kw,
                      tile_mask=torch.ones(N // 512, dtype=torch.bool))
    for bad in (torch.ones(N // 512), torch.ones(N // 512 + 1, dtype=torch.int32)):
        with pytest.raises(ValueError, match="tile_mask"):
            tps._check_inputs(q, qa, packed.words, packed.factors, lv, segs, 10, **kw,
                              tile_mask=bad)


@pytest.mark.parametrize("qblocks", [1, 2, 3, 4, 5, 8, 64])
@pytest.mark.parametrize("k", [1, 10, 100, 128])
def test_grid_chunks_splits_the_tiles(qblocks, k):
    """The card's grid split: at most one chunk per tile; every merge launch
    within the merge cap (one launch of chunks·k candidates, or groups of
    cap // k lists first); beyond one wave, whole waves up to one chunk
    column (one group of lists where the merge takes two launches)."""
    slots, cap = 132, 4096
    g = cap // k
    for nb in (1, 7, 196, 2048):
        chunks = _build.grid_chunks(slots, qblocks, nb, cap, k)
        groups = _build.merge_groups(chunks, cap, k)
        assert 1 <= chunks <= nb
        if groups:
            assert chunks == groups * g and groups * k <= cap and qblocks * g < slots
        else:
            assert chunks * k <= cap
        blocks = qblocks * chunks
        if blocks > slots:
            assert -blocks % slots < qblocks * (g if groups else 1)


@pytest.mark.parametrize("qblocks", [132, 200, 5000])
def test_grid_chunks_one_chunk_when_query_blocks_fill_the_slots(qblocks):
    assert _build.grid_chunks(132, qblocks, 2048, 4096, 10) == 1
    assert _build.merge_groups(1, 4096, 128) == 0


@pytest.mark.parametrize("num_q", [1, 63, 64, 65, 256, 1024, 5000])
def test_scan_width_rule(num_q):
    """The bf16 kernel's query-tile width: 64 up to 64 queries (one block
    for the 53M cell's batches), then tiles of 128, and the prune's work
    units counted in blocks of that width.  Whether a width fits a block's
    shared memory is the library's to say (``vq_packed_blocks_per_sm``,
    asked on the card for each width)."""
    w = tps.scan_width(num_q)
    assert w in tps.SCAN_WIDTHS
    assert w == {1: 64, 63: 64, 64: 64, 65: 128, 256: 128, 1024: 128, 5000: 128}[num_q]
    assert w >= min(num_q, tps.SCAN_WIDTHS[-1])
    units = tps.prune_units(num_q, 4 * tps.TILE, "cuda")
    assert units == -(-num_q // w) * 4


def test_reset_launch_counts_clears_the_width_counter():
    tps.packed_scan_topk.launches_by_width[64] = 3
    tps.packed_scan_topk.launches += 1
    tps.reset_launch_counts()
    assert tps.packed_scan_topk.launches_by_width == {}
    assert tps.packed_scan_topk.launches == 0 and tps.packed_scan_topk.gather_launches == 0


def test_reset_launch_counts_clears_the_dequant_counter():
    """The register-table count starts at 0, a plain (CPU) scan adds
    nothing to it, and the reset clears it."""
    tps.reset_launch_counts()
    assert tps.packed_scan_topk.register_table_launches == 0
    seg = tps.make_segspec(4, 32, "shared", 0)
    words = torch.zeros((tps.TILE // seg.u, 32), dtype=torch.int32)
    lv = torch.linspace(-1.0, 1.0, 16).reshape(1, 16)
    tps.packed_scan_topk(torch.ones((2, 32)), torch.zeros((2,)), (words,),
                         torch.ones((1, tps.TILE)), (lv,), (seg,), 5, family="rabitq",
                         metric_kind="ip")
    assert tps.packed_scan_topk.register_table_launches == 0
    tps.packed_scan_topk.register_table_launches = 2
    tps.reset_launch_counts()
    assert tps.packed_scan_topk.register_table_launches == 0
