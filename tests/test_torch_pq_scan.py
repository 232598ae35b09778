"""The port's PQ scan kernels (kernels/pq_scan.py) against the JAX Pallas
kernels (vq_tpu/kernels/pallas_scan.py) run in interpret mode on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions; both sides
round queries and codebooks to bf16 and accumulate in f32 (the TPU kernel's
mode), so scores agree to f32 summation order: 1e-5 relative to the score
scale.  Ids must be equal, in lax.top_k's order (score desc, id asc).

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
compares them with the plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.kernels import pallas_scan as jps
from vq_tpu_torch.kernels import _build
from vq_tpu_torch.kernels import pq_scan as tps

torch.set_num_threads(1)

TILE = 256


def _setup(n=2048, d=64, q=16, m=8, kk=16, seed=0):
    rng = np.random.default_rng(seed)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    codes = rng.integers(0, kk, (n, m)).astype(np.uint8)
    cb = rng.standard_normal((m, kk, d // m)).astype(np.float32)
    return queries, codes, cb


def _both(queries, codes, cb):
    j = (jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(cb))
    t = (torch.from_numpy(queries), torch.from_numpy(codes), torch.from_numpy(cb))
    return j, t


def _scale(s):
    return 1e-5 * float(np.abs(s).max())


@pytest.mark.parametrize("l2", [True, False])
def test_pq_score_all_matches_pallas(l2):
    j, t = _both(*_setup(seed=1))
    want = np.asarray(jps.pq_score_all(*j, tile=TILE, l2=l2, interpret=True))
    got = tps.pq_score_all(*t, l2=l2, use_bf16=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_scale(want))


@pytest.mark.parametrize("k", [5, 7, 32, 100])
def test_pq_scan_topk_fused_matches_pallas(k):
    """k < 32 and k ≥ 32 take the two fold variants of the TPU kernel."""
    j, t = _both(*_setup(seed=2))
    ws, wi = jps.pq_scan_topk_fused(*j, k=k, tile=TILE, l2=True, interpret=True)
    gs, gi = tps.pq_scan_topk_fused(*t, k, l2=True, use_bf16=True)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=_scale(ws))


@pytest.mark.parametrize("limit", [300, 3])
def test_pq_scan_topk_fused_limit_matches_pallas(limit):
    """Rows at or past `limit` are masked; with limit < k the tail of the
    result is −inf with id 0."""
    k = 5
    j, t = _both(*_setup(n=512, seed=3))
    ws, wi = jps.pq_scan_topk_fused(*j, k=k, tile=TILE, l2=False, limit=jnp.int32(limit),
                                    interpret=True)
    gs, gi = tps.pq_scan_topk_fused(*t, k, l2=False, limit=limit, use_bf16=True)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert np.all(gi.numpy() < max(limit, 1))
    if limit < k:
        assert np.all(np.isneginf(gs.numpy()[:, limit:]))
        assert np.all(gi.numpy()[:, limit:] == 0)
    np.testing.assert_array_equal(np.isneginf(gs.numpy()), np.isneginf(np.asarray(ws)))


@pytest.mark.parametrize("k", [6, 40])
def test_pq_scan_topk_fused_planted_ties_match_pallas(k):
    """Every row identical: all scores tie, ids must come out 0..k-1."""
    rng = np.random.default_rng(4)
    codes = np.repeat(rng.integers(0, 16, (1, 8)), 512, axis=0).astype(np.uint8)
    queries = rng.standard_normal((4, 64)).astype(np.float32)
    cb = rng.standard_normal((8, 16, 8)).astype(np.float32)
    j, t = _both(queries, codes, cb)
    _, wi = jps.pq_scan_topk_fused(*j, k=k, tile=TILE, l2=True, interpret=True)
    _, gi = tps.pq_scan_topk_fused(*t, k, l2=True, use_bf16=True)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gi.numpy(), np.tile(np.arange(k), (4, 1)))


def test_plain_f32_mode_is_exact_decode_matmul():
    """use_bf16=False scores are the f32 decode-then-matmul scores."""
    queries, codes, cb = _setup(seed=5)
    _, t = _both(queries, codes, cb)
    dec = cb[np.arange(8), codes.astype(np.int64)].reshape(len(codes), -1)
    want = 2.0 * queries @ dec.T - np.sum(dec * dec, axis=1)[None]
    got = tps.pq_score_all(*t, l2=True, use_bf16=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_scale(want))


def test_wrapper_validates_inputs_before_launch():
    _, t = _both(*_setup(seed=6))
    q, codes, cb = t
    with pytest.raises(ValueError, match="k="):
        tps._check_inputs(q, codes, cb, k=129)
    with pytest.raises(ValueError, match="codes must be"):
        tps._check_inputs(q, codes.to(torch.int32), cb)
    with pytest.raises(ValueError, match="shapes disagree"):
        tps._check_inputs(q[:, :32].contiguous(), codes, cb)


# ---------------------------------------------------------- route and grid plan
@pytest.mark.parametrize("dsub", [1, 2, 3, 8, 16, 24, 32, 48, 96, 192])
@pytest.mark.parametrize("use_bf16", [True, False])
def test_pq_route_decodes_only_bf16_at_small_dsub(dsub, use_bf16):
    """The rule is a pure function of the shapes: the decode route (tensor
    cores) in bf16 mode at dsub ≤ DECODE_MAX_DSUB, tables otherwise; f32
    mode always on tables.  The main path's shapes: M=192 at D=1536 (dsub 8)
    decodes, M=16 (dsub 96) looks up."""
    want = "decode" if use_bf16 and dsub <= tps.DECODE_MAX_DSUB else "table"
    assert tps.pq_route(dsub, use_bf16) == want
    assert tps.pq_route(8, True) == "decode" and tps.pq_route(96, True) == "table"


class _Lib:
    """The library's layout constants and a table of resident blocks per SM
    ({(decode, qb): blocks}, qb the decode route's query-tile width or the
    table route's queries a block; a launch missing from it cannot run)."""

    def __init__(self, per_sm):
        self.per_sm = per_sm

    def vq_pq_decode_tile_rows(self):
        return 128

    def vq_pq_table_step_rows(self):
        return 512

    def vq_pq_table_group(self):
        return 4

    def vq_merge_cap(self):
        return 4096

    def vq_pq_table_blocks_per_sm(self, qb, m, kk, k, score_all, vec16):
        return self.per_sm.get((0, qb), 0)

    def vq_pq_decode_slots(self, qn, m, k, score_all, cluster):
        return self.per_sm.get((1, qn), 0) * 132


@pytest.mark.parametrize("fits,want", [({(0, 8): 1, (0, 4): 2, (0, 1): 3, (0, 0): 1}, 8),
                                       ({(0, 4): 2, (0, 1): 3, (0, 0): 1}, 4),
                                       ({(0, 1): 3, (0, 0): 1}, 1),
                                       ({(0, 0): 1}, 0)])
def test_plan_table_route_keeps_as_many_tables_as_fit(fits, want):
    """8 queries' tables in shared memory where a block of them fits, else
    4, else 1, else one query's read from global memory (qb 0)."""
    qb, _, cluster = tps._plan(_Lib(fits), 132, "table", 16, 256, 10, 1024, 100_000, 1)
    assert qb == want and cluster == 1


def test_plan_raises_when_no_block_fits():
    with pytest.raises(RuntimeError, match="no decode block"):
        tps._plan(_Lib({}), 132, "decode", 192, 256, 10, 1024, 100_000, 0)


@pytest.mark.parametrize("route", ["decode", "table"])
@pytest.mark.parametrize("num_q", [1, 7, 65, 1024, 20000])
@pytest.mark.parametrize("k", [0, 1, 10, 100, 128])
def test_plan_chunks_follow_the_reported_occupancy(route, num_q, k):
    """Chunks come from grid_chunks at the reported blocks per SM: at least
    one and at most one a row tile; the fused kernel's lists within the
    merge cap (one launch, or groups of cap // k lists); beyond one wave,
    whole waves up to one chunk column; one chunk when the query blocks
    alone fill the slots.  The score kernel (k = 0) merges nothing."""
    sms, per_sm, n = 132, 2, 100_000
    lib = _Lib({**{(1, w): per_sm for w in tps.DECODE_WIDTHS}, (0, 8): per_sm})
    qb, chunks, cluster = tps._plan(lib, sms, route, 16, 256, k, num_q, n, 1)
    rows, per_block = (128, tps.decode_width(num_q)) if route == "decode" else (512, 8)
    assert qb == per_block
    qblocks, slots = -(-num_q // per_block), sms * per_sm
    assert qblocks % cluster == 0 and (cluster == 1 or qb == 256)
    assert 1 <= chunks <= -(-n // rows)
    if k:
        g = 4096 // k
        groups = _build.merge_groups(chunks, 4096, k)
        assert chunks * k <= 4096 or (chunks == groups * g and groups <= g)
    if qblocks >= slots:
        assert chunks == 1
    blocks = qblocks * chunks
    if blocks > slots and k == 0:  # short of whole waves by less than a chunk column
        assert -blocks % slots < qblocks


@pytest.mark.parametrize("num_q,want", [(1, 64), (8, 64), (16, 64), (17, 64), (64, 64),
                                        (65, 256), (128, 256), (129, 256), (256, 256),
                                        (1024, 256), (20000, 256)])
@pytest.mark.parametrize("k", [0, 10, 100])
def test_plan_decode_width_is_the_narrowest_instance_covering_q(num_q, want, k):
    """The decode route's query tile is the narrowest instance of
    DECODE_WIDTHS covering min(Q, widest): the b8 cell's Q=8 the mma.sync
    kernel's 64, Q=1024 four wgmma tiles of 256.  The library is asked for that
    instance's resident blocks, on the wgmma kernel in clusters of the most
    query tiles (4, else 2, else 1) dividing their count, and the chunks keep
    the fused kernel's lists within the merge cap, each query block with at
    least one and at most one row tile a chunk."""
    asked = []

    class Lib(_Lib):
        def vq_pq_decode_slots(self, qn, m, k, score_all, cluster):
            asked.append((qn, k, score_all, cluster))
            return 132

    n = 1_000_000
    qb, chunks, cluster = tps._plan(Lib({}), 132, "decode", 192, 256, k, num_q, n, 0)
    assert qb == want == tps.decode_width(num_q)
    assert want in tps.DECODE_WIDTHS and want >= min(num_q, max(tps.DECODE_WIDTHS))
    assert all(w < min(num_q, want) for w in tps.DECODE_WIDTHS if w < want)
    qblocks = -(-num_q // want)
    want_cluster = next(c for c in (4, 2, 1) if qblocks % c == 0) if want == 256 else 1
    assert cluster == want_cluster and asked == [(want, k, int(k == 0), want_cluster)]
    assert 1 <= chunks <= -(-n // 128)
    if k:
        g = 4096 // k
        groups = _build.merge_groups(chunks, 4096, k)
        assert chunks * k <= 4096 or (chunks == groups * g and groups <= g)


def test_launch_counter_by_width_and_its_reset():
    """Each launch counts once in ``launches``; a decode launch also under
    its query-tile width in ``launches_by_width``, the table route's not;
    ``reset_launch_counts`` clears both."""
    tps.reset_launch_counts()
    tps._count_launch(100, "decode", 256)
    tps._count_launch(100, "decode", 256)
    tps._count_launch(10, "decode", 64)
    tps._count_launch(0, "decode", 64)
    tps._count_launch(10, "table", 8)
    assert tps.pq_scan_topk_fused.launches == 4 and tps.pq_score_all.launches == 1
    assert tps.pq_scan_topk_fused.launches_by_width == {256: 2, 64: 1}
    assert tps.pq_score_all.launches_by_width == {64: 1}
    tps.reset_launch_counts()
    assert tps.pq_scan_topk_fused.launches == tps.pq_score_all.launches == 0
    assert tps.pq_scan_topk_fused.launches_by_width == tps.pq_score_all.launches_by_width == {}
