"""The port's SAQ head-segment cascade (``methods/saq.py::scan_topk`` with
``prune_segments`` > 0, ``_saq_rerank``) against the JAX package's, with the
JAX package's fitted plan and params converted through numpy; then the
JAX package's own cascade tests (``tests/test_saq_rerank.py``) on the
port's fit.

Both sides run f32 (``use_bf16=False``).  Tolerances: ids equal except
inside runs of scores equal to 1e-5 relative; scores within 1e-5 of the
largest |score| (an L2 distance is a difference of terms that can be far
larger than it).  The JAX packed route runs its Pallas kernel in
interpret mode, the port's its plain twin; k1 = rerank_factor·k stays
below 32, where an interpret-mode compile costs ~1.5 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core.config import Metric, SAQConfig
from vq_tpu.methods import saq as jsaq
from vq_tpu_torch import convert
from vq_tpu_torch.kernels.adc import exact_topk
from vq_tpu_torch.methods import saq as tsaq

from test_torch_flat_index import assert_close_scores, assert_same_ranking

torch.set_num_threads(1)

N, D, NQ = 1300, 96, 7  # ragged: 1300 rows pad to 1536
K, RF = 3, 10  # k1 = 30
CFGS = {"uniform": SAQConfig(bits_per_dim=2.0, block_dims=16),  # 3 segments
        "lloyd": SAQConfig(bits_per_dim=3.0, block_dims=16, codebook="lloyd")}  # 2
METRICS = [Metric.L2, Metric.IP, Metric.NIP]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    x = (rng.standard_normal((N, D)) * np.linspace(2.5, 0.05, D)).astype(np.float32)
    x *= np.exp(0.5 * rng.standard_normal((N, 1))).astype(np.float32)
    q = x[rng.integers(0, N, NQ)] + 0.1 * rng.standard_normal((NQ, D)).astype(np.float32)
    return x, q, np.linalg.norm(x, axis=1)


@pytest.fixture(scope="module", params=list(CFGS))
def pair(request, data):
    cfg = CFGS[request.param]
    j = jsaq.SAQ(cfg).fit(data[0])
    t = convert.saq_from_numpy(j.plan, jax.tree_util.tree_map(np.asarray, j.params),
                               convert.config_from_jax(cfg), device="cpu")
    assert j.plan.num_segments >= 2, j.plan
    return request.param, j, t, np.array(j.compress(data[0]))  # writable, for torch


def _same(got, want):
    gs, gi = (a.numpy() for a in got)
    ws, wi = (np.asarray(a) for a in want)
    assert gi.dtype == np.int32 and gi.shape == wi.shape
    assert_same_ranking(gi, wi, ws)
    assert_close_scores(gs, ws)


@pytest.mark.parametrize("metric", METRICS)
def test_plain_route_cascade_matches_jax(pair, data, metric):
    """use_packed=False: stage 1 streams the head segments' scores, stage 2
    reranks; every head length the plan allows."""
    _, j, t, jc = pair
    _, q, norms = data
    for p in range(1, j.plan.num_segments):
        want = jsaq.scan_topk(j.plan, j.params, jnp.asarray(q), jnp.asarray(jc), K, metric,
                              norms=jnp.asarray(norms), use_bf16=False, use_packed=False,
                              prune_segments=p, rerank_factor=RF, tile_rows=512)
        got = tsaq.scan_topk(t.plan, t.params, torch.from_numpy(q), torch.from_numpy(jc), K,
                             metric, norms=torch.from_numpy(norms), use_bf16=False,
                             use_packed=False, prune_segments=p, rerank_factor=RF,
                             tile_rows=512)
        _same(got, want)


def test_plain_route_approx_matches_jax(pair, data):
    """approx=True on the plain route (JAX's ``approx_max_k`` on a 1300-wide
    tile, its exact top-k off the TPU): JAX's result, and the port's exact
    one bit for bit, at k=20 dense and k=3 through the cascade."""
    _, j, t, jc = pair
    _, q, _ = data
    qt, ct = torch.from_numpy(q), torch.from_numpy(jc)
    for k, p in ((20, 0), (K, 1)):
        kw = dict(use_bf16=False, use_packed=False, prune_segments=p, rerank_factor=RF)
        want = jsaq.scan_topk(j.plan, j.params, jnp.asarray(q), jnp.asarray(jc), k, Metric.L2,
                              approx=True, **kw)
        got = tsaq.scan_topk(t.plan, t.params, qt, ct, k, Metric.L2, approx=True, **kw)
        exact = tsaq.scan_topk(t.plan, t.params, qt, ct, k, Metric.L2, **kw)
        assert torch.equal(got[0], exact[0]) and torch.equal(got[1], exact[1])
        _same(got, want)


@pytest.mark.parametrize("sort_rows", [True, False])
def test_packed_route_cascade_matches_pallas(pair, data, sort_rows):
    """The packed route: stage 1 is the packed kernel over the head segment
    (the Pallas kernel in interpret mode, the port's plain twin), on a
    norm-ordered cache (candidates mapped through perm) and on an
    order-preserving one; L2, IP and NIP on the uniform codebook, L2 on
    lloyd (few interpret-mode calls)."""
    name, j, t, jc = pair
    _, q, norms = data
    jp = jsaq.prepare_packed(j.plan, j.params, jnp.asarray(jc), norms=jnp.asarray(norms),
                             sort_rows=sort_rows)
    tp = tsaq.prepare_packed(t.plan, t.params, torch.from_numpy(jc),
                             norms=torch.from_numpy(norms), sort_rows=sort_rows)
    assert (tp.perm is not None) == sort_rows
    for metric in METRICS if name == "uniform" else [Metric.L2]:
        want = jsaq.scan_topk(j.plan, j.params, jnp.asarray(q), jnp.asarray(jc), K, metric,
                              norms=jnp.asarray(norms), use_bf16=False, prune_segments=1,
                              rerank_factor=RF, packed_cache=jp, use_packed=True,
                              interpret=True)
        got = tsaq.scan_topk(t.plan, t.params, torch.from_numpy(q), torch.from_numpy(jc), K,
                             metric, norms=torch.from_numpy(norms), use_bf16=False,
                             prune_segments=1, rerank_factor=RF, packed_cache=tp)
        _same(got, want)


def test_cascade_with_num_valid_matches_jax(pair, data):
    """Rows at or past num_valid never become candidates: plain route, and
    the packed route over an order-preserving cache."""
    name, j, t, jc = pair
    _, q, norms = data
    qj, qt, cj, ct = jnp.asarray(q), torch.from_numpy(q), jnp.asarray(jc), torch.from_numpy(jc)
    nv = 1000
    want = jsaq.scan_topk(j.plan, j.params, qj, cj, K, Metric.L2, use_bf16=False,
                          use_packed=False, num_valid=nv, prune_segments=1, rerank_factor=RF)
    got = tsaq.scan_topk(t.plan, t.params, qt, ct, K, Metric.L2, use_bf16=False,
                         use_packed=False, num_valid=nv, prune_segments=1, rerank_factor=RF)
    _same(got, want)
    assert int(got[1].max()) < nv
    if name != "uniform":
        return
    jp = jsaq.prepare_packed(j.plan, j.params, cj)
    tp = tsaq.prepare_packed(t.plan, t.params, ct)
    want = jsaq.scan_topk(j.plan, j.params, qj, cj, K, Metric.L2, use_bf16=False,
                          num_valid=nv, prune_segments=2, rerank_factor=RF, packed_cache=jp,
                          use_packed=True, interpret=True)
    got = tsaq.scan_topk(t.plan, t.params, qt, ct, K, Metric.L2, use_bf16=False, num_valid=nv,
                         prune_segments=2, rerank_factor=RF, packed_cache=tp)
    _same(got, want)
    assert int(got[1].max()) < nv


@pytest.mark.parametrize("metric", METRICS)
def test_rerank_matches_jax_and_ties_rank_by_candidate_position(pair, data, metric):
    """``_saq_rerank`` alone on the same candidates, with dead ones and
    duplicate rows: equal scores rank by candidate position (JAX's top_k
    over the candidates), not by row id."""
    _, j, t, jc = pair
    _, q, norms = data
    rng = np.random.default_rng(5)
    codes, norms = jc.copy(), norms.copy()
    codes[700:710], norms[700:710] = codes[17], norms[17]  # ten more copies of row 17
    cand = rng.integers(0, N, (NQ, 24)).astype(np.int32)
    cand[:, 3], cand[:, 9], cand[:, 15] = 705, 17, 702  # equal rows, out of id order
    alive = rng.random((NQ, 24)) > 0.2
    alive[:, [3, 9, 15]] = True
    ws, wi = jsaq._saq_rerank(j.plan, j.params, jnp.asarray(q), jnp.asarray(codes),
                              jnp.asarray(cand), jnp.asarray(alive), 20, metric,
                              norms=jnp.asarray(norms),
                              q_sq=jnp.sum(jnp.asarray(q) ** 2, axis=-1))
    qt = torch.from_numpy(q)
    got = tsaq._saq_rerank(t.plan, t.params, qt, torch.from_numpy(codes),
                           torch.from_numpy(cand), torch.from_numpy(alive), 20, metric,
                           norms=torch.from_numpy(norms), q_sq=torch.sum(qt * qt, dim=-1))
    _same(got, (ws, wi))
    for r in range(NQ):  # the three copies keep their candidate order
        row = got[1][r].tolist()
        at = [row.index(i) for i in (705, 17, 702) if i in row]
        assert at == sorted(at), row


def test_dense_routes_when_the_cascade_does_not_apply(pair, data):
    """rerank_factor·k > 128 on the packed route, and n ≤ 2·rerank_factor·k
    on either route, run the dense scan: bit for bit the search with
    prune_segments=0, and the JAX package's result."""
    _, j, t, jc = pair
    _, q, norms = data
    qt, nt = torch.from_numpy(q), torch.from_numpy(norms)

    def same_as_dense(codes, k, rf, **kw):
        a = tsaq.scan_topk(t.plan, t.params, qt, codes, k, Metric.L2, norms=nt, use_bf16=False,
                           prune_segments=1, rerank_factor=rf, **kw)
        b = tsaq.scan_topk(t.plan, t.params, qt, codes, k, Metric.L2, norms=nt, use_bf16=False,
                           **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        return a

    ct = torch.from_numpy(jc)
    same_as_dense(ct, 13, 10, packed_cache=t.prepare_scan(ct, norms=nt))  # k1 = 130 > 128
    small = ct[:600]  # 600 ≤ 2·100·3
    same_as_dense(small, K, 100)
    got = same_as_dense(small, K, 100, use_packed=False)
    _same(got, jsaq.scan_topk(j.plan, j.params, jnp.asarray(q), jnp.asarray(jc[:600]), K,
                              Metric.L2, use_bf16=False, use_packed=False, prune_segments=1,
                              rerank_factor=100))


def test_method_binds_positional_arguments_like_jax(pair, data):
    """SAQ.scan_topk(q, codes, k, metric, norms, tile_rows, use_bf16,
    approx, prune_segments, rerank_factor): the JAX package's order."""
    _, j, t, jc = pair
    _, q, norms = data
    args = (K, Metric.L2, None, 512, False, False, 1, RF)
    want = j.scan_topk(jnp.asarray(q), jnp.asarray(jc), *args)
    got = t.scan_topk(torch.from_numpy(q), torch.from_numpy(jc), *args)
    _same(got, want)


# -- the JAX package's cascade tests (tests/test_saq_rerank.py) on the port's fit


def _fit(rng, n=4000, d=96):
    sigma = np.linspace(2.5, 0.05, d)
    x = (rng.standard_normal((n, d)) * sigma).astype(np.float32)
    q = (x[rng.integers(0, n, 30)] + 0.1 * sigma * rng.standard_normal((30, d))).astype(
        np.float32)
    saq = tsaq.SAQ(SAQConfig(bits_per_dim=3.0, block_dims=16), device="cpu").fit(x)
    return saq, x, q, saq.compress(x)


# the packed route keeps k1 = rerank_factor·k ≤ 128, where its stage 1 runs
ROUTES = {"plain": dict(use_packed=False), "packed": dict(use_packed=None)}


def _search(saq, q, codes, k, route, **kw):
    return tsaq.scan_topk(saq.plan, saq.params, torch.from_numpy(q), codes, k, Metric.L2,
                          use_bf16=False, **ROUTES[route], **kw)


@pytest.mark.parametrize("route,rf", [("plain", 100), ("packed", 12)])
def test_port_rerank_matches_full_scan_at_high_factor(route, rf):
    saq, x, q, codes = _fit(np.random.default_rng(0))
    assert saq.plan.num_segments >= 2, saq.plan
    s_full, i_full = _search(saq, q, codes, 10, route)
    s_rr, i_rr = _search(saq, q, codes, 10, route, prune_segments=1, rerank_factor=rf)
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                       for a, b in zip(i_full.numpy(), i_rr.numpy())])
    assert overlap > 0.95, overlap
    # surviving candidates carry their exact full-precision scores
    sf = dict(zip(i_full[0].tolist(), s_full[0].tolist()))
    sr = dict(zip(i_rr[0].tolist(), s_rr[0].tolist()))
    for rid in set(sf) & set(sr):
        np.testing.assert_allclose(sf[rid], sr[rid], rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("route,rf", [("plain", 20), ("packed", 12)])
def test_port_rerank_recall_close_to_full(route, rf):
    saq, x, q, codes = _fit(np.random.default_rng(1))
    _, gt = exact_topk(torch.from_numpy(q), torch.from_numpy(x), 10)
    _, i_full = _search(saq, q, codes, 10, route)
    _, i_rr = _search(saq, q, codes, 10, route, prune_segments=1, rerank_factor=rf)

    def rec(ids):
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(gt.tolist(), ids.tolist())])

    assert rec(i_rr) >= rec(i_full) - 0.05, (rec(i_rr), rec(i_full))


def test_port_rerank_disabled_for_tiny_corpora():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((100, 32)) * np.linspace(2.0, 0.1, 32)).astype(np.float32)
    saq = tsaq.SAQ(SAQConfig(bits_per_dim=3.0, block_dims=16), device="cpu").fit(x)
    # n ≤ 2·rerank_factor·k → the full scan, still correct
    s, i = saq.scan_topk(torch.from_numpy(x[:5]), saq.compress(x), 10, Metric.L2,
                         use_bf16=False, prune_segments=1, rerank_factor=10)
    assert i.shape == (5, 10)
    assert (i[:, 0] == torch.arange(5)).all()  # self is nearest
