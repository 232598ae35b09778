"""The port's mesh and sharded functions (``vq_tpu_torch/dist/mesh.py``,
``dist/sharded.py``) against the JAX package's (``vq_tpu/dist``) on the CPU.

The JAX side runs on its 8 virtual CPU devices (``tests/conftest.py``), the
port on ``make_mesh(devices=["cpu"] * 8)``; both get the same numpy inputs
made from a seed (PQ codebooks and codes fitted by the JAX package).

Tolerances and their reasons:
* ids: equal at every rank whose score is separated from its neighbours by
  more than the score tolerance (``assert_where_separated``): f32 sums in
  another order may swap ties within it.
* scores: within 1e-4·(‖q‖² + 2·max‖x̂‖²) a query, a bound on the terms an
  L2 score 2·q·x̂ − ‖x̂‖² is the difference of (f32 sums of D terms in
  another order).
* overlap_chunks 1 against 4, the collectives, the merge and two runs of
  the Lloyd step: exact (the same arithmetic in the same order).
* the Lloyd step against JAX's: 1e-5 relative (the one-hot product and the
  segment sums add the same rows in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core.config import KMeansConfig, Metric, PQConfig, SQConfig
from vq_tpu.dist import mesh as jmesh
from vq_tpu.dist import sharded as jsh
from vq_tpu.methods import pq as jpq
from vq_tpu.methods.sq import SQ as JaxSQ
from vq_tpu_torch import Metric as TMetric
from vq_tpu_torch import convert
from vq_tpu_torch.dist import mesh as tmesh
from vq_tpu_torch.dist import sharded as tsh
from vq_tpu_torch.dist.dryrun import dryrun_multichip
from vq_tpu_torch.kernels.kmeans import _lloyd_iter
from vq_tpu_torch.kernels.pq_scan import decode_pq

torch.set_num_threads(1)

P = 8
F32_RTOL = 1e-4


def cpu_mesh(p=P):
    return tmesh.make_mesh(devices=["cpu"] * p)


def score_tol(q: np.ndarray, x_hat: np.ndarray) -> np.ndarray:
    """(Q, 1): F32_RTOL · (‖q‖² + 2·max‖x̂‖²)."""
    return F32_RTOL * (np.sum(q * q, axis=1, keepdims=True)
                       + 2.0 * float(np.max(np.sum(x_hat * x_hat, axis=1))))


def assert_where_separated(got_ids, got_s, want_ids, want_s, tol):
    """Scores within ``tol`` ((Q, 1) or a scalar); ids equal at every rank
    whose wanted score is more than ``tol`` from both neighbours."""
    got_ids, want_ids = np.asarray(got_ids), np.asarray(want_ids)
    got_s, want_s = np.asarray(got_s), np.asarray(want_s)
    assert got_ids.shape == want_ids.shape
    err = np.abs(got_s - want_s)
    assert bool((err <= tol).all()), float((err - tol).max())
    gap = np.abs(np.diff(want_s, axis=1))
    sep = np.ones_like(want_s, dtype=bool)
    sep[:, 1:] &= gap > tol
    sep[:, :-1] &= gap > tol
    assert sep.any()
    np.testing.assert_array_equal(got_ids[sep], want_ids[sep])


@pytest.fixture(scope="module")
def pq_data():
    """Ragged N (1003 rows over 8 shards), PQ M=4 B=6 fitted by JAX."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1003, 32)).astype(np.float32)
    q = rng.standard_normal((9, 32)).astype(np.float32)
    cfg = PQConfig(num_subquantizers=4, num_bits=6, kmeans=KMeansConfig(iters=6))
    params = jpq.fit(jax.random.PRNGKey(0), jnp.asarray(x), cfg)
    codes = np.array(jpq.encode(params, jnp.asarray(x)))  # writable, for torch
    return x, q, np.array(params.codebooks), codes


# ------------------------------------------------------------------ the mesh
def test_make_mesh_keeps_repeated_devices_in_order():
    m = tmesh.make_mesh(3, devices=["cpu"] * 5)
    assert m.size == 3 and m.root == torch.device("cpu") and m.distinct() == (m.root,)
    assert m.axis_names == (tmesh.DATA_AXIS,) == jmesh.make_mesh().axis_names
    with pytest.raises(AttributeError):
        m.size = 4
    with pytest.raises(ValueError, match="needs 6 devices"):
        tmesh.make_mesh(6, devices=["cpu"] * 5)


def test_shard_rows_and_replicate():
    m = cpu_mesh(4)
    x = np.arange(24, dtype=np.float32).reshape(12, 2)
    parts = tmesh.shard_rows(m, x)
    assert [tuple(p.shape) for p in parts] == [(3, 2)] * 4
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    with pytest.raises(ValueError, match="pad them first"):
        tmesh.shard_rows(m, x[:10])
    padded = tmesh.pad_rows_to_multiple(x[:10], 4)
    np.testing.assert_array_equal(padded, jmesh.pad_rows_to_multiple(x[:10], 4))
    tp = tmesh.pad_rows_to_multiple(torch.from_numpy(x[:10]), 4)
    np.testing.assert_array_equal(tp.numpy(), padded)
    reps = tmesh.replicate(m, x)
    assert all(r is reps[0] for r in reps)  # one copy a distinct device


def test_collectives_run_in_shard_order():
    m = cpu_mesh(3)
    parts = [torch.full((2, 2), float(p)) for p in range(3)]
    got = tmesh.all_gather(m, parts)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got[0].numpy(), [0, 0, 1, 1, 2, 2])
    vals = [torch.tensor([1e8], dtype=torch.float32), torch.tensor([1.0]),
            torch.tensor([-1e8])]
    # (1e8 + 1) − 1e8 = 0 in f32; a sum in another order would give 1
    assert float(tmesh.psum(m, vals)) == float((vals[0] + vals[1]) + vals[2])


def test_replicate_quantizer_moves_no_param_on_its_own_device():
    sq = convert.sq_from_numpy(type("P", (), {"lo": np.zeros(4, np.float32),
                                              "scale": np.ones(4, np.float32)}),
                               4, convert.config_from_jax(SQConfig(8)), device="cpu")
    reps = tmesh.replicate_quantizer(cpu_mesh(3), sq)
    assert all(r is sq for r in reps)


# ------------------------------------------------------------------ the merge
def test_merge_breaks_planted_ties_as_lax_top_k():
    """Every score equal across 4 shards' candidates (shard order = id
    order): the merge takes the lowest ids, as ``lax.top_k`` over the
    shard-ordered concatenation takes the earliest columns."""
    m = cpu_mesh(4)
    k = 5
    ids = [torch.arange(p * 100, p * 100 + k, dtype=torch.int32)[None].repeat(3, 1)
           for p in range(4)]
    scores = [torch.full((3, k), 2.5) for _ in range(4)]
    scores[2][:, 0] = 3.0  # one better candidate on shard 2
    for metric in (TMetric.L2, TMetric.IP):
        nat = [s if metric == TMetric.IP else -s for s in scores]
        s, i = tsh._merge_local_topk(m, nat, ids, k, metric)
        cat_s = np.concatenate([s_.numpy() for s_ in scores], axis=1)
        cat_i = np.concatenate([i_.numpy() for i_ in ids], axis=1)
        ws, wpos = jax.lax.top_k(jnp.asarray(cat_s), k)
        np.testing.assert_array_equal(i.numpy(), np.take_along_axis(cat_i, np.asarray(wpos), 1))
        np.testing.assert_array_equal(s.numpy(), np.asarray(ws) * (1 if metric == TMetric.IP
                                                                   else -1))
        assert i[0].tolist() == [200, 0, 1, 2, 3]


def test_merge_fills_missing_slots_with_empty_ones():
    s, i = tsh.merge_topk(torch.tensor([[1.0, -np.inf]]), torch.tensor([[7, 9]]), 4)
    assert s.tolist() == [[1.0, -np.inf, -np.inf, -np.inf]] and i.tolist() == [[7, 0, 0, 0]]


# ------------------------------------------------------------- sharded scans
@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP])
def test_sharded_scan_topk_matches_jax_at_ragged_n(pq_data, metric):
    x, q, cb, codes = pq_data
    jm = jmesh.make_mesh()
    codes_p = jmesh.pad_rows_to_multiple(codes, P * 4)
    ws, wi = jsh.sharded_scan_topk(
        jm, jmesh.replicate(jm, jnp.asarray(q)), jmesh.shard_rows(jm, jnp.asarray(codes_p)),
        jmesh.replicate(jm, jnp.asarray(cb)), k=20, metric=metric, true_n=len(x),
        use_bf16=False)
    m = cpu_mesh()
    tmetric = TMetric(metric.value)
    out = {}
    for chunks in (1, 4):
        s, i = tsh.sharded_scan_topk(m, torch.from_numpy(q), tmesh.shard_rows(m, codes_p),
                                     torch.from_numpy(cb), 20, tmetric, true_n=len(x),
                                     use_bf16=False, overlap_chunks=chunks)
        out[chunks] = (s.numpy(), i.numpy())
        assert bool((i < len(x)).all())
    np.testing.assert_array_equal(out[1][0], out[4][0])
    np.testing.assert_array_equal(out[1][1], out[4][1])
    x_hat = decode_pq(torch.from_numpy(cb), torch.from_numpy(codes)).numpy()
    assert_where_separated(out[1][1], out[1][0], np.asarray(wi), np.asarray(ws),
                           score_tol(q, x_hat))


def test_sharded_generic_scan_topk_matches_jax(pq_data):
    """SQ 8-bit's decode_fn on the sharded generic scan, NIP (norms sharded
    with the codes), overlap_chunks 1 and 4."""
    x, q, _, _ = pq_data
    jq = JaxSQ(SQConfig(num_bits=8)).fit(x)
    codes = np.asarray(jq.compress(x))
    norms = np.linalg.norm(x, axis=1).astype(np.float32)
    jm = jmesh.make_mesh()
    codes_p = jmesh.pad_rows_to_multiple(codes, P * 4)
    norms_p = np.pad(norms, (0, len(codes_p) - len(norms)), constant_values=1.0)
    ws, wi = jsh.sharded_generic_scan_topk(
        jm, jnp.asarray(q), jmesh.shard_rows(jm, jnp.asarray(codes_p)), jq.decode_fn(), 10,
        metric=Metric.NIP, norms=jmesh.shard_rows(jm, jnp.asarray(norms_p)), true_n=len(x),
        use_bf16=False)
    tq = convert.sq_from_numpy(jax.tree_util.tree_map(np.asarray, jq.params), x.shape[1],
                               convert.config_from_jax(jq.cfg), device="cpu")
    m = cpu_mesh()
    got = [tsh.sharded_generic_scan_topk(m, torch.from_numpy(q), codes_p, tq.decode_fn(), 10,
                                         TMetric.NIP, norms=norms_p, true_n=len(x),
                                         use_bf16=False, overlap_chunks=c) for c in (1, 4)]
    assert torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1])
    x_hat = tq.decompress(codes).numpy() / norms[:, None]
    assert_where_separated(got[0][1].numpy(), got[0][0].numpy(), np.asarray(wi),
                           np.asarray(ws), score_tol(q, x_hat))


def test_sharded_exact_topk_matches_jax(pq_data):
    x, q, _, _ = pq_data
    jm = jmesh.make_mesh()
    xp = jmesh.pad_rows_to_multiple(x, P)
    ws, wi = jsh.sharded_exact_topk(jm, jnp.asarray(q), jmesh.shard_rows(jm, jnp.asarray(xp)),
                                    k=10, true_n=len(x))
    s, i = tsh.sharded_exact_topk(cpu_mesh(), torch.from_numpy(q), xp, 10, true_n=len(x))
    assert_where_separated(i.numpy(), s.numpy(), np.asarray(wi), np.asarray(ws),
                           score_tol(q, x))


# -------------------------------------------------------------- Lloyd step
def test_dp_lloyd_step_matches_jax_and_repeats_bit_for_bit():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1600, 16)).astype(np.float32)
    c0 = x[:8].copy()
    jm = jmesh.make_mesh()
    want = np.asarray(jsh.dp_lloyd_step(jm, jnp.asarray(x), jnp.asarray(c0)))
    m = cpu_mesh()
    got = [tsh.dp_lloyd_step(m, x, c0).numpy() for _ in range(2)]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-6)
    single = _lloyd_iter(torch.from_numpy(x), torch.from_numpy(c0)).numpy()
    np.testing.assert_allclose(got[0], single, rtol=1e-5, atol=1e-6)


def test_dryrun_multichip_on_eight_cpu_shards(capsys):
    dryrun_multichip(8, device="cpu")
    assert capsys.readouterr().out.strip().endswith("dryrun_multichip(8): ok")
