"""The port's mesh across processes (``vq_tpu_torch/dist`` under a
``torch.distributed`` group, ``maybe_init_distributed``) on the CPU.

Groups of gloo ranks are spawned once for the module: 2 ranks, which run a
mesh of 2 shards each (P=4) and a ragged one of 2 + 1 shards (P=3), and 4
ranks of one shard each (P=4).  Each rank runs every case of
``torch_dist_ranks.CASES`` (the collectives, the three sharded scans,
``dp_lloyd_step`` and the five sharded indexes' fit + search +
``memory_footprint`` + ``reconstruction_mse``) on its mesh and writes the
results to a file; the parent runs the same cases on a one-process mesh of
as many shards.  Every rank's results equal the one-process mesh's bit for
bit: ids, scores, centroids, footprints and errors.  That mesh is held
against the JAX package's 8-device mesh by ``test_torch_dist_sharded.py``
and the ``test_torch_sharded_*.py`` files; here the PQ scan and the sharded
PQ index are also held against the JAX package's directly, at those
files' tolerance (ids equal where separated, scores within
1e-4·(‖q‖² + 2·max‖x̂‖²)).

Every wait is bounded: each group's waits end after 60 s, and the ranks
are killed if they have not ended 120 s after they started.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_dist_ranks as ranks_prog
from vq_tpu.core.config import KMeansConfig, Metric, PQConfig, SearchConfig
from vq_tpu.dist import mesh as jmesh
from vq_tpu.dist import sharded as jsh
from vq_tpu.dist.mesh import maybe_init_distributed as jax_maybe_init
from vq_tpu.dist.sharded_index import ShardedFlatPQIndex as JaxShardedPQ
from vq_tpu.methods.pq import PQ as JaxPQ
from vq_tpu_torch.dist import make_mesh, maybe_init_distributed
from vq_tpu_torch.kernels.pq_scan import decode_pq

from test_torch_dist_sharded import assert_where_separated, score_tol

torch.set_num_threads(1)

JOIN_TIMEOUT_S = 120.0
# group → (ranks, {layout: shards per rank})
GROUPS = {"2 ranks": (2, {"2 ranks x 2 shards": (2, 2), "2 ranks, 2 + 1 shards": (2, 1)}),
          "4 ranks": (4, {"4 ranks x 1 shard": (1, 1, 1, 1)})}
LAYOUTS = {name: per_rank for _, layouts in GROUPS.values() for name, per_rank in layouts.items()}
PQ_CFG = PQConfig(num_subquantizers=4, num_bits=6, kmeans=KMeansConfig(iters=6))


@pytest.fixture(scope="module")
def inputs():
    """``torch_dist_ranks.make_inputs`` and PQ M=4 B=6 fitted by JAX on x."""
    inp = ranks_prog.make_inputs()
    jq = JaxPQ(PQ_CFG, seed=0).fit(inp["x"])
    inp["codebooks"] = np.array(jq.params.codebooks)
    inp["codes"] = np.array(jq.compress(inp["x"]))
    return inp, jq


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Every group's ranks, spawned together and joined within
    JOIN_TIMEOUT_S (then killed) → {layout: [rank 0's results, …]} and
    {group: [rank 0's results, …]}."""
    ctx = mp.get_context("spawn")
    procs, works = [], {}
    for group, (world, layouts) in GROUPS.items():
        work = tmp_path_factory.mktemp(group.replace(" ", "_"))
        np.savez(work / "inputs.npz", **inputs[0])
        works[group] = work
        procs += [(group, r, ctx.Process(target=ranks_prog.run_rank,
                                         args=(r, world, str(work), layouts)))
                  for r in range(world)]
    for _, _, p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for _, _, p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [(g, r) for g, r, p in procs if p.is_alive()]
    for _, _, p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"ranks still running after {JOIN_TIMEOUT_S} s, killed: {hung}"
    failed = {(g, r): p.exitcode for g, r, p in procs if p.exitcode != 0}
    errors = "".join((works[g] / f"rank{r}.err").read_text() for g, r in failed
                     if (works[g] / f"rank{r}.err").exists())
    assert not failed, f"ranks failed (exit codes {failed}):\n{errors}"
    by_group = {g: [torch.load(works[g] / f"rank{r}.pt", weights_only=False)
                    for r in range(world)] for g, (world, _) in GROUPS.items()}
    by_layout = {name: [got[name] for got in by_group[g]]
                 for g, (_, layouts) in GROUPS.items() for name in layouts}
    return by_layout, by_group


@pytest.fixture(scope="module")
def one_process(inputs):
    """The cases on a one-process mesh of P CPU shards, by P."""
    return {p: ranks_prog.run_cases(make_mesh(devices=["cpu"] * p), inputs[0])
            for p in sorted({sum(v) for v in LAYOUTS.values()})}


@pytest.mark.parametrize("case", ranks_prog.CASES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_every_rank_equals_the_one_process_mesh(ranks, one_process, layout, case):
    want = one_process[sum(LAYOUTS[layout])][case]
    for r, got in enumerate(ranks[0][layout]):
        assert len(got[case]) == len(want)
        for a, b in zip(got[case], want):
            assert a.dtype == b.dtype and a.shape == b.shape, (r, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r}")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_holds_every_ranks_shards_rank_major(ranks, layout):
    """The same owners on every rank, rank-major, each rank's own shards
    local, and the collectives went through torch.distributed."""
    per_rank = LAYOUTS[layout]
    owners = tuple(r for r, count in enumerate(per_rank) for _ in range(count))
    for r, got in enumerate(ranks[0][layout]):
        got_owners, local, exchanges = got["mesh"]
        assert got_owners == owners
        assert local == tuple(p for p, o in enumerate(owners) if o == r)
        assert exchanges > 0


def test_sharded_scan_topk_matches_jax(ranks, inputs):
    """Every layout's and rank's PQ scan (L2, k=10) against the JAX
    package's on its 8 virtual devices, on the same codes."""
    inp = inputs[0]
    x, q, cb, codes = inp["x"], inp["q"], inp["codebooks"], inp["codes"]
    jm = jmesh.make_mesh()
    codes_p = jmesh.pad_rows_to_multiple(codes, 8)
    ws, wi = jsh.sharded_scan_topk(
        jm, jmesh.replicate(jm, jnp.asarray(q)), jmesh.shard_rows(jm, jnp.asarray(codes_p)),
        jmesh.replicate(jm, jnp.asarray(cb)), k=10, metric=Metric.L2, true_n=len(x),
        use_bf16=False)
    x_hat = decode_pq(torch.from_numpy(cb), torch.from_numpy(codes)).numpy()
    for layout, per_rank in ranks[0].items():
        for got in per_rank:
            s, i = got["scan L2 k=10"]
            assert_where_separated(i, s, np.asarray(wi), np.asarray(ws), score_tol(q, x_hat))


def test_sharded_pq_index_matches_jax(ranks, inputs):
    """ShardedFlatPQIndex on the JAX package's codebooks, every layout and
    rank, against the JAX package's ShardedFlatPQIndex (k=40): the same
    footprint, ids where separated."""
    inp, jq = inputs
    j = JaxShardedPQ(jq, SearchConfig(use_bf16=False)).fit(inp["x"])
    wi, ws = j.search_with_scores(inp["q"], 40)
    x_hat = decode_pq(torch.from_numpy(inp["codebooks"]), torch.from_numpy(inp["codes"])).numpy()
    for layout, per_rank in ranks[0].items():
        for got in per_rank:
            ids, scores, footprint, _ = got["ShardedFlatPQIndex (given codebooks)"]
            assert_where_separated(ids, scores, wi, ws, score_tol(inp["q"], x_hat))
            # the padding differs with the shard count: 2003 rows pad to
            # 2004 (P=3, 4) and to 2008 (P=8)
            pad = (-len(inp["x"])) % sum(LAYOUTS[layout]) - (-len(inp["x"])) % 8
            assert int(footprint) == j.memory_footprint() + pad * (4 + 4)


def test_save_is_refused_under_a_group_of_two(ranks):
    for r, got in enumerate(ranks[1]["2 ranks"]):
        assert got["save"].startswith("a mesh over 2 ranks cannot be saved"), got["save"]


def test_fits_that_differ_between_ranks_are_refused_on_every_rank(ranks):
    """PQ fitted from another seed on each rank: the all-gathered checksum
    differs, and every rank raises (none waits for the others)."""
    for per_rank in ranks[1].values():
        for got in per_rank:
            assert got["diverged"].startswith("pq's params differ between ranks"), got["diverged"]


def test_dryrun_multichip_runs_on_every_rank(ranks):
    assert all(got["dryrun"] == "ok" for per_rank in ranks[1].values() for got in per_rank)


def test_maybe_init_distributed_is_a_noop_without_vq_dist_init(monkeypatch):
    """Both packages' hook: without VQ_DIST_INIT neither initializes."""
    monkeypatch.delenv("VQ_DIST_INIT", raising=False)
    assert jax_maybe_init() is None and jax.process_count() == 1
    assert maybe_init_distributed(device="cpu") is None
    assert not dist.is_initialized()


def test_maybe_init_distributed_raises_when_the_init_fails(monkeypatch):
    """With VQ_DIST_INIT set and no rendezvous to reach (``env://`` without
    MASTER_ADDR), the port raises where the JAX package passes."""
    monkeypatch.setenv("VQ_DIST_INIT", "1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="environment variable"):
        maybe_init_distributed(device="cpu", rank=0, world_size=2, timeout_s=5.0)
    assert not dist.is_initialized()
