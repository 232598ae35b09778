"""The port's 53M envelope (``vq_tpu_torch/bench/scan53m.py``, the
counterpart of ``scripts/scan53m.py``) and engine step
(``vq_tpu_torch/entry.py``, the counterpart of ``__graft_entry__.entry()``)
on the CPU at small sizes.

* the SAQ bpd=1 packed cache filled in place chunk by chunk (3 chunks of
  1,024 rows and a ragged tail) equals ``prepare_packed`` over the whole
  corpus bit for bit — words, factors, tile stats — and the JAX package's
  ``prepare_packed`` on the same codes with its fit carried over: words
  byte for byte, factors and tile stats within 1e-5 of their largest
  magnitude (f32 sums in another order, as ``test_torch_saq.py`` holds
  them);
* PQ codes encoded chunk by chunk equal JAX's ``encode_chunked`` on the
  same numpy corpus with its codebooks carried over (a code may differ
  only at a near-tie: equal subspace distances within 1e-5 relative);
* the self-recall gate passes on a small corpus and exits 1 when the
  queries are shuffled against their sources;
* ``entry()`` puts its arrays on the card unless asked for the CPU, and
  its ids equal ``__graft_entry__.entry()``'s on the same arrays.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.core.config import KMeansConfig, PQConfig, SAQConfig
from vq_tpu.methods import pq as jpq
from vq_tpu.methods import saq as jsaq
from vq_tpu_torch import convert
from vq_tpu_torch.bench import scan53m
from vq_tpu_torch.methods import saq as tsaq

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CHUNK, N, D = 1024, 3 * 1024 + 300, 128  # D=128: one 1-bit segment stored 1 bit a row
SAQ_CFG = SAQConfig(bits_per_dim=1.0, allocator="uniform", use_pca=True)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(53)
    return (rng.standard_normal((N, D)) * (1.0 + np.arange(D)) ** -0.6).astype(np.float32)


def chunks_of(a, chunk=CHUNK):
    return [(i0, a[i0:i0 + chunk]) for i0 in range(0, a.shape[0], chunk)]


@pytest.fixture(scope="module")
def jax_saq(corpus):
    """The JAX package's SAQ bpd=1 fit and codes, and the port's SAQ on the
    same fit."""
    j = jsaq.SAQ(SAQ_CFG).fit(corpus)
    t = convert.saq_from_numpy(j.plan, jax.tree_util.tree_map(np.asarray, j.params),
                               convert.config_from_jax(SAQ_CFG), device="cpu")
    return j, t, np.array(j.compress(corpus))


def test_filled_cache_equals_prepare_packed_bit_for_bit(jax_saq):
    _, t, jc = jax_saq
    codes = torch.from_numpy(jc)
    assert t.plan.seg_bits == (1,) and t.plan.seg_lens == (D,)
    whole = tsaq.prepare_packed(t.plan, t.params, codes)
    filled = scan53m.fill_packed(t.plan, t.params, N, chunks_of(codes), "cpu")
    assert filled.num_rows == whole.num_rows == N and filled.perm is None
    assert len(filled.words) == len(whole.words) == 1
    assert filled.words[0].shape == ((N + (-N) % 512) // 32, D)  # 1 bit a row
    for a, b in zip(filled.words, whole.words):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(filled.factors, whole.factors)
    assert torch.equal(filled.tile_stats, whole.tile_stats)
    assert filled.prune_hint == whole.prune_hint and filled.has_norms == whole.has_norms


def test_filled_cache_equals_the_jax_packages_prepare_packed(jax_saq):
    j, t, jc = jax_saq
    jp = jsaq.prepare_packed(j.plan, j.params, jnp.asarray(jc))
    filled = scan53m.fill_packed(t.plan, t.params, N, chunks_of(torch.from_numpy(jc)), "cpu")
    assert filled.num_rows == jp.num_rows and filled.prune_hint == jp.prune_hint
    for a, b in zip(jp.words, filled.words):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    want = np.asarray(jp.factors).T
    np.testing.assert_allclose(filled.factors.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    want = np.asarray(jp.tile_stats)
    np.testing.assert_allclose(filled.tile_stats.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bad", ["overlap", "off-tile", "short"])
def test_fill_refuses_chunks_that_do_not_tile_the_corpus(jax_saq, bad):
    _, t, jc = jax_saq
    codes = torch.from_numpy(jc)
    parts = {"overlap": [(0, codes[:1024]), (512, codes[512:])],
             "off-tile": [(0, codes[:1000]), (1000, codes[1000:])],
             "short": [(0, codes[:2048])]}[bad]
    with pytest.raises(ValueError):
        scan53m.fill_packed(t.plan, t.params, N, parts, "cpu")


def test_chunked_pq_codes_equal_jax_encode_chunked(corpus):
    cfg = PQConfig(num_subquantizers=16, num_bits=8, kmeans=KMeansConfig(iters=4))
    cb = np.asarray(jpq.fit(jax.random.PRNGKey(0), jnp.asarray(corpus), cfg).codebooks)
    want = np.asarray(jpq.encode_chunked(jnp.asarray(cb), jnp.asarray(corpus)))
    params = convert.pq_params_from_numpy(cb, device="cpu")
    got = scan53m.encode_pq(params, N, chunks_of(torch.from_numpy(corpus))).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (N, 16)
    xs = corpus.reshape(N, 16, -1)
    diff = np.argwhere(got != want)
    for r, m in diff:  # near-ties only
        np.testing.assert_allclose(np.sum((xs[r, m] - cb[m, got[r, m]]) ** 2),
                                   np.sum((xs[r, m] - cb[m, want[r, m]]) ** 2), rtol=1e-5)
    assert len(diff) <= 3


@pytest.mark.parametrize("method", ["pq", "saq"])
def test_self_recall_gate_passes_and_fails_on_shuffled_queries(method, monkeypatch, capsys):
    argv = ["--n", "5000", "--chunk", "2048", "--q", "32", "--method", method, "--device", "cpu"]
    assert scan53m.main(argv) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n"] == 5000 and rec["top1_source_recovery"] >= scan53m.SELF_RECALL_FLOOR
    assert rec["card_name"] is None and rec["peak_device_bytes"] is None
    real = scan53m.self_recall_queries

    def shuffled(last, nq, sigma):
        q, src = real(last, nq, sigma)
        return q.flip(0), src
    monkeypatch.setattr(scan53m, "self_recall_queries", shuffled)
    assert scan53m.main(argv) == 1


def test_scan53m_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        scan53m.main(["--n", "1000"])


def test_entry_is_on_the_cpu_only_when_asked_and_equals_the_jax_entry(monkeypatch):
    from vq_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    assert [tuple(a.shape) for a in args] == [(16, 128), (4096, 16), (16, 256, 8)]
    assert [a.dtype for a in args] == [torch.float32, torch.uint8, torch.float32]
    scores, ids = fn(*args)
    sys.path.insert(0, str(ROOT))
    import __graft_entry__

    jfn, jargs = __graft_entry__.entry()
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    js, ji = jfn(*jargs)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        entry()
