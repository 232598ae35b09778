"""RaBitQ fitted on a row source and packed in place, on the CPU at small
sizes.

* ``fit`` on a row source (``vqbench/corpora/fullrank_stream.py``: rows made
  per request) takes the centroid in one chunked pass
  (``data/sampling.py::chunked_mean``) and equals the plain reference's
  fit (``vqbench/reference/rabitq.py``) bit for bit; on a tensor it keeps
  ``torch.mean``; the chunked mean does not depend on its chunk size;
* ``prepare_packed`` written in place (``methods/packed.py::PackedFill``)
  equals the concatenating version it replaced (kept below as
  ``prepare_packed_concat``) bit for bit, for the word and value-plane
  layouts, several chunk sizes, a ragged last tile, with and without norms;
* ``FlatQuantizedIndex(RaBitQ B=4).fit`` on a row source holds the
  reference's words and factors, and its answers are the reference's
  estimator top-k (``vqbench/reference/flat_rabitq.py``);
* the spans ``rabitq.centroid`` and ``rabitq.pack``.
"""

from __future__ import annotations

import pytest
import torch

from vq_tpu_torch import Metric, RaBitQConfig, SearchConfig
from vq_tpu_torch.data.sampling import chunked_mean
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.kernels.packed_scan import TILE
from vq_tpu_torch.methods import packed as pr
from vq_tpu_torch.methods import rabitq as trb
from vq_tpu_torch.methods.rabitq import RaBitQ
from vq_tpu_torch.utils import trace
from vqbench.corpora import fullrank_stream
from vqbench.reference import common, flat_rabitq
from vqbench.reference import rabitq as rrb
from vqbench.reference import saq as rsaq

torch.set_num_threads(1)
N, D, NQ = 5000, 64, 24  # 5000 = 9 tiles and a ragged 392


@pytest.fixture(scope="module")
def source():
    return fullrank_stream.make(N, D, NQ, 2**31 + 97, "cpu", block=1000, basis_seed=20261018)


def prepare_packed_concat(params, codes, num_bits, norms=None, row_chunk=131072):
    """``methods/rabitq.py::prepare_packed`` as it was before the layout was
    written in place: chunk lists, then one concatenation of each."""
    dev = codes.device
    n = codes.shape[0]
    row_chunk = max(TILE, row_chunk - row_chunk % TILE)
    n_pad = n + (-n) % TILE
    seg = trb._packed_segspec(params.centroid.shape[0], num_bits)
    c_rot = params.centroid @ params.rotation
    w_chunks, f_chunks, n_chunks, r_chunks = [], [], [], []
    for i0 in range(0, n_pad, row_chunk):
        i1 = min(i0 + row_chunk, n_pad)
        rows = codes[i0: min(i1, n)]
        if i1 > n:
            rows = torch.nn.functional.pad(rows, (0, 0, 0, i1 - max(i0, n)))
        w, f, nr, r = trb._convert_rows(params, rows, num_bits, seg, c_rot)
        w_chunks.append(w)
        f_chunks.append(f)
        n_chunks.append(nr)
        r_chunks.append(r)
    valid = torch.arange(n_pad, device=dev) < n
    min_r, _ = pr.tile_min_max(torch.cat(n_chunks), valid, 0.0, None)
    max_r = torch.where(valid, torch.cat(r_chunks), 0.0).reshape(-1, TILE).amax(dim=1)
    nrm_row = torch.ones((n_pad,), dtype=torch.float32, device=dev)
    if norms is None:
        min_n, max_n = torch.ones_like(min_r), torch.ones_like(max_r)
    else:
        nrm_row[:n] = norms.to(torch.float32)
        min_n, max_n = pr.tile_min_max(nrm_row, valid, 1.0, 1.0)
    stats = torch.stack([min_r, max_r, torch.zeros_like(max_r), min_n, max_n], dim=1)
    fac = torch.cat([torch.cat(f_chunks, dim=1), nrm_row[None]], dim=0).contiguous()
    return trb.PackedCorpus(words=(torch.cat(w_chunks),), factors=fac, num_rows=n,
                            tile_stats=stats.to(torch.float32), has_norms=norms is not None,
                            prune_hint=pr.prune_hint_from_stats(stats))


def assert_same_cache(a, b):
    assert len(a.words) == len(b.words) == 1
    assert a.words[0].dtype == b.words[0].dtype and torch.equal(a.words[0], b.words[0])
    assert torch.equal(a.factors, b.factors)
    assert torch.equal(a.tile_stats, b.tile_stats)
    assert a.perm is None and b.perm is None
    assert (a.num_rows, a.has_norms, a.prune_hint) == (b.num_rows, b.has_norms, b.prune_hint)


@pytest.mark.parametrize("bits", [2, 4])
def test_a_row_source_fit_is_the_references_chunked_fit(source, bits):
    rows, _ = source
    got = trb.fit(rows, RaBitQConfig(num_bits=bits, seed=3), device="cpu")
    want = rrb.fit(rows, {"num_bits": bits, "seed": 3}, "cpu")
    for name in ("centroid", "rotation", "levels"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_a_tensor_fit_keeps_torch_mean(source):
    rows, _ = source
    x = rows[0:N]
    got = trb.fit(x, RaBitQConfig(num_bits=4), device="cpu")
    assert torch.equal(got.centroid, torch.mean(x, dim=0))
    src = trb.fit(rows, RaBitQConfig(num_bits=4), device="cpu")
    assert torch.equal(got.rotation, src.rotation) and torch.equal(got.levels, src.levels)
    torch.testing.assert_close(got.centroid, src.centroid, rtol=0, atol=1e-6)


@pytest.mark.parametrize("chunk_rows", [0, 700, 1024, N - 1])
def test_chunked_mean_is_the_f64_mean_rounded_once(source, chunk_rows):
    rows, _ = source
    want = torch.mean(rows[0:N].to(torch.float64), dim=0).to(torch.float32)
    assert torch.equal(chunked_mean(rows, "cpu", chunk_rows), want)


@pytest.fixture(scope="module", params=[2, 4, 6])
def encoded(request, source):
    """Byte rows of each layout (words at B ≤ 4, the f32 value plane at
    B=6) on rows of varied norms, and those norms."""
    rows, _ = source
    x = rows[0:N] * (0.5 + torch.rand((N, 1), generator=torch.Generator().manual_seed(5)))
    bits = request.param
    params = trb.fit(x, RaBitQConfig(num_bits=bits), device="cpu")
    return bits, params, trb.encode(params, x, bits), torch.linalg.norm(x, dim=1)


@pytest.mark.parametrize("with_norms,row_chunk", [
    (False, 131072), (True, 131072), (True, 512), (False, 1536), (True, 2048)])
def test_in_place_prepare_packed_equals_the_concatenating_one(encoded, with_norms, row_chunk):
    bits, params, codes, norms = encoded
    kw = dict(norms=norms if with_norms else None, row_chunk=row_chunk)
    got = trb.prepare_packed(params, codes, bits, **kw)
    assert got.words[0].dtype == (torch.float32 if bits >= 5 else torch.int32)
    assert_same_cache(got, prepare_packed_concat(params, codes, bits, **kw))


@pytest.fixture(scope="module")
def index(source):
    rows, _ = source
    return FlatQuantizedIndex(RaBitQ(RaBitQConfig(num_bits=4), device="cpu"),
                              SearchConfig(metric=Metric.L2, use_bf16=True)).fit(
                                  rows, chunk_rows=700)


def test_the_index_holds_the_references_words_and_factors(source, index):
    rows, _ = source
    params = rrb.fit(rows, {"num_bits": 4, "seed": 0}, "cpu")
    x = rows[0:N]
    idx, nrm, t = rrb.encode(params, x)
    idx, fac = flat_rabitq.block_layout(params, idx, nrm, t, torch.linalg.norm(x, dim=1))
    pad = (-N) % TILE
    want = rsaq.pack_words(torch.nn.functional.pad(idx, (0, 0, 0, pad)), 4)
    cache = index.scan_cache
    assert torch.equal(cache.words[0], want)
    assert torch.equal(cache.factors[:, :N], fac)
    assert torch.equal(cache.factors[:, N:], torch.tensor([[0.0], [0.0], [1.0]]).expand(3, pad))


@pytest.mark.parametrize("k", [1, 10, 64])
def test_the_index_answers_the_references_estimator_top_k(source, index, k):
    """The plain twin scans in f32 on the CPU: the ids are the reference's
    top-k where its distances are apart by more than the scores' rounding,
    and each score is the reference's distance of that row."""
    rows, pool = source
    ids, scores = index.search_with_scores(pool, k)
    params = rrb.fit(rows, {"num_bits": 4, "seed": 0}, "cpu")
    idx, nrm, t = rrb.encode(params, rows[0:N])
    s_hat, alpha, _ = rrb.scale_shift(params, idx, nrm, t)
    dist = rrb.distances(params, pool, s_hat, alpha, nrm)
    ids_t = torch.as_tensor(ids.astype("int64"))
    d_ids = torch.gather(dist, 1, ids_t)
    torch.testing.assert_close(torch.as_tensor(scores), d_ids, rtol=0, atol=1e-4)
    kth = torch.topk(dist, k, dim=1, largest=False).values[:, -1]
    assert float((d_ids - kth[:, None]).max()) <= 1e-4
    nums = common._judge_block(dist, torch.arange(NQ), ids_t, torch.as_tensor(scores), kth)
    assert max(nums) <= 1e-4


def test_the_spans_of_the_centroid_and_the_pack(source):
    rows, _ = source
    trace.reset()
    FlatQuantizedIndex(RaBitQ(RaBitQConfig(num_bits=4), device="cpu")).fit(rows, chunk_rows=700)
    rec = trace.recent("build", 1)
    assert len(rec) == 1
    assert set(rec[0]) == {"build", "build.fit", "rabitq.centroid", "build.encode",
                           "build.norms", "build.pack", "rabitq.pack"}
    assert rec[0]["build.fit"] >= rec[0]["rabitq.centroid"] > 0
    assert rec[0]["build.pack"] >= rec[0]["rabitq.pack"] > 0
    trace.reset()
    trb.fit(rows[0:N], RaBitQConfig(num_bits=4), device="cpu")  # a tensor: no chunked pass
    assert trace.recent("rabitq.centroid", 1) == []
    trace.reset()

