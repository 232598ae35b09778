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

from vq_tpu_torch import KMeansConfig, Metric, PQConfig
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.kernels import pq_scan as ps
from vq_tpu_torch.kernels.adc import scan_codes_topk
from vq_tpu_torch.methods.pq import PQ

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
# run (reading it from global memory), nothing falls back to plain code
@pytest.mark.parametrize("m,dsub", [(8, 8), (256, 2)])
@pytest.mark.parametrize("k,fused,score", [(10, 1, 0), (100, 0, 1)])
def test_scan_codes_topk_routes_through_kernels(dev, m, dsub, k, fused, score):
    q, codes, cb = _inputs(dev, m=m, dsub=dsub)
    ps.reset_launch_counts()
    _, ids = scan_codes_topk(q, codes, cb, k, Metric.L2, use_bf16=False)
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
