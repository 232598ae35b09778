"""The port hides neither the device nor the kernels.

* ``vq_tpu_torch`` never imports jax nor any module of the JAX package
  ``vq_tpu`` (checked in a fresh interpreter after driving the Flat,
  residual-IVF and IVF-packed searches with every quantizer).
* The card is the default: asking for ``cuda``, or for no device with host
  data, without a card raises; nothing falls back to the CPU.
* A quantizer built without a device takes a tensor corpus's device; a
  tensor on another device than the CPU is never copied to it (``meta``
  stands in for a card here).
* The kernel build raises when ``nvcc`` is missing.
* A CPU tensor runs the plain versions and leaves the launch counters at 0
  (the PQ kernels and the packed-code kernel of SAQ / RaBitQ, dense and
  gather).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vq_tpu_torch import IVFConfig, KMeansConfig, LVQConfig, Metric, OPQConfig, PQConfig
from vq_tpu_torch import RaBitQConfig, RankAwareConfig, SAQConfig, SQConfig
from vq_tpu_torch import _device
from vq_tpu_torch.index.ivf import IvfQuantizedIndex
from vq_tpu_torch.methods import LVQ, OPQ, SQ, RankAware
from vq_tpu_torch.kernels import _build
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.index.ivf_packed import IvfPackedFlatIndex
from vq_tpu_torch.kernels import packed_scan as pk
from vq_tpu_torch.kernels import pq_scan as ps
from vq_tpu_torch.kernels.adc import scan_codes_topk
from vq_tpu_torch.methods.pq import PQ
from vq_tpu_torch.methods.rabitq import RaBitQ
from vq_tpu_torch.methods.saq import SAQ

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

_NO_JAX = """
import sys
import numpy as np
from vq_tpu_torch import IVFConfig, KMeansConfig, PQConfig, RaBitQConfig, SAQConfig, convert
from vq_tpu_torch.core import packing
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.index.ivf_packed import IvfPackedFlatIndex
from vq_tpu_torch import LVQConfig, OPQConfig, RankAwareConfig, SQConfig
from vq_tpu_torch.core import ffd
from vq_tpu_torch.index.ivf import IvfQuantizedIndex
from vq_tpu_torch.kernels import caq, lloyd1d, packed_scan
from vq_tpu_torch.methods import LVQ, OPQ, SQ, RankAware
from vq_tpu_torch.methods.pq import PQ
from vq_tpu_torch.methods.rabitq import RaBitQ
from vq_tpu_torch.methods.saq import SAQ
x = np.random.default_rng(0).standard_normal((1200, 16)).astype(np.float32)
cpu = dict(device="cpu")
for q in (PQ(PQConfig(4, 4, KMeansConfig(iters=2)), **cpu), SAQ(SAQConfig(2.0, block_dims=8), **cpu),
          SAQ(SAQConfig(3.0, block_dims=8, codebook="exact"), **cpu),
          RaBitQ(RaBitQConfig(2), **cpu), OPQ(OPQConfig(4, 4, 2, KMeansConfig(iters=2)), **cpu),
          SQ(SQConfig(4), **cpu), LVQ(LVQConfig(4), **cpu),
          RankAware(RankAwareConfig(2.0, codebook="exact", packing="ffd"), **cpu)):
    ids = FlatQuantizedIndex(q).fit(x).search(x[:5], 3)
    assert ids.shape == (5, 3), ids.shape
for q in (SAQ(SAQConfig(2.0, block_dims=8), **cpu), RaBitQ(RaBitQConfig(2), **cpu),
          RankAware(RankAwareConfig(2.0), **cpu)):
    ivf = IvfPackedFlatIndex(q, IVFConfig(8, 2, KMeansConfig(iters=2))).fit(x)
    ids = ivf.search(x[:5], 3)
    assert ids.shape == (5, 3) and 0 < ivf.last_tiles_scanned <= 3, ids.shape
for q in (PQ(PQConfig(4, 4, KMeansConfig(iters=2)), **cpu), RankAware(RankAwareConfig(2.0), **cpu)):
    ivf = IvfQuantizedIndex(q, IVFConfig(8, 2, KMeansConfig(iters=2))).fit(x)
    for strategy in ("union", "windows"):
        ids, _ = ivf.search_with_scores(x[:5], 3, strategy=strategy)
        assert ids.shape == (5, 3), ids.shape
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "vq_tpu"))
assert not loaded, loaded
print("ok")
"""


def test_port_never_imports_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        _device.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        PQ(PQConfig(4, 4), device="cuda")


def test_quantizer_takes_the_device_of_its_corpus():
    x = np.random.default_rng(0).standard_normal((600, 16)).astype(np.float32)
    cfg = PQConfig(4, 4, KMeansConfig(iters=2))
    for pq, data in ((PQ(cfg), torch.from_numpy(x)), (PQ(cfg, device="cpu"), x)):
        assert pq.fit(data).device == torch.device("cpu")
        assert pq.params.codebooks.device.type == "cpu"


def test_host_corpus_without_a_device_goes_to_the_card(monkeypatch):
    """No ``device=`` and a numpy corpus: the card, so without one every
    entry point raises rather than land on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).standard_normal((1100, 16)).astype(np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        _device.resolve_device(None)
    for q in (PQ(PQConfig(4, 4, KMeansConfig(iters=2))), SAQ(SAQConfig(2.0, block_dims=8)),
              RaBitQ(RaBitQConfig(2)), OPQ(OPQConfig(4, 4, 2, KMeansConfig(iters=2))),
              SQ(SQConfig(8)), LVQ(LVQConfig(8)), RankAware(RankAwareConfig(2.0))):
        assert q.device is None
        with pytest.raises(RuntimeError, match="cuda"):
            q.fit(x)
        with pytest.raises(RuntimeError, match="cuda"):
            FlatQuantizedIndex(type(q)(q.cfg)).fit(x)
    for index in (IvfPackedFlatIndex, IvfQuantizedIndex):
        with pytest.raises(RuntimeError, match="cuda"):
            index(SAQ(SAQConfig(2.0, block_dims=8)), IVFConfig(4, 1, KMeansConfig(iters=2))).fit(x)
    with pytest.raises(RuntimeError, match="cuda"):
        IvfPackedFlatIndex(RankAware(RankAwareConfig(2.0)),
                           IVFConfig(4, 1, KMeansConfig(iters=2))).fit(x)


def test_device_tensors_never_leave_their_device():
    t = torch.zeros((600, 16), device="meta")
    with pytest.raises(ValueError, match="given to code on cpu"):
        _device.as_f32(t, "cpu")
    with pytest.raises(ValueError, match="given to code on cpu"):
        PQ(PQConfig(4, 4, KMeansConfig(iters=2)), device="cpu").fit(t)
    assert _device.as_f32(np.zeros((2, 2)), "meta").device.type == "meta"  # host data moves


def test_bf16_only_on_cuda():
    assert not _device.bf16_supported("cpu")
    assert _device.bf16_supported("cuda")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library()
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
    _build.load_library.cache_clear()


def test_cpu_tensors_run_plain_versions_without_launches():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((6, 32)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 256, (700, 4)).astype(np.uint8))
    cb = torch.from_numpy(rng.standard_normal((4, 256, 8)).astype(np.float32))
    ps.reset_launch_counts()
    s = ps.pq_score_all(q, codes, cb)
    torch.testing.assert_close(s, ps.pq_score_all_plain(q, codes, cb), rtol=0, atol=0)
    ts, ti = ps.pq_scan_topk_fused(q, codes, cb, 10, limit=600)
    ws, wi = ps.pq_scan_topk_fused_plain(q, codes, cb, 10, limit=600)
    assert torch.equal(ti, wi) and torch.equal(ts, ws)
    for k in (10, 200):  # both routes of scan_codes_topk (k ≤ 128 and k > 128)
        scan_codes_topk(q, codes, cb, k, Metric.L2)
    assert ps.pq_score_all.launches == 0 and ps.pq_scan_topk_fused.launches == 0


def test_wrappers_refuse_other_devices():
    t = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ps.pq_score_all(t, t.to(torch.uint8), t.reshape(4, 1, 4))


def test_cpu_tensors_leave_the_packed_counter_at_zero():
    x = np.random.default_rng(1).standard_normal((700, 16)).astype(np.float32)
    pk.reset_launch_counts()
    for q in (SAQ(SAQConfig(2.0, block_dims=8), device="cpu"),
              RaBitQ(RaBitQConfig(2), device="cpu"), RankAware(RankAwareConfig(2.0), device="cpu")):
        index = FlatQuantizedIndex(q).fit(x)
        for k in (10, 100):
            index.search(x[:4], k)
        cache = q.prepare_scan(index.codes, norms=index.norms)
        q.packed_scan_raw(torch.from_numpy(x[:4]), cache, 5, Metric.L2)
        ivf = IvfPackedFlatIndex(q, IVFConfig(4, 1, KMeansConfig(iters=2))).fit(x)
        ivf.search(x[:4], 5)
    assert pk.packed_scan_topk.launches == 0 and pk.packed_scan_topk.gather_launches == 0


def test_packed_wrapper_refuses_other_devices():
    t = torch.zeros((512, 4), device="meta")
    seg = pk.make_segspec(2, 4, "uniform", -1)
    with pytest.raises(ValueError, match="unsupported device"):
        pk.packed_scan_topk(t[:2], t[:2, 0], (t[:32].to(torch.int32),), t.T, (), (seg,), 5,
                            metric_kind="ip")


def test_base_quantizer_has_no_packed_scan():
    with pytest.raises(NotImplementedError, match="packed"):
        PQ(PQConfig(4, 4)).packed_scan_raw(None, None, 5, Metric.L2)
