"""The port hides neither the device nor the kernels.

* ``vq_tpu_torch`` never imports jax nor any module of the JAX package
  ``vq_tpu`` (checked in a fresh interpreter after driving the Flat,
  residual-IVF and IVF-packed searches with every quantizer, the sharded
  indexes on a mesh of CPU shards, and the harness's CLI: sweep, ivf-bench
  and study).
* The card is the default: asking for ``cuda``, or for no device with host
  data, without a card raises; nothing falls back to the CPU (the exact
  scan and ground truth of numpy data included).
* The IVF benchmark keeps a failing runner's error in its row and CSV.
* A quantizer built without a device takes a tensor corpus's device; a
  tensor on another device than the CPU is never copied to it (``meta``
  stands in for a card here).
* The kernel build raises when ``nvcc`` is missing.
* A CPU tensor runs the plain versions and leaves the launch counters at 0
  (the PQ kernels and the packed-code kernel of SAQ / RaBitQ, dense and
  gather; the sharded indexes on a mesh of CPU shards).
* Every kernel wrapper enters its tensors' device before it touches the
  library, so its attribute, occupancy and launch calls go to that card
  (``torch.cuda.device`` and the library are stood in for here).
* A mesh is of the card by default (``make_mesh()`` without one raises),
  and a quantizer with no packed shard or tile cache is refused by the
  sharded packed indexes, never served by the generic scan instead.
"""

import os
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
from vq_tpu_torch.dist import (ShardedFlatIndex, ShardedFlatPQIndex, ShardedIVFIndex,
                               ShardedIvfPackedIndex, ShardedPackedFlatIndex, dp_lloyd_step,
                               make_mesh)
mesh = make_mesh(devices=["cpu"] * 3)
for index in (ShardedFlatPQIndex(PQ(PQConfig(4, 4, KMeansConfig(iters=2)), **cpu), mesh=mesh),
              ShardedFlatIndex(SQ(SQConfig(4), **cpu), mesh=mesh),
              ShardedPackedFlatIndex(SAQ(SAQConfig(2.0, block_dims=8), **cpu), mesh=mesh),
              ShardedIVFIndex(RankAware(RankAwareConfig(2.0), **cpu),
                              IVFConfig(8, 2, KMeansConfig(iters=2)), mesh=mesh),
              ShardedIvfPackedIndex(RaBitQ(RaBitQConfig(2), **cpu),
                                    IVFConfig(8, 2, KMeansConfig(iters=2)), mesh=mesh)):
    ids = index.fit(x).search(x[:5], 3)
    assert ids.shape == (5, 3), ids.shape
assert dp_lloyd_step(mesh, x, x[:8]).shape == (8, 16)
import contextlib, io, os, tempfile
from vq_tpu_torch.cli import main
from vq_tpu_torch.data.io import write_fvecs
from vq_tpu_torch.utils import export, profiling
from vq_tpu_torch.viz import plot
tmp = tempfile.mkdtemp()
write_fvecs(os.path.join(tmp, "b.fvecs"), x)
for argv in (["sweep", "--dataset", "dummy-600x16", "--methods", "pq", "saq", "--pq-subquantizers",
              "4", "--pq-bits", "4", "--bpd", "2", "--num-queries", "5"],
             ["ivf-bench", "--dataset", "dummy-600x16", "--methods", "saq_ivf_packed", "--bpd", "2",
              "--num-clusters", "4", "--nprobe", "2", "--output", os.path.join(tmp, "i.csv")],
             ["study", "--base", os.path.join(tmp, "b.fvecs"), "--queries",
              os.path.join(tmp, "b.fvecs"), "--methods", "ours", "--bpd", "2",
              "--output-dir", tmp]):
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(argv + ["--device", "cpu", "--db-path", os.path.join(tmp, "r.db")]
                    if argv[0] == "sweep" else argv + ["--device", "cpu"]) == 0
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


def test_kernel_wrappers_enter_their_tensors_device_before_the_library(monkeypatch):
    """The CUDA runtime launches on the current device: both PQ kernels and
    the packed kernel (dense and gather) enter their tensors' device, here
    ``cuda:1`` (namespaces stand in for its tensors), before they ask for
    the library."""
    from types import SimpleNamespace

    stack, seen = [], []

    class Guard:  # stands in for torch.cuda.device
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            stack.append(self.dev)

        def __exit__(self, *exc):
            stack.pop()

    class Reached(Exception):
        pass

    def library():
        seen.append(list(stack))
        raise Reached

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(_build, "load_library", library)
    monkeypatch.setattr(ps, "_check_inputs", lambda *a, **k: None)
    monkeypatch.setattr(pk, "_check_inputs", lambda *a, **k: None)
    card1 = torch.device("cuda", 1)
    t = SimpleNamespace(device=card1, shape=(4, 256, 8))
    for call in (lambda: ps.pq_scan_topk_fused(t, t, t, 10),
                 lambda: ps.pq_score_all(t, t, t),
                 lambda: pk.packed_scan_topk(t, t, (), t, (), (), 10),
                 lambda: pk.packed_scan_topk(t, t, (), t, (), (), 10, tile_mask=t)):
        with pytest.raises(Reached):
            call()
    assert seen == [[card1]] * 4 and not stack


def test_base_quantizer_has_no_packed_scan():
    with pytest.raises(NotImplementedError, match="packed"):
        PQ(PQConfig(4, 4)).packed_scan_raw(None, None, 5, Metric.L2)


def test_mesh_without_a_card_raises(monkeypatch):
    from vq_tpu_torch.dist import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"n_devices": 1}, {"devices": ["cuda"] * 2}):
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(**kw)
    assert make_mesh(devices=["cpu"] * 2).root == torch.device("cpu")


def test_sharded_packed_indexes_refuse_a_quantizer_without_a_packed_cache():
    """PQ and SQ have no packed layout: the sharded packed indexes raise
    (the JAX package's RuntimeError), nothing drops to the generic scan."""
    from vq_tpu_torch.dist import ShardedIvfPackedIndex, ShardedPackedFlatIndex, make_mesh

    x = np.random.default_rng(2).standard_normal((1100, 16)).astype(np.float32)
    mesh = make_mesh(devices=["cpu"] * 2)
    for q in (PQ(PQConfig(4, 4, KMeansConfig(iters=2)), device="cpu"),
              SQ(SQConfig(8), device="cpu")):
        with pytest.raises(RuntimeError, match="no packed shard cache"):
            ShardedPackedFlatIndex(q, mesh=mesh).fit(x)
        with pytest.raises(RuntimeError, match="no packed tile cache"):
            ShardedIvfPackedIndex(q, IVFConfig(4, 1, KMeansConfig(iters=2)), mesh=mesh).fit(x)


def test_sharded_indexes_on_cpu_shards_launch_no_kernel():
    from vq_tpu_torch import SearchConfig
    from vq_tpu_torch.dist import (ShardedFlatPQIndex, ShardedIvfPackedIndex,
                                   ShardedPackedFlatIndex, make_mesh)

    x = np.random.default_rng(3).standard_normal((2100, 16)).astype(np.float32)
    mesh = make_mesh(devices=["cpu"] * 4)
    ps.reset_launch_counts()
    pk.reset_launch_counts()
    ShardedFlatPQIndex(PQ(PQConfig(4, 4, KMeansConfig(iters=2)), device="cpu"),
                       mesh=mesh).fit(x).search(x[:4], 10)
    for q in (SAQ(SAQConfig(2.0, block_dims=8), device="cpu"), RaBitQ(RaBitQConfig(2),
                                                                      device="cpu")):
        ShardedPackedFlatIndex(q, SearchConfig(), mesh).fit(x).search(x[:4], 10)
        ShardedIvfPackedIndex(q, IVFConfig(4, 1, KMeansConfig(iters=2)),
                              mesh=mesh).fit(x).search(x[:4], 5)
    assert ps.pq_scan_topk_fused.launches == ps.pq_score_all.launches == 0
    assert pk.packed_scan_topk.launches == pk.packed_scan_topk.gather_launches == 0


def test_exact_scan_of_host_data_goes_to_the_card(monkeypatch):
    """numpy corpora (ground truth, ``precompute-gt``) go to the card: without
    one the exact scan raises rather than run on the CPU; a CPU tensor, or
    ``device="cpu"``, asks for the CPU."""
    from vq_tpu_torch.data import datasets
    from vq_tpu_torch.kernels.adc import exact_topk

    x = np.random.default_rng(4).standard_normal((300, 8)).astype(np.float32)
    want = exact_topk(torch.from_numpy(x[:3]), torch.from_numpy(x), 5)[1]
    assert torch.equal(want[:, 0], torch.arange(3, dtype=want.dtype))
    np.testing.assert_array_equal(
        datasets.compute_ground_truth(x, x[:3], k=5, device="cpu"), want.numpy())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: exact_topk(x[:3], x, 5),
                 lambda: exact_topk(torch.from_numpy(x[:3]), x, 5),
                 lambda: datasets.compute_ground_truth(x, x[:3], k=5),
                 lambda: datasets.Dataset("d", x, x[:3]),
                 lambda: datasets.get_dataset("dummy-300x8"),
                 lambda: datasets.load_planted_dataset(300, 8, 3)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_ivf_benchmark_writes_a_failing_runners_error(tmp_path, monkeypatch):
    """A runner that raises leaves its error in its row and in the CSV (the
    reference's per-method isolation); the other rows still run."""
    import csv

    from vq_tpu_torch.bench import ivf_bench
    from vq_tpu_torch.data.datasets import load_dummy_dataset

    real = ivf_bench._build_index

    def build(method, *args):
        if method == "sq_flat":
            raise RuntimeError("kernel launch failed")
        return real(method, *args)

    monkeypatch.setattr(ivf_bench, "_build_index", build)
    data = load_dummy_dataset(num_vectors=500, dim=8, num_queries=5, device="cpu")
    rows = ivf_bench.ivf_benchmark(data=data, methods=["sq_flat", "pq_flat"], k=5, bpd=[2.0],
                                   num_clusters=4, nprobe=2, output=str(tmp_path / "i.csv"),
                                   device="cpu")
    assert [r["error"] for r in rows] == ["RuntimeError: kernel launch failed", ""]
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name, newline="") as f:
        written = list(csv.DictReader(f))
    assert [r["error"] for r in written] == [r["error"] for r in rows]
    assert written[0]["recall@5"] == "" and float(written[1]["recall@5"]) > 0
