"""The port's public API against the JAX package's: the scan functions'
parameter lists (so a positional call binds the same way in both), the
package re-exports, ``BaseQuantizer.save_codebooks``, and an import of
``vq_tpu_torch.kernels`` that loads no CUDA library and no Triton."""

import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import vq_tpu.core as jcore
import vq_tpu.kernels as jkernels
from vq_tpu.kernels import adc as jadc
from vq_tpu.methods import base as jbase
from vq_tpu.methods import lvq as jlvq
from vq_tpu.methods import opq as jopq
from vq_tpu.methods import pq as jpq
from vq_tpu.methods import rabitq as jrabitq
from vq_tpu.methods import rankaware as jrankaware
from vq_tpu.methods import saq as jsaq
from vq_tpu.methods import sq as jsq
import vq_tpu_torch.core as tcore
import vq_tpu_torch.kernels as tkernels
from vq_tpu_torch.core.config import PQConfig, SQConfig
from vq_tpu_torch.kernels import adc as tadc
from vq_tpu_torch.methods import base as tbase
from vq_tpu_torch.methods import lvq as tlvq
from vq_tpu_torch.methods import opq as topq
from vq_tpu_torch.methods import pq as tpq
from vq_tpu_torch.methods import rabitq as trabitq
from vq_tpu_torch.methods import rankaware as trankaware
from vq_tpu_torch.methods import saq as tsaq
from vq_tpu_torch.methods import sq as tsq

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# Pallas interpret mode has no counterpart: a CPU tensor runs a kernel's
# plain twin in the port
TPU_ONLY = {"interpret"}


def _params(fn):
    return [p for p in inspect.signature(fn).parameters if p not in TPU_ONLY]


@pytest.mark.parametrize("jax_fn,port_fn", [
    (jbase.BaseQuantizer.scan_topk, tbase.BaseQuantizer.scan_topk),
    (jpq.PQ.scan_topk, tpq.PQ.scan_topk),
    (jopq.OPQ.scan_topk, topq.OPQ.scan_topk),
    (jsq.SQ.scan_topk, tsq.SQ.scan_topk),
    (jlvq.LVQ.scan_topk, tlvq.LVQ.scan_topk),
    (jrabitq.RaBitQ.scan_topk, trabitq.RaBitQ.scan_topk),
    (jrankaware.RankAware.scan_topk, trankaware.RankAware.scan_topk),
    (jsaq.SAQ.scan_topk, tsaq.SAQ.scan_topk),
    (jrabitq.scan_topk, trabitq.scan_topk),
    (jsaq.scan_topk, tsaq.scan_topk),
    (jadc.scan_codes_topk, tadc.scan_codes_topk),
    (jadc.scan_generic_topk, tadc.scan_generic_topk),
    (jadc._streaming_topk, tadc._streaming_topk),
], ids=lambda f: f.__qualname__ if hasattr(f, "__qualname__") else str(f))
def test_scan_parameters_are_the_jax_packages_in_its_order(jax_fn, port_fn):
    """Each quantizer's ``scan_topk`` and the plain-route scan functions
    take JAX's parameters, ``approx`` included, in JAX's order; every
    default agrees."""
    assert _params(port_fn) == _params(jax_fn)
    want = inspect.signature(jax_fn).parameters
    for name, p in inspect.signature(port_fn).parameters.items():
        assert p.default == want[name].default, name


def test_approx_defaults_off_and_sits_before_cache():
    """``cache`` is no longer bound by the 8th positional argument."""
    for cls in (tbase.BaseQuantizer, tpq.PQ, topq.OPQ, trabitq.RaBitQ, trankaware.RankAware):
        names = _params(cls.scan_topk)
        assert names[8:10] == ["approx", "cache"], (cls, names)
        assert inspect.signature(cls.scan_topk).parameters["approx"].default is False


def test_package_reexports_are_the_jax_packages():
    assert tkernels.__all__ == jkernels.__all__
    assert tcore.__all__ == jcore.__all__
    for name in tkernels.__all__:
        assert callable(getattr(tkernels, name)), name
        assert getattr(tkernels, name).__module__.startswith("vq_tpu_torch.kernels.")
    for name in tcore.__all__:
        assert getattr(tcore, name).__name__ == getattr(jcore, name).__name__
    assert tcore.Metric.NIP.value == jcore.Metric.NIP.value


def test_reexported_functions_compute_on_cpu_tensors():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((300, 8), generator=g)
    q = x[:4] + 0.01
    _, ids = tkernels.exact_topk(q, x, 3)
    assert ids[:, 0].tolist() == [0, 1, 2, 3]
    cents = tkernels.kmeans(torch.Generator().manual_seed(1), x, 5)
    assert cents.shape == (5, 8)
    assert tkernels.assign(x, cents).shape == (300,)
    d = tkernels.pairwise_sqdist(q, x)
    assert d.shape == (4, 300) and torch.allclose(d[0, 0], torch.tensor(0.0008), atol=1e-5)


@pytest.mark.parametrize("make", [
    lambda: tpq.PQ(PQConfig(num_subquantizers=4, num_bits=4), device="cpu"),
    lambda: tsq.SQ(SQConfig(num_bits=8), device="cpu"),
    lambda: tsaq.SAQ(device="cpu"),
], ids=["pq", "sq", "saq"])
def test_save_codebooks_saves_what_load_reads(make, tmp_path):
    """The default export hook is ``save``: ``load`` of its file restores a
    quantizer that decodes the same codes alike."""
    x = np.random.default_rng(3).standard_normal((600, 16)).astype(np.float32)
    q = make().fit(torch.from_numpy(x))
    path = str(tmp_path / "cb.pkl")
    q.save_codebooks(path)
    back = make().load(path)
    codes = q.compress(torch.from_numpy(x[:40]))
    np.testing.assert_array_equal(back.decompress(codes).numpy(), q.decompress(codes).numpy())


_IMPORT_ONLY = """
import sys
import vq_tpu_torch.kernels, vq_tpu_torch.core
from vq_tpu_torch.kernels import _build, packed_scan, pq_scan  # noqa: F401
assert "triton" not in sys.modules, "triton"
assert _build.load_library.cache_info().currsize == 0, "a CUDA library was loaded"
print("ok")
"""


def test_importing_kernels_loads_no_cuda_library_and_no_triton():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ONLY], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"
