"""The port's copy of ``tests/test_bigfit.py``'s contract: fitting on a
host corpus (numpy / np.memmap / array-like) never materializes it — only
row samples and bounded chunks are touched.  That is what lets a 53M-row
build stay streamed (``vq_tpu_torch/bench/scan53m.py``).

``VirtualRows`` (a copy of the JAX tests' class, with a record of the
largest request) makes rows on demand and raises from ``__array__``, so
any ``np.asarray(X)`` or ``torch.as_tensor(X)`` of the whole corpus fails
the test.  Widths are narrower than the JAX test's 1024 (256 for the
fits, 64 for the IVF builds) to keep the CPU run light; the contract does
not depend on the width.
"""

import numpy as np
import pytest
import torch

from vq_tpu_torch.bench.registry import build_quantizer
from vq_tpu_torch.core.config import IVFConfig, KMeansConfig

torch.set_num_threads(2)


class VirtualRows:
    """An n×d corpus that generates rows on demand and refuses full
    materialization; it records the rows served and the largest slice and
    row-list requests."""

    def __init__(self, n=10_000_000, d=256):
        self.shape = (n, d)
        self.dtype = np.float32
        self.rows_served = 0
        self.max_slice = 0
        self.max_take = 0

    def __len__(self):
        return self.shape[0]

    def _make(self, idx):
        idx = np.asarray(idx).reshape(-1)
        self.rows_served += len(idx)
        d = self.shape[1]
        # cheap deterministic pseudo-data with per-dim scale spread
        base = ((idx[:, None] * 2654435761 + np.arange(d)[None, :] * 97) % 1013)
        return (base.astype(np.float32) / 1013.0 - 0.5) * (
            1.0 + np.arange(d, dtype=np.float32) / d
        )

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self.shape[0])
            self.max_slice = max(self.max_slice, len(range(start, stop, step)))
            return self._make(np.arange(start, stop, step))
        if isinstance(key, np.ndarray):
            self.max_take = max(self.max_take, key.size)
            return self._make(key)
        raise TypeError(f"unsupported index {key!r}")

    def __array__(self, *a, **k):
        raise MemoryError("full materialization of a virtual corpus attempted")


def test_host_sample_rows_never_materializes():
    from vq_tpu_torch.data.sampling import host_sample_rows

    x = VirtualRows()
    s = host_sample_rows(x, 10_000, seed=1)
    assert isinstance(s, np.ndarray) and s.shape == (10_000, 256) and s.dtype == np.float32
    assert x.rows_served == 10_000


@pytest.mark.parametrize(
    "method,kw",
    [
        ("pq", {"M": 8, "B": 4}),
        ("saq", {"bpd": 1.0}),
        ("rankaware", {"bpd": 1.0}),
        ("opq", {"M": 8, "B": 4, "opq_iters": 1}),
    ],
)
def test_fit_on_10m_virtual_corpus(method, kw):
    """fit() completes on a 10M-row corpus touching only its sample."""
    x = VirtualRows()
    model = build_quantizer(method, 256, device="cpu", **kw)
    model.fit(x)
    assert x.rows_served <= 300_000  # ≤ sample cap (+slack), NOT 10M
    # encode a small batch end-to-end to prove the fit is usable
    batch = x[np.arange(256)]
    rec = model.decompress(model.compress(batch)).numpy()
    assert rec.shape == batch.shape
    assert np.mean((batch - rec) ** 2) < np.var(batch)


@pytest.mark.parametrize("index", ["IvfQuantizedIndex", "IvfPackedFlatIndex"])
def test_ivf_build_reads_samples_and_bounded_chunks(index):
    """The IVF builds on a 300k-row host corpus: the coarse pass and the
    quantizer fit read ≤ 200k-row samples, the streamed assignment
    (``index/ivf.py::chunked_assign``) and the encode in cluster order
    (``encode_rows_ordered``) read ``chunk_rows`` at a time, and every row
    is read a bounded number of times (samples, assignment, encode)."""
    from vq_tpu_torch.index import ivf, ivf_packed

    n, chunk = 300_000, 40_000
    x = VirtualRows(n=n, d=64)
    quant = build_quantizer("pq", 64, device="cpu", M=8, B=4, kmeans_iters=3) \
        if index == "IvfQuantizedIndex" else build_quantizer("saq", 64, device="cpu", bpd=2.0)
    cls = getattr(ivf if index == "IvfQuantizedIndex" else ivf_packed, index)
    idx = cls(quant, IVFConfig(num_clusters=16, nprobe=4, kmeans=KMeansConfig(iters=3)))
    idx.fit(x, chunk_rows=chunk)
    assert idx.num_rows == n
    assert x.max_slice <= chunk and x.max_take <= 200_000
    assert x.rows_served <= 2 * n + 2 * 200_000
    q = x[np.arange(0, n, n // 8)][:8]
    ids, scores = idx.search_with_scores(q, k=5)
    assert ids.shape == (8, 5) and np.isfinite(scores).all() and int(ids.max()) < n
