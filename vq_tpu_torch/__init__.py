"""vq_tpu_torch — the PyTorch + CUDA port of vq_tpu for one NVIDIA H100.

The JAX package ``vq_tpu`` is the reference; every module here mirrors its
counterpart's path and public functions so the two are easy to compare:

    kernels/adc.py      ← vq_tpu/kernels/adc.py       ADC scan, exact top-k
    kernels/pq_scan.py  ← vq_tpu/kernels/pallas_scan.py  hand-written CUDA
                          PQ scan kernels (csrc/pq_scan.cu) + plain twins
    kernels/packed_scan.py ← vq_tpu/kernels/pallas_packed.py  hand-written
                          CUDA packed-code scan (csrc/packed_scan.cu) + plain twin
    kernels/kmeans.py   ← vq_tpu/kernels/kmeans.py    batched Lloyd k-means
    kernels/caq.py, kernels/lloyd1d.py, core/packing.py ← the same paths
    data/sampling.py    ← vq_tpu/data/sampling.py
    methods/pq.py, methods/saq.py, methods/rabitq.py ← the same paths
    index/flat.py       ← vq_tpu/index/flat.py
    convert.py          JAX-package state (as numpy) → port state

The port imports torch and never jax.  Framework-neutral pieces of the old
package (``vq_tpu.core.config``, ``vq_tpu.metrics``) are imported, not copied;
the configs the port's API takes are re-exported here, so a caller needs no
import from ``vq_tpu``.
"""

from vq_tpu.core.config import (
    KMeansConfig,
    Metric,
    PQConfig,
    RaBitQConfig,
    SAQConfig,
    SearchConfig,
)
from vq_tpu_torch._device import bf16_supported, resolve_device

__version__ = "0.1.0"

__all__ = ["KMeansConfig", "Metric", "PQConfig", "RaBitQConfig", "SAQConfig", "SearchConfig",
           "bf16_supported", "resolve_device"]
