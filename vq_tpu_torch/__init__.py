"""vq_tpu_torch — the PyTorch + CUDA port of vq_tpu for one NVIDIA H100.

The JAX package ``vq_tpu`` is the reference; every module here mirrors its
counterpart's path and public functions so the two are easy to compare:

    kernels/adc.py      ← vq_tpu/kernels/adc.py       ADC scan, exact top-k
    kernels/pq_scan.py  ← vq_tpu/kernels/pallas_scan.py  hand-written CUDA
                          PQ scan kernels (csrc/pq_scan.cu) + plain twins
    kernels/packed_scan.py ← vq_tpu/kernels/pallas_packed.py  hand-written
                          CUDA packed-code scan, dense and tile-gather modes
                          (csrc/packed_scan.cu) + plain twin
    kernels/kmeans.py   ← vq_tpu/kernels/kmeans.py    batched Lloyd k-means
    kernels/caq.py, kernels/lloyd1d.py, core/packing.py ← the same paths
    core/config.py      ← vq_tpu/core/config.py       the configs (a copy)
    native/             ← vq_tpu/native               host allocators (a copy)
    data/sampling.py    ← vq_tpu/data/sampling.py
    core/ffd.py         ← vq_tpu/core/ffd.py          FFD and dense bit packing
    methods/pq.py, methods/saq.py, methods/rabitq.py, methods/opq.py,
    methods/sq.py, methods/lvq.py, methods/rankaware.py ← the same paths
    index/flat.py       ← vq_tpu/index/flat.py
    index/ivf.py        ← vq_tpu/index/ivf.py         residual IVF index
    index/ivf_packed.py ← vq_tpu/index/ivf_packed.py  probed-tile IVF index
    dist/               ← vq_tpu/dist                 sharded serving over a
                          single-process mesh of (possibly repeated) devices
    metrics/, data/{io,datasets,hf_loaders}.py, utils/, viz/, bench/,
    cli.py, __main__.py ← the same paths             the harness and
                          ``python -m vq_tpu_torch`` (``--device``)
    convert.py          JAX-package state (as numpy) → port state

The port imports torch and never jax, nor anything of the JAX package: what
it needs of a framework-neutral module there (the configs, the native
allocators, the numpy metrics and IO) it keeps as its own copy.  Entry
points run on the card
(``cuda``) unless the caller asks for the CPU (``device="cpu"`` or CPU
tensors).
"""

from vq_tpu_torch._device import bf16_supported, resolve_device
from vq_tpu_torch.core.config import (
    IVFConfig,
    KMeansConfig,
    LVQConfig,
    Metric,
    OPQConfig,
    PQConfig,
    RaBitQConfig,
    RankAwareConfig,
    SAQConfig,
    SearchConfig,
    SQConfig,
)
from vq_tpu_torch.dist import (
    ShardedFlatIndex,
    ShardedFlatPQIndex,
    ShardedIVFIndex,
    ShardedIvfPackedIndex,
    ShardedPackedFlatIndex,
    make_mesh,
)

__version__ = "0.1.0"

__all__ = ["IVFConfig", "KMeansConfig", "LVQConfig", "Metric", "OPQConfig", "PQConfig",
           "RaBitQConfig", "RankAwareConfig", "SAQConfig", "SearchConfig", "SQConfig",
           "ShardedFlatIndex", "ShardedFlatPQIndex", "ShardedIVFIndex",
           "ShardedIvfPackedIndex", "ShardedPackedFlatIndex", "bf16_supported",
           "make_mesh", "resolve_device"]
