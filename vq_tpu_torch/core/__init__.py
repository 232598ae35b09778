"""Framework-level pieces of the port (configs, bit packing, FFD layouts).
The re-exports are the JAX package's (``vq_tpu/core/__init__.py``)."""

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

__all__ = [
    "PQConfig",
    "OPQConfig",
    "SQConfig",
    "RaBitQConfig",
    "SAQConfig",
    "LVQConfig",
    "RankAwareConfig",
    "KMeansConfig",
    "IVFConfig",
    "SearchConfig",
    "Metric",
]
