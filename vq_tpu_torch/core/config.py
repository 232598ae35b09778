"""The port's dataclass configs — a copy of ``vq_tpu/core/config.py``.

Same class names, field names, defaults and ``Metric`` values as the JAX
package's, so a config prints, compares and pickles the same way on both
sides; the port never imports that module.  ``convert.config_from_jax``
turns a JAX config object into the port's of the same class name.  The
classes are frozen (hashable), so a config can key a cache of built
objects.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass


class Metric(str, enum.Enum):
    """Distance conventions used across the port.

    L2  — squared euclidean.
    IP  — inner product (maximise).
    NIP — normalized inner product q·x̂/‖x‖; needs original row norms.

    A ``str`` enum: ``Metric("l2")`` builds it from the value, and it
    compares equal to the JAX package's member of the same value.
    """

    L2 = "l2"
    IP = "ip"
    NIP = "nip"


@dataclass(frozen=True)
class KMeansConfig:
    """Batched Lloyd k-means (kernels/kmeans.py)."""

    iters: int = 20
    seed: int = 0
    # Cap on training points per centroid, faiss-style subsampling.
    max_points_per_centroid: int = 256
    # "auto" = k-means++ for k ≤ 1024, random-row init beyond (the ++
    # seeding reads the training set once per centroid).
    init: str = "auto"  # "auto" | "kmeanspp" | "random"


@dataclass(frozen=True)
class PQConfig:
    """Product quantization: M subquantizers × B bits each."""

    num_subquantizers: int = 8  # M
    num_bits: int = 8  # B, codebook size K = 2**B
    kmeans: KMeansConfig = KMeansConfig()

    @property
    def codebook_size(self) -> int:
        return 1 << self.num_bits


@dataclass(frozen=True)
class OPQConfig:
    """Optimized PQ: learned rotation + PQ."""

    num_subquantizers: int = 8
    num_bits: int = 8
    opq_iters: int = 10
    kmeans: KMeansConfig = KMeansConfig()

    @property
    def codebook_size(self) -> int:
        return 1 << self.num_bits

    @property
    def pq(self) -> PQConfig:
        return PQConfig(self.num_subquantizers, self.num_bits, self.kmeans)


@dataclass(frozen=True)
class SQConfig:
    """Per-dimension uniform scalar quantization at 4/8/16 bits."""

    num_bits: int = 8  # one of 4, 8, 16


@dataclass(frozen=True)
class RaBitQConfig:
    """RaBitQ / Extended RaBitQ: num_bits=1 is the sign-binarized RaBitQ,
    num_bits>1 the Extended variant (shared N(0,1) Lloyd codebook and a
    per-vector rescale factor)."""

    num_bits: int = 1
    seed: int = 0


@dataclass(frozen=True)
class SAQConfig:
    """SAQ: variance-aware segmented CAQ quantization (bit budget D ·
    bits_per_dim allocated over dimension blocks, then each segment rotated
    and CAQ-encoded)."""

    bits_per_dim: float = 4.0
    allocator: str = "greedy"  # "greedy" | "dp" | "uniform"
    block_dims: int = 64  # allocation granularity
    max_bits: int = 8  # per-dim bit cap (keeps uint8 codes)
    caq_rounds: int = 6  # code-adjustment round limit
    use_pca: bool = True
    # Base grid per segment dim: "uniform" = the CAQ mid-rise grid, "lloyd"
    # = data-fit per-dim Lloyd levels, "exact" = optimal 1-D k-means levels
    # (the native DP of vq_tpu_torch/native).
    codebook: str = "uniform"
    seed: int = 0


@dataclass(frozen=True)
class LVQConfig:
    """Locally-adaptive VQ: global mean, per-vector lo/delta."""

    num_bits: int = 8


@dataclass(frozen=True)
class RankAwareConfig:
    """PCA rotation + var^(1+alpha)-weighted greedy per-dim bit allocation +
    per-dim codebooks."""

    bits_per_dim: float = 4.0
    alpha: float = 0.5
    max_bits: int = 8
    codebook: str = "lloyd"  # "gaussian" | "lloyd" | "exact"
    packing: str = "dense"  # "dense" (cross-byte bit stream) | "ffd" (byte-aligned)
    seed: int = 0


@dataclass(frozen=True)
class IVFConfig:
    """IVF coarse quantizer over K cells, nprobe probing."""

    num_clusters: int = 256  # K / nlist
    nprobe: int = 16
    kmeans: KMeansConfig = KMeansConfig()


@dataclass(frozen=True)
class SearchConfig:
    """Runtime knobs for the distance scan."""

    metric: Metric = Metric.L2
    k: int = 10
    # Rows per tile of the plain streaming scans.
    tile_rows: int = 16384
    # bf16 scoring with f32 accumulation (on a card; the CPU computes in
    # f32); False for full-f32 scoring.
    use_bf16: bool = True
    # Approximate per-tile top-k: not ported (indexes refuse True).
    approx: bool = False
    # The JAX package's expected query-batch size for its prepare_scan (a
    # TPU VMEM gate); kept for parity: the card's kernels take any batch,
    # and nothing of the port reads it.
    prepare_queries: int = 8


def asdict(cfg) -> dict:
    """JSON-serializable view of any config."""
    d = dataclasses.asdict(cfg)

    def _clean(v):
        if isinstance(v, dict):
            return {k: _clean(x) for k, x in v.items()}
        if isinstance(v, enum.Enum):
            return v.value
        return v

    return _clean(d)
