"""Search indexes of the port: flat, residual IVF and probed-tile IVF."""

from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.index.ivf import IvfQuantizedIndex
from vq_tpu_torch.index.ivf_packed import IvfPackedFlatIndex

__all__ = ["FlatQuantizedIndex", "IvfPackedFlatIndex", "IvfQuantizedIndex"]
