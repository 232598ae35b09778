"""Quantization methods of the port: PQ, OPQ, SQ, LVQ, SAQ, RaBitQ and
RankAware."""

from vq_tpu_torch.methods.lvq import LVQ
from vq_tpu_torch.methods.opq import OPQ
from vq_tpu_torch.methods.pq import PQ
from vq_tpu_torch.methods.rabitq import RaBitQ
from vq_tpu_torch.methods.rankaware import RankAware
from vq_tpu_torch.methods.saq import SAQ
from vq_tpu_torch.methods.sq import SQ

__all__ = ["LVQ", "OPQ", "PQ", "RaBitQ", "RankAware", "SAQ", "SQ"]
