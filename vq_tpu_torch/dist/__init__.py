"""Sharded serving over a device mesh of one process or of a
``torch.distributed`` group (``maybe_init_distributed``) — counterpart of
``vq_tpu/dist`` (``mesh.py``, ``sharded.py`` and the four sharded index
modules; ``dryrun.py`` is ``__graft_entry__.dryrun_multichip``'s)."""

from vq_tpu_torch.dist.mesh import (
    Mesh,
    make_mesh,
    maybe_init_distributed,
    replicate,
    shard_rows,
)
from vq_tpu_torch.dist.sharded import (
    dp_lloyd_step,
    sharded_exact_topk,
    sharded_generic_scan_topk,
    sharded_scan_topk,
)
from vq_tpu_torch.dist.sharded_index import ShardedFlatIndex, ShardedFlatPQIndex
from vq_tpu_torch.dist.sharded_ivf import ShardedIVFIndex
from vq_tpu_torch.dist.sharded_ivf_packed import ShardedIvfPackedIndex
from vq_tpu_torch.dist.sharded_packed import ShardedPackedFlatIndex

__all__ = [
    "Mesh",
    "make_mesh",
    "maybe_init_distributed",
    "shard_rows",
    "replicate",
    "sharded_scan_topk",
    "sharded_generic_scan_topk",
    "sharded_exact_topk",
    "dp_lloyd_step",
    "ShardedFlatPQIndex",
    "ShardedFlatIndex",
    "ShardedPackedFlatIndex",
    "ShardedIVFIndex",
    "ShardedIvfPackedIndex",
]
