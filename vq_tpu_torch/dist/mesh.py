"""A device mesh over one process or several — counterpart of
``vq_tpu/dist/mesh.py``.

The JAX package drives a 1-D ``jax.sharding.Mesh`` through ``shard_map``,
with the corpus row-sharded along the mesh axis and queries and parameters
replicated.  The port keeps that model.  A ``Mesh`` is a tuple of
``torch.device``s, one per shard, in shard order; devices may repeat, so
four shards can share one card (or the CPU, as the tests run them).  Shard
p's tensors live on ``devices[p]``; each shard's work is issued under its
own device (``on``), so the CUDA runtime launches it there.

Without a process group the mesh is one process's, every shard is local
and the merged results live on the root, ``devices[0]``.  Under an
initialized ``torch.distributed`` group (``maybe_init_distributed``, the
counterpart of ``jax.distributed.initialize``) the mesh spans the group's
ranks with the JAX package's multi-controller semantics: every rank runs
the same program on the same host inputs, holds and scans only its own
shards (``owners``: each shard's rank, rank-major as ``jax.devices()``
orders processes) and gets the same merged result on its root, its first
local device.  The per-shard tuples of the sharded paths hold ``None`` at
the shards of other ranks.

The two collectives the sharded paths use are functions here:

* ``all_gather``: each shard's block, concatenated along a dimension in
  shard order (``lax.all_gather(..., tiled=True)``);
* ``psum``: the shards' partials summed in shard order, so the result is
  the same from run to run and equal to the one-process mesh's.

Without a group they copy the blocks to the root in this process.  Under a
group each rank stacks its local blocks and the ranks exchange them with
``torch.distributed.all_gather`` (NCCL moves card tensors card to card;
gloo, which cannot gather card tensors, gets them staged through the
host).  ``psum`` gathers and sums in shard order rather than calling
``all_reduce``, whose order of summation belongs to the backend.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import hashlib
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vq_tpu_torch._device import resolve_device

DATA_AXIS = "data"


def maybe_init_distributed(backend: Optional[str] = None, device=None,
                           init_method: Optional[str] = None, rank: Optional[int] = None,
                           world_size: Optional[int] = None, timeout_s: float = 300.0) -> None:
    """Initialize ``torch.distributed`` when ``VQ_DIST_INIT`` is set and no
    group exists yet; a no-op otherwise, as ``vq_tpu``'s.

    The rendezvous is ``init_method`` (default ``env://``: ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets
    them); ``rank`` and ``world_size`` default to the environment's.  The
    backend is ``nccl`` on the card (the default device) and ``gloo`` for
    ``device="cpu"``; ``backend="gloo"`` with card tensors is allowed (the
    collectives stage them through the host), and is the one way to run
    two ranks on one card, which NCCL refuses.  Every wait of the group
    ends after ``timeout_s``.

    Unlike ``vq_tpu``'s, which swallows every exception, a failed init
    raises: a run told to be distributed must not quietly serve one shard
    set."""
    if not os.environ.get("VQ_DIST_INIT") or dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=-1 if rank is None else rank,
                            world_size=-1 if world_size is None else world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


class RankGroup:
    """The process group a mesh spans: this process's ``rank``, the group's
    ``world`` size and ``backend``, and ``exchanges``, the number of
    ``torch.distributed`` gathers the mesh's collectives made through it."""

    def __init__(self, rank: int, world: int, backend: str):
        self.rank, self.world, self.backend = rank, world, backend
        self.exchanges = 0

    @classmethod
    def current(cls) -> "RankGroup":
        return cls(dist.get_rank(), dist.get_world_size(), str(dist.get_backend()))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An immutable 1-D mesh: ``devices`` (one per shard, in shard order),
    ``owners`` (each shard's rank; all 0 without a group) and ``ranks``
    (the group, None for a one-process mesh).  ``local_shards`` are this
    rank's shards, ``root`` their first device, where merged results
    live."""

    devices: Tuple[torch.device, ...]
    owners: Tuple[int, ...] = ()
    ranks: Optional[RankGroup] = dataclasses.field(default=None, compare=False)
    local_shards: Tuple[int, ...] = dataclasses.field(init=False, compare=False)
    axis_names = (DATA_AXIS,)

    def __post_init__(self):
        rank = 0 if self.ranks is None else self.ranks.rank
        if not self.owners:
            object.__setattr__(self, "owners", (rank,) * len(self.devices))
        object.__setattr__(self, "local_shards",
                           tuple(p for p, r in enumerate(self.owners) if r == rank))

    @property
    def root(self) -> torch.device:
        return self.devices[self.local_shards[0]]

    @property
    def size(self) -> int:
        return len(self.devices)

    def is_local(self, p: int) -> bool:
        return self.ranks is None or self.owners[p] == self.ranks.rank

    def each(self, fn: Callable[[int], object]) -> tuple:
        """``fn(p)`` for every local shard p, None for the shards of other
        ranks, in shard order."""
        return tuple(fn(p) if self.is_local(p) else None for p in range(self.size))

    def distinct(self) -> Tuple[torch.device, ...]:
        """The local devices without repeats, in first-use order."""
        return tuple(dict.fromkeys(self.devices[p] for p in self.local_shards))


def unzip(parts: Sequence[Optional[tuple]]) -> Tuple[tuple, tuple]:
    """Per-shard pairs (None at the shards of other ranks) → the per-shard
    firsts and the per-shard seconds."""
    return (tuple(None if t is None else t[0] for t in parts),
            tuple(None if t is None else t[1] for t in parts))


def _explicit(device) -> torch.device:
    """A device with its card index written out (``cuda`` → ``cuda:<current>``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _local_cards() -> List[torch.device]:
    """This process's cards: all visible ones, or ``cuda:LOCAL_RANK`` when
    ``LOCAL_WORLD_SIZE`` ranks share the host (``torchrun``'s variables)."""
    resolve_device(None)  # raises without a card
    if int(os.environ.get("LOCAL_WORLD_SIZE", 1)) > 1:
        return [torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over ``devices`` (default: one shard per visible card; without
    a card that raises, as every entry point of the port does), cut to the
    first ``n_devices``.  Devices may repeat.

    Under a process group ``devices`` lists this rank's devices: the ranks
    exchange their lists and the mesh holds every rank's shards, rank-major,
    then in each rank's order (the same mesh on every rank), cut to the
    first ``n_devices`` of them."""
    devs = _local_cards() if devices is None else [_explicit(d) for d in devices]
    owners, ranks = [0] * len(devs), None
    if dist.is_initialized():
        ranks = RankGroup.current()
        listed = [None] * ranks.world
        dist.all_gather_object(listed, [str(d) for d in devs])
        devs = [torch.device(d) for per_rank in listed for d in per_rank]
        owners = [r for r, per_rank in enumerate(listed) for _ in per_rank]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"a mesh of {n_devices} shards needs {n_devices} devices, got "
                             f"{len(devs)}; list them in devices= (they may repeat)")
        devs, owners = devs[:n_devices], owners[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh's devices must be of one type, got {devs}")
    if ranks is not None and set(owners) != set(range(ranks.world)):
        # every rank sees the same lists, so every rank raises here
        raise ValueError(f"a mesh of {len(devs)} shards leaves ranks "
                         f"{sorted(set(range(ranks.world)) - set(owners))} without a shard")
    return Mesh(tuple(devs), tuple(owners), ranks)


def on(device: torch.device):
    """A context that makes ``device`` the current card (nothing on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is; numpy as a CPU tensor (a copy when it is read-only,
    as ``np.asarray`` of a JAX array is)."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(x) if x.flags.writeable else np.array(x))


def put(x, device: torch.device) -> torch.Tensor:
    """Host data (numpy, a CPU tensor) or a card tensor → a tensor on
    ``device``.  A card tensor may move to another card (sharding is the
    mesh's job), never to the CPU (``_device.to_device``'s rule)."""
    x = as_tensor(x)
    if x.device.type == "cuda" and device.type != "cuda":
        raise ValueError(f"tensor on {x.device} given to a shard on {device}")
    return x.to(device, non_blocking=x.device.type == "cuda")


def shard_rows(mesh: Mesh, x) -> Tuple[Optional[torch.Tensor], ...]:
    """Row-shard an (N, ...) array over the mesh → one (N/P, ...) tensor per
    local shard, on its device (shard p: rows [p·N/P, (p+1)·N/P)), None at
    the shards of other ranks.  N must be divisible by the mesh size:
    callers pad (``pad_rows_to_multiple``) with rows the scans mask by
    ``true_n``."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} shards; pad them first")
    n_loc = n // mesh.size
    return mesh.each(lambda p: put(x[p * n_loc:(p + 1) * n_loc], mesh.devices[p]).contiguous())


def replicate(mesh: Mesh, x) -> Tuple[Optional[torch.Tensor], ...]:
    """One reference per local shard to a copy of ``x`` on that shard's
    device: one copy per distinct device, shared by the shards on it."""
    copies = {dev: put(x, dev) for dev in mesh.distinct()}
    return mesh.each(lambda p: copies[mesh.devices[p]])


def replicate_quantizer(mesh: Mesh, quantizer) -> tuple:
    """One fitted quantizer per local shard on that shard's device: the
    quantizer itself where it lives, elsewhere a shallow copy with its
    params moved there (``replicate`` for the param tree), one per
    distinct device."""
    from vq_tpu_torch.methods.base import tree_map

    copies = {}
    for dev in mesh.distinct():
        if quantizer.device == dev:
            copies[dev] = quantizer
            continue
        rep = copy.copy(quantizer)
        rep.device = dev
        rep.params = tree_map(lambda t, d=dev: put(t, d), quantizer.params)
        copies[dev] = rep
    return mesh.each(lambda p: copies[mesh.devices[p]])


def pad_rows_to_multiple(x, multiple: int):
    """Pad rows (with zeros) so N divides ``multiple``: numpy stays numpy,
    a tensor stays on its device."""
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return np.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))


# ---------------------------------------------------------------- collectives
def _gather_blocks(mesh: Mesh, parts: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
    """Every shard's block, in shard order, on this rank's root: the local
    blocks (all of one shape and dtype on every rank) stacked, padded to
    the most shards a rank holds, and exchanged with the other ranks."""
    ranks, root = mesh.ranks, mesh.root
    local = [put(parts[p], root) for p in mesh.local_shards]
    width = max(mesh.owners.count(r) for r in range(ranks.world))
    send = torch.stack(local + [torch.zeros_like(local[0])] * (width - len(local)))
    if ranks.backend != "nccl" and send.device.type == "cuda":
        send = send.cpu()  # gloo gathers host tensors only
    recv = [torch.empty_like(send) for _ in range(ranks.world)]
    dist.all_gather(recv, send)
    ranks.exchanges += 1
    got = put(torch.cat(recv), root)
    first = {r: mesh.owners.index(r) for r in range(ranks.world)}
    return [got[r * width + p - first[r]] for p, r in enumerate(mesh.owners)]


def all_gather(mesh: Mesh, parts: Sequence[Optional[torch.Tensor]],
               dim: int = 1) -> torch.Tensor:
    """The shards' blocks concatenated along ``dim`` in shard order, on the
    root (``lax.all_gather(..., tiled=True)``); under a group, on every
    rank's root."""
    if mesh.ranks is None:
        return torch.cat([put(t, mesh.root) for t in parts], dim=dim)
    return torch.cat(_gather_blocks(mesh, parts), dim=dim)


def psum(mesh: Mesh, parts: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """The shards' partials summed at the root, in shard order; under a
    group, gathered and summed in shard order on every rank's root."""
    if mesh.ranks is None:
        acc = put(parts[0], mesh.root)
        for t in parts[1:]:
            acc = acc + put(t, mesh.root)
        return acc
    blocks = _gather_blocks(mesh, parts)
    acc = blocks[0]
    for t in blocks[1:]:
        acc = acc + t
    return acc


def gather_values(mesh: Mesh, values: Sequence) -> list:
    """Small host values, one per local shard (None at the others), as one
    list in shard order: this process's values without a group, every
    rank's under one."""
    if mesh.ranks is None:
        return list(values)
    listed = [None] * mesh.ranks.world
    dist.all_gather_object(listed, [values[p] for p in mesh.local_shards])
    return [v for per_rank in listed for v in per_rank]


def check_replicated(mesh: Mesh, tree, what: str) -> None:
    """Under a group: raise unless ``tree``'s array leaves are the same bit
    for bit on every rank (a checksum of their bytes, all-gathered).  Each
    rank fits its replicated state from the same host data; this checks
    it, where a card type or a library that differs could make it
    diverge."""
    if mesh.ranks is None:
        return
    from vq_tpu_torch.methods.base import tree_leaves

    digest = hashlib.sha256()
    for leaf in tree_leaves(tree):
        a = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        digest.update(str((a.dtype, a.shape)).encode())
        digest.update(np.ascontiguousarray(a).tobytes())
    sums = [None] * mesh.ranks.world
    dist.all_gather_object(sums, digest.hexdigest())
    if len(set(sums)) > 1:
        raise RuntimeError(f"{what} differ between ranks (checksums {sums}): every rank must "
                           "fit it from the same host data on the same card type and torch")


def check_savable(mesh: Mesh) -> None:
    """Raise when the mesh has shards of other ranks: their arrays are not
    in this process (``vq_tpu`` cannot save a multi-host index either)."""
    if len(mesh.local_shards) < mesh.size:
        raise RuntimeError(f"a mesh over {mesh.ranks.world} ranks cannot be saved: rank "
                           f"{mesh.ranks.rank} holds {len(mesh.local_shards)} of its "
                           f"{mesh.size} shards")
