"""A device mesh driven by one process — counterpart of ``vq_tpu/dist/mesh.py``.

The JAX package is single-controller: one Python process drives a 1-D
``jax.sharding.Mesh`` through ``shard_map``, with the corpus row-sharded
along the mesh axis and queries and parameters replicated.  The port keeps
that model.  A ``Mesh`` is a tuple of ``torch.device``s, one per shard, in
shard order; devices may repeat, so four shards can share one card (or the
CPU, as the tests run them).  Shard p's tensors live on ``devices[p]``; the
merged results live on the root, ``devices[0]``.  Each shard's work is
issued under its own device (``on``), so the CUDA runtime launches it
there.

The two collectives the sharded paths use are functions here, so a
multi-host backend can replace them without touching their callers:

* ``all_gather``: each shard's (Q, k) block copied to the root and
  concatenated along the columns in shard order (``lax.all_gather(...,
  tiled=True)``);
* ``psum``: the shards' partials summed at the root in shard order, so the
  result is the same from run to run.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vq_tpu_torch._device import resolve_device

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An immutable 1-D mesh: ``devices`` (one per shard, in shard order)
    and the ``root`` device, ``devices[0]``, where merged results live."""

    devices: Tuple[torch.device, ...]
    axis_names = (DATA_AXIS,)

    @property
    def root(self) -> torch.device:
        return self.devices[0]

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> Tuple[torch.device, ...]:
        """The devices without repeats, in first-use order."""
        return tuple(dict.fromkeys(self.devices))


def _explicit(device) -> torch.device:
    """A device with its card index written out (``cuda`` → ``cuda:<current>``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over ``devices`` (default: one shard per visible card; without
    a card that raises, as every entry point of the port does), cut to the
    first ``n_devices``.  Devices may repeat."""
    if devices is None:
        resolve_device(None)  # raises without a card
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [_explicit(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"a mesh of {n_devices} shards needs {n_devices} devices, got "
                             f"{len(devs)}; list them in devices= (they may repeat)")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh's devices must be of one type, got {devs}")
    return Mesh(tuple(devs))


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


def shard_rows(mesh: Mesh, x) -> Tuple[torch.Tensor, ...]:
    """Row-shard an (N, ...) array over the mesh → one (N/P, ...) tensor per
    shard, on its device.  N must be divisible by the mesh size: callers
    pad (``pad_rows_to_multiple``) with rows the scans mask by ``true_n``."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} shards; pad them first")
    n_loc = n // mesh.size
    return tuple(put(x[p * n_loc:(p + 1) * n_loc], dev).contiguous()
                 for p, dev in enumerate(mesh.devices))


def replicate(mesh: Mesh, x) -> Tuple[torch.Tensor, ...]:
    """One reference per shard to a copy of ``x`` on that shard's device:
    one copy per distinct device, shared by the shards on it."""
    copies = {dev: put(x, dev) for dev in mesh.distinct()}
    return tuple(copies[dev] for dev in mesh.devices)


def replicate_quantizer(mesh: Mesh, quantizer) -> tuple:
    """One fitted quantizer per shard on that shard's device: the quantizer
    itself where it lives, elsewhere a shallow copy with its params moved
    there (``replicate`` for the param tree), one per distinct device."""
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
    return tuple(copies[dev] for dev in mesh.devices)


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
def all_gather(mesh: Mesh, parts: Sequence[torch.Tensor], dim: int = 1) -> torch.Tensor:
    """The shards' blocks, copied to the root and concatenated along ``dim``
    in shard order (``lax.all_gather(..., tiled=True)``)."""
    return torch.cat([put(t, mesh.root) for t in parts], dim=dim)


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' partials summed at the root, in shard order."""
    acc = put(parts[0], mesh.root)
    for t in parts[1:]:
        acc = acc + put(t, mesh.root)
    return acc
