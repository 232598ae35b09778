"""Device and dtype policy of the PyTorch port.

Two rules carried over from the JAX package:

* f32 means f32.  A float32 matmul on the card may run in TF32 (about three
  decimal digits) unless told otherwise; both switches are turned off here,
  the GPU form of the JAX package's ``Precision.HIGHEST`` rule.
* bf16 only on CUDA (mirrors ``vq_tpu/kernels/adc.py::_bf16_supported``):
  on the CPU, ``use_bf16=True`` silently computes in f32 so the same call
  sites run in the CPU tests and on the card.

The card is the default: with no device given, an entry point runs on
``cuda`` (``resolve_device(None)``), and the CPU only when the caller asks
for it (``device="cpu"``, or CPU tensors, as the tests do).  Asking for
``cuda`` -- or asking for nothing -- on a machine without a card raises;
nothing falls back to the CPU.  Host data (numpy, CPU tensors) is moved to
the device it is asked to go to; a tensor on a card never leaves it
(``to_device`` raises).
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` → cuda; ``"cuda"`` (or ``None``) without a card raises
    RuntimeError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_of(x, device=None) -> torch.device:
    """Where code on ``x`` runs: ``device`` when given; else a tensor's own
    device (the caller chose it), else (numpy, np.memmap, array-likes)
    ``resolve_device(None)``, the card."""
    if device is not None:
        return resolve_device(device)
    return x.device if isinstance(x, torch.Tensor) else resolve_device(None)


def bf16_supported(device) -> bool:
    """True only for CUDA devices (see module docstring)."""
    return torch.device(device).type == "cuda"


def make_generator(seed: int, device) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device`` (the port's ``jax.random``
    key; its numbers differ from JAX's for the same seed)."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 (nearest-even) and back to f32: the value the
    TPU kernels feed the MXU, kept in f32 so products accumulate in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """Move a host tensor to ``device``; a tensor on another device (a card)
    raises instead of being copied off it."""
    device = torch.device(device)
    if x.device.type != "cpu" and not _same_device(x.device, device):
        raise ValueError(f"tensor on {x.device} given to code on {device}: pass it on "
                         f"{device}, or build the quantizer on {x.device}")
    return x.to(device)


def to_host(x) -> np.ndarray:
    """A tensor on any device, or an array-like → numpy on the host.  The
    harness's metrics copy card results off through this on purpose (the
    JAX package's ``np.asarray`` of a device array); compute code never
    does (``to_device``)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_f32(x, device) -> torch.Tensor:
    """numpy or tensor → f32 tensor on ``device`` (no copy when it already
    is; see ``to_device`` for a tensor on another device)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return to_device(x, device).to(torch.float32)
