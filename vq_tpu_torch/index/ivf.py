"""IVF build helpers — counterpart of ``vq_tpu/index/ivf.py`` (the helpers
only; ``IvfQuantizedIndex`` and its list scans are not ported yet).

Every helper streams ``chunk`` rows at a time, so a host corpus (numpy,
np.memmap, an array-like) never comes whole onto the card: peak device
memory is one (chunk, D) f32 slab plus its codes.  A corpus that is a
tensor is gathered where it lives.  Unlike the JAX package's, the results
stay on the device (assignments, codes and norms are tensors there): the
index built from them lives on the card too.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vq_tpu_torch._device import as_f32, to_device
from vq_tpu_torch.kernels.kmeans import assign
from vq_tpu_torch.methods.base import BaseQuantizer


def _take_rows(X, idx, device) -> torch.Tensor:
    """Corpus rows by integer index (a tensor or numpy) → (len(idx), D) f32
    on ``device``.  A tensor corpus gathers on its own device (a card tensor
    is never copied off it, see ``_device.to_device``); a host corpus
    gathers host-side and moves one chunk."""
    if isinstance(X, torch.Tensor):
        return as_f32(X[torch.as_tensor(idx, device=X.device).long()], device)
    idx = idx.cpu().numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
    rows = X[idx]
    if isinstance(rows, torch.Tensor):
        return as_f32(rows, device)
    return as_f32(np.asarray(rows, dtype=np.float32), device)


def chunked_assign(X, centroids: torch.Tensor, chunk: int) -> torch.Tensor:
    """Nearest-centroid assignment streamed in ``chunk``-row slices → (N,)
    int32 on the centroids' device."""
    n = X.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=centroids.device)
    for i0 in range(0, n, chunk):
        i1 = min(i0 + chunk, n)
        out[i0:i1] = assign(as_f32(X[i0:i1], centroids.device), centroids)
    return out


def encode_rows_ordered(X, order, assignment, centroids: torch.Tensor,
                        quantizer: BaseQuantizer, chunk: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual-encode rows X[order] in ``order`` sequence, ``chunk`` rows at
    a time → (codes (N, ...), norms (N,) f32 of the original rows), both on
    the quantizer's device.  ``order`` and ``assignment`` are integer
    tensors or numpy arrays; row i of the result is X[order[i]] minus its
    centroid centroids[assignment[order[i]]]."""
    dev = quantizer.device
    order = to_device(torch.as_tensor(order), dev).long()
    assignment = to_device(torch.as_tensor(assignment), dev).long()
    enc = quantizer.encode_fn() or quantizer.compress
    n = order.shape[0]
    codes = None
    norms = torch.empty((n,), dtype=torch.float32, device=dev)
    for i0 in range(0, n, chunk):
        idx = order[i0:i0 + chunk]
        rows = _take_rows(X, idx, dev)
        c = enc(rows - centroids[assignment[idx]])
        if codes is None:
            codes = torch.empty((n,) + tuple(c.shape[1:]), dtype=c.dtype, device=dev)
        codes[i0:i0 + idx.shape[0]] = c
        norms[i0:i0 + idx.shape[0]] = torch.linalg.norm(rows, dim=1)
    return codes, norms
