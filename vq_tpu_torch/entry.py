"""The engine's forward step — counterpart of the JAX system's
``__graft_entry__.py::entry()``: the fused PQ ADC scan + top-k, the hot
path, on the arrays it names (numpy seed 0: 16×128 f32 queries, 4096×16
uint8 codes, 16×256×8 f32 codebooks; k=10, L2).

    fn, args = entry()          # on the card
    scores, ids = fn(*args)     # the fused PQ kernel (kernels/pq_scan.py)

``entry(device="cpu")`` puts the arrays on the CPU, where the kernel
wrapper runs its plain version; with no device and no card it raises.
"""

from __future__ import annotations

import numpy as np
import torch

from vq_tpu_torch._device import resolve_device
from vq_tpu_torch.core.config import Metric
from vq_tpu_torch.kernels.adc import scan_codes_topk


def entry(device=None):
    """→ (fn, (queries, codes, codebooks)) on ``device`` (default: the card)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    queries = torch.as_tensor(rng.standard_normal((16, 128)), dtype=torch.float32, device=dev)
    codes = torch.as_tensor(rng.integers(0, 256, (4096, 16)), dtype=torch.uint8, device=dev)
    codebooks = torch.as_tensor(rng.standard_normal((16, 256, 8)), dtype=torch.float32,
                                device=dev)

    def fn(queries, codes, codebooks):
        return scan_codes_topk(queries, codes, codebooks, k=10, metric=Metric.L2,
                               tile_rows=1024)

    return fn, (queries, codes, codebooks)
