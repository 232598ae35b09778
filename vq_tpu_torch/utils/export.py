"""Codebook export / query tooling — counterpart of ``vq_tpu/utils/export.py``.

`export_codebook` persists a trained quantizer's codebook vectors to
`.fvecs` (plus optional codes to `.ivecs`), and `query_codebook` searches
the exported codebook for the nearest entries to a batch of queries —
per chunk for product quantizers.  The search is the port's exact scan
(``kernels/adc.py::exact_topk``) on the quantizer's device (the card unless
the caller asks for the CPU).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch._device import as_f32, resolve_device, to_host
from vq_tpu_torch.core.config import Metric
from vq_tpu_torch.data.io import load_fvecs, write_fvecs, write_ivecs
from vq_tpu_torch.kernels.adc import exact_topk
from vq_tpu_torch.methods.base import BaseQuantizer


def _f32(a) -> np.ndarray:
    return np.asarray(to_host(a), dtype=np.float32)


def extract_codebook(model: BaseQuantizer) -> np.ndarray:
    """2-D float32 codebook matrix (numpy) for fvecs export.

    PQ/OPQ → (M·K, dsub) concatenated per-chunk centroids; SQ → the (2, D)
    [min-row, max-row] stack; RankAware → the (D, 2^max_bits) per-dim
    level table.  Bit-level methods (SAQ/RaBitQ/LVQ) have no static
    codebook and raise, as the reference does.
    """
    name = getattr(model, "name", "")
    params = model.params
    if params is None and name not in ("saq",):
        raise ValueError(f"{name}: fit the quantizer before exporting")
    if name in ("pq", "opq"):
        cb = _f32(params.codebooks)  # (M, K, dsub)
        return cb.reshape(-1, cb.shape[-1])
    if name == "sq":
        lo = _f32(params.lo)
        levels = (1 << model.cfg.num_bits) - 1
        hi = lo + _f32(params.scale) * levels
        return np.stack([lo, hi])
    if name in ("rankaware", "perdim_mse"):
        return _f32(params.codebooks)
    raise RuntimeError(
        f"{name}: this quantizer does not expose a static codebook for "
        "export (reference faiss_export.py:172-178 raises identically)"
    )


def export_codebook(
    model: BaseQuantizer,
    output_dir: str,
    codes=None,
    codebook_filename: str = "codebook.fvecs",
    codes_filename: str = "codes.ivecs",
) -> Dict[str, object]:
    """Persist a quantizer's codebook (and optional codes, numpy or a
    tensor on any device) to fvecs/ivecs."""
    os.makedirs(output_dir, exist_ok=True)
    codebook = extract_codebook(model)
    codebook_path = os.path.join(output_dir, codebook_filename)
    write_fvecs(codebook_path, codebook)
    out: Dict[str, object] = {
        "codebook_path": codebook_path,
        "codebook": codebook,
    }
    if codes is not None:
        codes2d = to_host(codes)
        if codes2d.ndim == 1:
            codes2d = codes2d[:, None]
        codes_path = os.path.join(output_dir, codes_filename)
        write_ivecs(codes_path, codes2d.astype(np.int32))
        out["codes_path"] = codes_path
    return out


def _query_product_codebook(
    queries: np.ndarray,
    model: BaseQuantizer,
    codebook_vectors: np.ndarray,
    topk: int,
    metric: Metric,
    device: torch.device,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-chunk nearest-centroid search for PQ/OPQ codebooks: queries are
    split into M sub-vectors, each searched against its chunk's K
    centroids; results are flattened across chunks as (Q, M·topk)."""
    cb = as_f32(model.params.codebooks, device)  # (M, K, dsub)
    m, k_size, dsub = cb.shape
    expected = (m * k_size, dsub)
    if codebook_vectors.shape != expected:
        raise ValueError(
            f"product codebook shape {codebook_vectors.shape} != {expected}"
        )
    q = as_f32(queries, device)
    if getattr(model, "name", "") == "opq":
        q = q @ as_f32(model.params.rotation, device)  # f32: TF32 is off (_device)
    if q.shape[1] != m * dsub:
        raise ValueError(f"query dim {q.shape[1]} != {m * dsub}")
    qs = q.reshape(-1, m, dsub)
    dists, ids = [], []
    for mm in range(m):
        s, i = exact_topk(qs[:, mm, :], cb[mm], k=min(topk, k_size), metric=metric)
        dists.append(to_host(s))
        ids.append(to_host(i) + mm * k_size)  # global codebook row ids
    return np.concatenate(dists, axis=1), np.concatenate(ids, axis=1)


def query_codebook(
    queries,
    model: Optional[BaseQuantizer] = None,
    codebook_vectors: Optional[np.ndarray] = None,
    codebook_path: Optional[str] = None,
    topk: int = 1,
    metric: Metric = Metric.L2,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Search the (exported) codebook for the nearest entries to `queries`.

    Returns (distances, indices) as numpy.  For product quantizers the
    search is per chunk with results flattened across chunks.  Runs on
    ``device``, else the model's, else the card.
    """
    if codebook_vectors is None:
        if codebook_path is not None:
            codebook_vectors = load_fvecs(codebook_path)
        elif model is not None:
            codebook_vectors = extract_codebook(model)
        else:
            raise ValueError(
                "provide model, codebook_vectors, or codebook_path"
            )
    if device is None and model is not None:
        device = model.device
    dev = resolve_device(device)
    queries = np.atleast_2d(np.asarray(to_host(queries), dtype=np.float32))
    if model is not None and getattr(model, "name", "") in ("pq", "opq"):
        return _query_product_codebook(
            queries, model, np.asarray(codebook_vectors, np.float32), topk,
            metric, dev,
        )
    s, i = exact_topk(
        as_f32(queries, dev), as_f32(np.asarray(codebook_vectors, np.float32), dev),
        k=min(topk, len(codebook_vectors)), metric=metric,
    )
    return to_host(s), to_host(i)
