"""Quantizer interface — counterpart of ``vq_tpu/methods/base.py``.

A concrete method is a small stateful class over plain functions on
tensors (``fit → params``, ``encode(params, X) → codes``,
``decode(params, codes) → x̂``); ``params`` is a NamedTuple of tensors, or
of tuples of tensors (SAQ's per-segment rotations), on the quantizer's
``device``.  ``compress``/``decompress`` return tensors on
that device.  A quantizer built without a device takes the device of the
tensor it is fitted on, and the card for numpy input (``device="cpu"``
asks for the CPU); a tensor on a card is never copied to another device
(``_device.to_device`` raises).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from vq_tpu_torch._device import as_f32, device_of, resolve_device


def tree_map(fn, tree):
    """Apply ``fn`` to every array leaf (tensor or numpy) of a params tree of
    NamedTuples and tuples, keeping its structure."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return tree


def tree_leaves(tree) -> list:
    """The array leaves of a params tree, in order (``jax.tree_util.tree_leaves``)."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


class BaseQuantizer:
    """Common harness-facing interface for all quantization methods."""

    name: str = "base"

    def __init__(self, device=None):
        self.params = None
        self._dim: Optional[int] = None
        self.device = None if device is None else resolve_device(device)

    def _bind_device(self, X) -> torch.device:
        """Fix the device at fit time when none was given: a tensor's own,
        else the card (``_device.device_of``)."""
        if self.device is None:
            self.device = device_of(X)
        return self.device

    # -- to implement ------------------------------------------------------
    def fit(self, X) -> "BaseQuantizer":
        raise NotImplementedError

    def compress(self, X) -> torch.Tensor:
        raise NotImplementedError

    def decompress(self, codes) -> torch.Tensor:
        raise NotImplementedError

    def code_bytes_per_vector(self) -> float:
        """Bytes of code storage per vector (incl. per-vector side-channels)."""
        raise NotImplementedError

    def decode_fn(self):
        """Return a ``codes_tile → (T, D)`` decoder; it plugs every method into
        the generic decode→score→top-k scan (``kernels/adc.py``)."""
        raise NotImplementedError

    def encode_fn(self):
        """Optionally return an ``x_tile (T, D) → codes`` encoder for chunked
        index builds (``index/ivf.py::encode_rows_ordered``); None means
        ``compress``."""
        return None

    # -- provided ----------------------------------------------------------
    def scan_topk(self, queries, codes, k: int, metric, norms=None,
                  tile_rows: int = 16384, use_bf16: bool = True, approx: bool = False,
                  cache=None, num_valid=None):
        """ADC search over this method's codes (tensors in and out).  ``cache``
        is what ``prepare_scan`` returned (unused by the generic path)."""
        from vq_tpu_torch.kernels.adc import scan_generic_topk

        return scan_generic_topk(queries, codes, self.decode_fn(), k, metric, norms,
                                 tile_rows, use_bf16, num_valid=num_valid, approx=approx)

    def prepare_scan(self, codes, norms=None):
        """Optionally build a scan-optimized corpus layout once at index fit;
        None means "scan the stored rows directly"."""
        return None

    def prepare_shard_cache(self, codes, norms=None, num_valid_rows=None):
        """A PER-SHARD packed scan layout for the sharded packed index
        (``dist/sharded_packed.py``): like ``prepare_scan``, but rows ≥
        ``num_valid_rows`` are pad rows (each shard holds an equal-size
        block whose tail may be padding), kept maskable by a scan-time
        ``num_valid == num_valid_rows`` prefix limit.  None: this method has
        no packed layout (the sharded packed index then raises)."""
        return None

    def prepare_tile_cache(self, codes, norms=None):
        """An ORDER-PRESERVING packed scan layout (``perm is None``: rows stay
        in the caller's order) for tile-masked scans: the probed-tile IVF
        index (``index/ivf_packed.py``) keeps rows sorted by coarse cluster,
        so each 512-row tile spans a contiguous cluster range, and scans
        only the probed tiles through ``packed_scan_raw(tile_mask=...)``.
        None: this method has no packed layout."""
        return None

    def packed_scan_raw(self, queries, packed, k, metric, num_valid=None, use_bf16=True,
                        tile_mask=None):
        """Maximize-form (scores, scan-position ids) of the packed kernel over
        a ``prepare_scan`` / ``prepare_tile_cache`` layout, restricted to the
        tiles of ``tile_mask`` when given; only methods with a packed layout
        have one."""
        raise NotImplementedError(f"{self.name} has no packed scan layout")

    def residual_scorer(self):
        """Optionally a CODE-SPACE window scorer for the IVF list scans
        (``index/ivf.py``): a pair of functions

            q_map(v (N, D)) → (v_cat (N, Dc) f32, v_add (N,) f32)
                with v · decode(ct)[t] == v_cat · ô[t] + v_add for every
                row t (a rotation into code space plus the constant
                mean / centroid dot),
            window(ct (T, row_bytes)) → (ô (T, Dc) f32, r2 (T,) f32)
                with r2[t] == ‖decode(ct)[t]‖².

        Rotation-based methods (SAQ, RaBitQ, RankAware) give one, so a list
        scan rotates the queries and centroids once instead of un-rotating
        every decoded window.  None: windows score through ``decode_fn``."""
        return None

    @property
    def dim(self) -> Optional[int]:
        return self._dim

    def get_compression_ratio(self, X) -> float:
        """float32 input bytes / code bytes."""
        return X.shape[1] * 4.0 / self.code_bytes_per_vector()

    def reconstruction_mse(self, X, sample: Optional[int] = None) -> float:
        xs = X if sample is None or len(X) <= sample else X[:sample]
        x = as_f32(xs, self.device)
        rec = self.decompress(self.compress(x))
        return float(torch.mean((x - rec) ** 2))

    def config_dict(self) -> Dict[str, Any]:
        return {}

    # -- persistence -------------------------------------------------------
    def _payload(self) -> Dict[str, Any]:
        return {"name": self.name, "dim": self._dim,
                "params": tree_map(lambda t: t.cpu().numpy(), self.params),
                "config": self.config_dict()}

    def _restore_payload(self, payload: Dict[str, Any]) -> None:
        self._dim = payload["dim"]
        if self.device is None:
            self.device = resolve_device(None)
        self.params = tree_map(lambda a: torch.as_tensor(a, device=self.device),
                               payload["params"])

    def save(self, path: str) -> None:
        """Persist params as a pickle of host numpy arrays."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self._payload(), f)

    def load(self, path: str) -> "BaseQuantizer":
        with open(path, "rb") as f:
            self._restore_payload(pickle.load(f))
        return self

    def save_codebooks(self, path: str) -> None:
        """Codebook export hook: by default the whole of ``save``."""
        self.save(path)
