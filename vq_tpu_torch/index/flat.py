"""Flat (exhaustive) quantized index — counterpart of ``vq_tpu/index/flat.py``.

The corpus stays compressed on the quantizer's device; search is the
quantizer's ``scan_topk`` (the PQ ADC scan of ``kernels/adc.py``, or the
packed-code scan of SAQ, RaBitQ and RankAware over the layout
``prepare_scan`` built once at fit, ``methods/packed.py``).  The original row
norms are kept as a 4 B/vector side-channel for the normalized-IP metric.

``fit`` takes a row source — a tensor, numpy / np.memmap, or any object
with ``shape`` whose ``X[i0:i1]`` slices (and ``X[ids]`` row lists) give
rows as numpy or tensors — and never holds more than a chunk of it as f32
on the device: the quantizer samples its fit and encodes chunk by chunk,
and the norms are taken a chunk at a time.  Its stages are spans
(``utils/trace.py``): ``build`` around them, ``build.fit``,
``build.encode``, ``build.norms`` and ``build.pack``.
"""

from __future__ import annotations

import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch.core.config import SearchConfig
from vq_tpu_torch._device import as_f32
from vq_tpu_torch.data.sampling import chunk_rows_for_bytes
from vq_tpu_torch.index.base import BaseSearchIndex, nbytes_of
from vq_tpu_torch.methods.base import BaseQuantizer, tree_leaves
from vq_tpu_torch.utils.trace import span


class FlatQuantizedIndex(BaseSearchIndex):
    name = "flat"

    def __init__(self, quantizer: BaseQuantizer, search_cfg: SearchConfig = SearchConfig()):
        self.quantizer = quantizer
        self.search_cfg = search_cfg
        self.codes: Optional[torch.Tensor] = None
        self.norms: Optional[torch.Tensor] = None  # original ‖x‖ side-channel
        self.num_rows = 0
        self._scan_cache = None

    @property
    def device(self) -> torch.device:
        return self.quantizer.device

    @property
    def scan_cache(self):
        """What the quantizer's ``prepare_scan`` built at fit (SAQ: the
        norm-ordered ``PackedCorpus``), or None."""
        return self._scan_cache

    def fit(self, X, chunk_rows: int = 0) -> "FlatQuantizedIndex":
        """Fit the quantizer (unless it already has params), encode X and
        keep its row norms, taken ``chunk_rows`` rows at a time (default:
        256 MB of f32).  X: a row source (module docstring); the index
        lives on the quantizer's device (X's, or the card for host data,
        when the quantizer has none)."""
        n, d = X.shape
        chunk = chunk_rows or chunk_rows_for_bytes(d)
        with span("build"):
            if self.quantizer.params is None:
                with span("build.fit"):
                    self.quantizer.fit(X)
            with span("build.encode"):
                self.codes = self.quantizer.compress(X)
            with span("build.norms"):
                self.norms = torch.empty((n,), dtype=torch.float32, device=self.device)
                for i0 in range(0, n, chunk):
                    self.norms[i0:i0 + chunk] = torch.linalg.norm(
                        as_f32(X[i0:i0 + chunk], self.device), dim=-1)
            self.num_rows = n
            with span("build.pack"):
                self._scan_cache = self.quantizer.prepare_scan(self.codes, norms=self.norms)
        return self

    def search_with_scores(self, queries, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """(nq, D) → ((nq, k) uint32 ids, (nq, k) scores) as numpy."""
        with span("search"):
            scores, idx = self.quantizer.scan_topk(
                as_f32(queries, self.device), self.codes, k, self.search_cfg.metric,
                norms=self.norms, tile_rows=self.search_cfg.tile_rows,
                use_bf16=self.search_cfg.use_bf16, approx=self.search_cfg.approx,
                cache=self._scan_cache)
            with span("search.fetch"):
                return idx.cpu().numpy().astype(np.uint32), scores.cpu().numpy()

    @property
    def last_tiles_scanned(self) -> int:
        """The packed kernel's scanned units in the last search: (query
        block, tile) pairs on the card, tiles in the plain twin's sequence
        on the CPU; every unit with the variance prune off; 0 where the
        search took no dense packed scan (the cache's ``last_scan``, set by
        ``methods/packed.py::dense_topk``).  Reading it syncs the device scalar."""
        return int(self._last_scan().get("tiles_scanned", 0))

    @property
    def last_scan_units(self) -> int:
        """The units ``last_tiles_scanned`` counts a part of: what the last
        search's dense packed scan covers without the prune (0: none ran)."""
        return int(self._last_scan().get("scan_units", 0))

    def _last_scan(self) -> dict:
        return getattr(self._scan_cache, "last_scan", {})

    def memory_footprint(self) -> int:
        params_b = sum(nbytes_of(p) for p in tree_leaves(self.quantizer.params))
        return nbytes_of(self.codes) + params_b + nbytes_of(self.norms)

    def reconstruction_mse(self, X, sample: Optional[int] = 10000) -> float:
        return self.quantizer.reconstruction_mse(X, sample)

    def _state(self) -> dict:
        # the whole quantizer is pickled (its config lives outside params)
        return {
            "codes": self.codes.cpu().numpy(),
            "norms": self.norms.cpu().numpy(),
            "num_rows": self.num_rows,
            "quantizer": pickle.dumps(self.quantizer),
            "search_cfg": self.search_cfg,
        }

    def _restore(self, state: dict) -> None:
        self.quantizer = pickle.loads(state["quantizer"])
        self.codes = torch.as_tensor(state["codes"], device=self.device)
        self.norms = torch.as_tensor(state["norms"], device=self.device)
        self.num_rows = state["num_rows"]
        self.search_cfg = state["search_cfg"]
        self._scan_cache = self.quantizer.prepare_scan(self.codes, norms=self.norms)
