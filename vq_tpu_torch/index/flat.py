"""Flat (exhaustive) quantized index — counterpart of ``vq_tpu/index/flat.py``.

The corpus stays compressed on the quantizer's device; search is the
quantizer's ``scan_topk`` (the PQ ADC scan of ``kernels/adc.py``, or the
packed-code scan of SAQ and RaBitQ over the layout ``prepare_scan`` built
once at fit).  The original row
norms are kept as a 4 B/vector side-channel for the normalized-IP metric.
"""

from __future__ import annotations

import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch.core.config import SearchConfig
from vq_tpu_torch._device import as_f32
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

    def fit(self, X) -> "FlatQuantizedIndex":
        """Fit the quantizer (unless it already has params), encode X and
        keep its row norms.  X: numpy (moved to the device) or a tensor."""
        if self.quantizer.params is None:
            self.quantizer.fit(X)
        self.codes = self.quantizer.compress(X)
        x = as_f32(X, self.device)
        self.norms = torch.linalg.norm(x, dim=-1)
        del x
        self.num_rows = X.shape[0]
        self._scan_cache = self.quantizer.prepare_scan(
            self.codes, norms=self.norms, num_queries=self.search_cfg.prepare_queries)
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
        self._scan_cache = self.quantizer.prepare_scan(
            self.codes, norms=self.norms, num_queries=self.search_cfg.prepare_queries)
