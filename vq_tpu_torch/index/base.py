"""Search-index interface — counterpart of ``vq_tpu/index/base.py``:
fit / search / search_with_scores / memory_footprint / save / load /
reconstruction_mse."""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np


class BaseSearchIndex:
    name: str = "base"

    def fit(self, X) -> "BaseSearchIndex":
        raise NotImplementedError

    def search(self, queries, k: int = 10) -> np.ndarray:
        """(nq, D) → (nq, k) uint32 neighbor ids."""
        ids, _ = self.search_with_scores(queries, k)
        return ids

    def search_with_scores(self, queries, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def memory_footprint(self) -> int:
        """Bytes of index storage (codes + codebooks + side-channels)."""
        raise NotImplementedError

    def reconstruction_mse(self, X, sample: Optional[int] = 10000) -> float:
        raise NotImplementedError

    def _state(self) -> dict:
        raise NotImplementedError

    def _restore(self, state: dict) -> None:
        raise NotImplementedError

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({"name": self.name, "state": self._state()}, f)

    def load(self, path: str) -> "BaseSearchIndex":
        with open(path, "rb") as f:
            payload = pickle.load(f)
        self._restore(payload["state"])
        return self


def nbytes_of(a) -> int:
    """Size in bytes without a device→host copy (tensors and numpy arrays
    both report ``.nbytes``)."""
    if a is None:
        return 0
    n = getattr(a, "nbytes", None)
    return int(n) if n is not None else int(np.asarray(a).nbytes)
