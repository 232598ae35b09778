"""HuggingFace streaming dataset loaders (soft dependency) — counterpart
of ``vq_tpu/data/hf_loaders.py``.

API parity with the reference's loaders (SURVEY.md §2.1 P32-P34):
  load_dbpedia_openai_1536_100k / _1536 / _3072  (data/dbpedia_loader.py)
  load_cohere_msmarco_passages / _queries        (data/cohere_msmarco_loader.py)

Each streams the HF dataset into a pre-allocated float32 array (the
reference's pattern, dbpedia_loader.py:190-218).  `datasets` is a soft
import; at scale the intended path is pre-materializing per-host
.npy/.fvecs shards and mmap-ing them (SURVEY.md §7.3 "53M ingestion").
Ground truth of a loaded ``Dataset`` is computed on ``device`` (the card
unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from vq_tpu_torch.core.config import Metric
from vq_tpu_torch.data.datasets import Dataset


def _require_datasets():
    try:
        import datasets  # type: ignore

        return datasets
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "HuggingFace `datasets` is not installed in this environment; "
            "pre-materialize .npy/.fvecs shards with scripts/prep_dataset.py "
            "instead (SURVEY.md §7.3)"
        ) from e


def _stream_to_array(
    it, field: str, num_rows: int, dim: int, dtype=np.float32
) -> np.ndarray:
    """Fill a pre-allocated (num_rows, dim) array from a streaming iterator
    (reference dbpedia_loader.py:190-218 pattern)."""
    out = np.empty((num_rows, dim), dtype=dtype)
    n = 0
    for row in it:
        v = row[field]
        out[n] = np.asarray(v, dtype=dtype)
        n += 1
        if n >= num_rows:
            break
    if n < num_rows:
        out = out[:n]
    return out


def load_dbpedia_openai(
    num_rows: int = 1_000_000,
    dim: int = 1536,
    num_queries: int = 1000,
    split: str = "train",
    device=None,
) -> Dataset:
    """DBpedia-entities OpenAI embeddings (1536-d text-embedding-3 or ada-002;
    reference data/dbpedia_loader.py:24-160)."""
    datasets = _require_datasets()
    name = (
        "Qdrant/dbpedia-entities-openai3-text-embedding-3-large-3072-1M"
        if dim == 3072
        else "KShivendu/dbpedia-entities-openai-1M"
    )
    field = (
        "text-embedding-3-large-3072-embedding" if dim == 3072 else "openai"
    )
    ds = datasets.load_dataset(name, split=split, streaming=True)
    vectors = _stream_to_array(iter(ds), field, num_rows + num_queries, dim)
    return Dataset(
        name=f"dbpedia-{dim}-{num_rows}",
        vectors=vectors[:-num_queries],
        queries=vectors[-num_queries:],
        metric=Metric.L2,
        device=device,
    )


def load_dbpedia_openai_1536_100k(num_queries: int = 1000, device=None) -> Dataset:
    return load_dbpedia_openai(100_000, 1536, num_queries, device=device)


def load_dbpedia_openai_1536(num_queries: int = 1000, device=None) -> Dataset:
    return load_dbpedia_openai(1_000_000, 1536, num_queries, device=device)


def load_dbpedia_openai_3072(num_rows: int = 1_000_000, num_queries: int = 1000,
                             device=None) -> Dataset:
    return load_dbpedia_openai(num_rows, 3072, num_queries, device=device)


def stream_cohere_msmarco_passages(
    batch_size: int = 100_000, max_vectors: Optional[int] = None
) -> Iterator[np.ndarray]:
    """Batched stream over Cohere/msmarco-v2-embed-english-v3 (53.2M
    passages, 1024-d; reference data/cohere_msmarco_loader.py:22-96)."""
    datasets = _require_datasets()
    ds = datasets.load_dataset(
        "Cohere/msmarco-v2.1-embed-english-v3", split="train", streaming=True
    )
    buf = []
    count = 0
    for row in ds:
        buf.append(np.asarray(row["emb"], dtype=np.float32))
        count += 1
        if len(buf) >= batch_size:
            yield np.stack(buf)
            buf = []
        if max_vectors is not None and count >= max_vectors:
            break
    if buf:
        yield np.stack(buf)


def load_cohere_msmarco_queries(num_queries: int = 10_000) -> np.ndarray:
    datasets = _require_datasets()
    ds = datasets.load_dataset(
        "Cohere/msmarco-v2.1-embed-english-v3", "queries", split="train",
        streaming=True,
    )
    return _stream_to_array(iter(ds), "emb", num_queries, 1024)
