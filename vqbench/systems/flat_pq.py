"""The program under test for a flat PQ deployment: ``vq_tpu_torch``'s
``FlatQuantizedIndex`` over its ``PQ`` quantizer, built by ``fit`` and
searched by ``search_with_scores``, as a user of the package builds and
searches it."""

from __future__ import annotations

from vq_tpu_torch import KMeansConfig, Metric, PQConfig, SearchConfig
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.methods.pq import PQ

from vqbench import spans


def build(x, cfg: dict, traffic: dict, timer=None):
    """The index over x (a card tensor), fitted; ``timer`` (``spans.Timer``)
    times the ``compress`` call of the build, synchronised."""
    q = cfg["quantizer"]
    pq = PQ(PQConfig(q["num_subquantizers"], q["num_bits"], KMeansConfig(**q["kmeans"])),
            seed=q["seed"], device=x.device)
    if timer is not None:
        pq.compress = spans.timed(pq.compress, timer, "encode")
    index = FlatQuantizedIndex(pq, SearchConfig(metric=Metric(cfg["metric"]),
                                                use_bf16=cfg["search"]["use_bf16"]))
    return index.fit(x)


def search(index, queries, k: int):
    return index.search_with_scores(queries, k)


def counters(index) -> dict:
    return {}


def work(index, x, cfg: dict, traffic: dict):
    """→ a function of a query batch giving the shapes the PQ scan's cost
    is counted from (``costs/pq_scan.py``)."""
    cb = index.quantizer.params.codebooks
    shape = {"family": "pq_scan", "n": int(index.num_rows), "m": int(cb.shape[0]),
             "kk": int(cb.shape[1]), "dsub": int(cb.shape[2]), "k": int(traffic["k"]),
             "bf16": bool(cfg["search"]["use_bf16"])}
    return lambda queries: {**shape, "q": int(queries.shape[0])}


def state(index) -> dict:
    """What the reference judges: the fitted codebooks and the codes."""
    return {"codebooks": index.quantizer.params.codebooks, "codes": index.codes}
