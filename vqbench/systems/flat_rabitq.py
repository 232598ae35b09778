"""The program under test for a flat deployment over Extended RaBitQ codes:
``vq_tpu_torch``'s ``FlatQuantizedIndex`` over its ``RaBitQ`` quantizer,
fitted on the corpus as a row source (``fit`` takes the centroid chunk by
chunk, encodes and packs in place) and searched by ``search_with_scores``
over every row, as a user of the package builds and searches it."""

from __future__ import annotations

from vq_tpu_torch import Metric, RaBitQConfig, SearchConfig
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.methods.rabitq import RaBitQ

from vqbench import spans

TILE = 512


def build(x, cfg: dict, traffic: dict, timer=None):
    """The index over x (a tensor or a row source on the card), fitted;
    ``timer`` times the build's encode (the quantizer's ``compress``) as
    ``encode`` and its packed layout (``prepare_scan``) as ``pack``,
    synchronised."""
    q = cfg["quantizer"]
    rq = RaBitQ(RaBitQConfig(num_bits=q["num_bits"], seed=q["seed"]), device=x.device)
    if timer is not None:
        rq.compress = spans.timed(rq.compress, timer, "encode")
        rq.prepare_scan = spans.timed(rq.prepare_scan, timer, "pack")
    index = FlatQuantizedIndex(rq, SearchConfig(metric=Metric(cfg["metric"]),
                                                use_bf16=cfg["search"]["use_bf16"]))
    return index.fit(x)


def search(index, queries, k: int):
    return index.search_with_scores(queries, k)


def counters(index) -> dict:
    """The last search's scanned (query block, tile) pairs, the pairs a
    scan without the prune covers, and the index's tiles."""
    return {"scanned": index.last_tiles_scanned, "units": index.last_scan_units,
            "tiles": -(-index.num_rows // TILE)}


def work(index, x, cfg: dict, traffic: dict):
    """→ a function of a query batch giving the counts the dense packed
    scan's cost is taken from (``costs/packed_dense.py``): every row, its
    D coded dimensions at B bits, the two factors an L2 scan reads (α and
    the shift c2)."""
    d, bits = int(x.shape[1]), int(index.quantizer.cfg.num_bits)
    shape = {"family": "packed_dense", "n": int(index.num_rows), "coded_dims": d,
             "code_bits": d * bits, "factors_per_row": 2, "k": int(traffic["k"]),
             "bf16": bool(cfg["search"]["use_bf16"])}
    return lambda queries: {**shape, "q": int(queries.shape[0])}


def state(index) -> dict:
    """What the reference judges: the fit (centroid, rotation, level
    table) and the packed words and factors in row order."""
    p, cache = index.quantizer.params, index.scan_cache
    return {"centroid": p.centroid, "rotation": p.rotation, "levels": p.levels,
            "words": tuple(cache.words), "factors": cache.factors}
