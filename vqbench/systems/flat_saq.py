"""The program under test for a flat deployment over packed SAQ codes:
``vq_tpu_torch``'s ``FlatQuantizedIndex`` over its ``SAQ`` quantizer, fitted
on the corpus as a row source (``fit`` samples, encodes and packs it chunk
by chunk) and searched by ``search_with_scores`` over every row, as a user
of the package builds and searches it."""

from __future__ import annotations

from vq_tpu_torch import Metric, SAQConfig, SearchConfig
from vq_tpu_torch.index.flat import FlatQuantizedIndex
from vq_tpu_torch.methods.saq import SAQ

from vqbench import spans

TILE = 512


def build(x, cfg: dict, traffic: dict, timer=None):
    """The index over x (a tensor or a row source on the card), fitted;
    ``timer`` times the build's encode (the quantizer's ``compress``) as
    ``encode`` and its packed layout (``prepare_scan``) as ``pack``,
    synchronised."""
    q = cfg["quantizer"]
    saq = SAQ(SAQConfig(**{k: v for k, v in q.items() if k != "method"}), device=x.device)
    if timer is not None:
        saq.compress = spans.timed(saq.compress, timer, "encode")
        saq.prepare_scan = spans.timed(saq.prepare_scan, timer, "pack")
    index = FlatQuantizedIndex(saq, SearchConfig(metric=Metric(cfg["metric"]),
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
    scan's cost is taken from (``costs/packed_dense.py``): every row, the
    coded dimensions and bits, the factors an L2 scan reads."""
    plan = index.quantizer.plan
    shape = {"family": "packed_dense", "n": int(index.num_rows),
             "coded_dims": int(sum(plan.seg_lens)),
             "code_bits": int(sum(ln * b for ln, b in zip(plan.seg_lens, plan.seg_bits))),
             "factors_per_row": 2 * plan.num_segments, "k": int(traffic["k"]),
             "bf16": bool(cfg["search"]["use_bf16"])}
    return lambda queries: {**shape, "q": int(queries.shape[0])}


def state(index) -> dict:
    """What the reference judges: the SAQ plan and fit, the packed words and
    factors in scan order, and the scan order (``perm``: scan position →
    row id; None where the rows were not norm-ordered)."""
    plan, p, cache = index.quantizer.plan, index.quantizer.params, index.scan_cache
    return {"plan": (plan.seg_starts, plan.seg_lens, plan.seg_bits), "mean": p.pca_mean,
            "rot": p.pca_rot, "seg_rots": tuple(p.seg_rots), "words": tuple(cache.words),
            "factors": cache.factors, "perm": cache.perm}
