"""The program under test for an IVF deployment over packed SAQ codes:
``vq_tpu_torch``'s ``IvfPackedFlatIndex`` over its ``SAQ`` quantizer, built
by ``fit`` and searched by ``search_with_scores`` at the traffic's nprobe,
as a user of the package builds and searches it."""

from __future__ import annotations

import torch

from vq_tpu_torch import IVFConfig, KMeansConfig, Metric, SAQConfig, SearchConfig
from vq_tpu_torch.index.ivf_packed import IvfPackedFlatIndex
from vq_tpu_torch.methods.saq import SAQ

from vqbench import spans
from vqbench.reference import kmeans

TILE = 512


def build(x, cfg: dict, traffic: dict, timer=None):
    """The index over x (a card tensor), fitted; ``timer`` times each
    encode call of the build (the quantizer's ``encode_fn``), synchronised."""
    i, q = cfg["ivf"], cfg["quantizer"]
    saq = SAQ(SAQConfig(**{k: v for k, v in q.items() if k != "method"}), device=x.device)
    if timer is not None:
        encode_fn = saq.encode_fn
        saq.encode_fn = lambda: spans.timed(encode_fn(), timer, "encode")
    ivf = IVFConfig(num_clusters=i["num_clusters"], nprobe=traffic["nprobe"],
                    kmeans=KMeansConfig(**i["kmeans"]))
    index = IvfPackedFlatIndex(saq, ivf, SearchConfig(metric=Metric(cfg["metric"]),
                                                      use_bf16=cfg["search"]["use_bf16"]))
    return index.fit(x)


def search(index, queries, k: int):
    return index.search_with_scores(queries, k)


def counters(index) -> dict:
    """Tiles the last search masked in, and the index's tiles."""
    return {"tiles": index.last_tiles_scanned, "tiles_total": -(-index.num_rows // TILE)}


def work(index, x, cfg: dict, traffic: dict):
    """→ a function of a query batch giving the counts the packed scan's
    cost is taken from (``costs/packed_scan.py``): each query's rows in its
    own probed lists, the rows of the batch's union of probed lists, the
    coded dimensions and bits.  List sizes from x's nearest centroids."""
    cent = index.centroids
    sizes = torch.bincount(kmeans.assign(x, cent).long(), minlength=cent.shape[0])
    nprobe = min(traffic["nprobe"], cent.shape[0])
    plan = index.quantizer.plan
    shape = {"family": "packed_scan", "coded_dims": int(sum(plan.seg_lens)),
             "code_bits": int(sum(ln * b for ln, b in zip(plan.seg_lens, plan.seg_bits))),
             "factors_per_row": 2 * plan.num_segments, "k": int(traffic["k"]),
             "bf16": bool(cfg["search"]["use_bf16"])}

    def count(queries) -> dict:
        probes = torch.topk(-kmeans.sqdist(queries, cent), nprobe, dim=1).indices
        union = torch.zeros((cent.shape[0],), dtype=torch.bool, device=cent.device)
        union[probes.reshape(-1)] = True
        return {**shape, "q": int(queries.shape[0]),
                "rows_per_query_sum": int(sizes[probes].sum()),
                "union_rows": int(sizes[union].sum())}

    return count


def state(index) -> dict:
    """What the reference judges: coarse centroids, rows in cell order, the
    SAQ plan and fit, the packed words and factors."""
    saq, plan, p = index.quantizer, index.quantizer.plan, index.quantizer.params
    return {"centroids": index.centroids, "ids_sorted": index.ids_sorted,
            "plan": (plan.seg_starts, plan.seg_lens, plan.seg_bits), "mean": p.pca_mean,
            "rot": p.pca_rot, "seg_rots": tuple(p.seg_rots), "words": tuple(index.cache.words),
            "factors": index.cache.factors}
