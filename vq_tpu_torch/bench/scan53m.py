"""The 53M-row envelope on one card — counterpart of the JAX system's
``scripts/scan53m.py``: an MS MARCO-like corpus of N=53,000,000 rows at
D=1024, made on the card in 131,072-row chunks (generation stands in for
reading them from disk), encoded chunk by chunk, then one sustained scan
over every row.

    python -m vq_tpu_torch.bench.scan53m [--n 53000000] [--q Q]
        [--method pq|saq] [--chunk 131072] [--device cuda|cpu]

* ``pq``: PQ M=16 B=8 (15 Lloyd iterations) fitted on the first chunk;
  every chunk is encoded and only the uint8 codes stay resident (848 MB at
  53M rows), then the fused PQ kernel scans them at Q=1024, k=10.
* ``saq``: SAQ bpd=1 (uniform allocator: one 1-bit segment of the full
  width) fitted on the first chunk.  The whole packed cache — the word
  plane, the (F, N) factors and the tile stats — is allocated once and
  filled in place chunk by chunk (``methods/saq.py::fill_packed``); each
  chunk's byte rows are freed as it is converted,
  so no chunk list and no second copy of the 6.8 GB plane ever exist.
  Then the dense packed kernel scans all rows at Q=256, k=10.  At 53M rows
  and D=1024 the 1-bit plane holds 53,000,192/32·1024 ≈ 1.70e9 int32
  words: under 2³¹, but close; the kernels index it with 64-bit offsets.

No (N, D) f32 tensor ever exists (it would be 217 GB): a chunk is made,
encoded and dropped.  The quality check needs no ground truth: the queries
are jittered rows of the last chunk, so each one's nearest row is its
source row, and top-1 must be that row's global id for ≥ 95% of them
(exit 1 below).  One JSON line per method: rows/s, QPS, fit and encode
seconds (PQ: generation + encode; SAQ: the encode alone, and the rest of
the build — generation, conversion, copies — as fill seconds), the
self-recall, the peak device memory and the card's name and power limit.
Times are host-clock windows around synchronised calls.  The entry point
runs on the card unless ``--device cpu`` asks for the CPU; without a card
it raises before any work.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Iterable, Optional, Tuple

import torch

from vq_tpu_torch._device import make_generator, resolve_device
from vq_tpu_torch.bench.corpora import powerlaw_sigma
from vq_tpu_torch.bench.headline import card, sustained, sync
from vq_tpu_torch.core.config import KMeansConfig, Metric, PQConfig, SAQConfig
from vq_tpu_torch.kernels.packed_scan import TILE
from vq_tpu_torch.methods.saq import fill_packed

D = 1024
CHUNK = 131_072  # rows a chunk; a multiple of the packed layout's 512-row tile
SELF_RECALL_FLOOR = 0.95


def gen_chunk(i0: int, rows: int, sigma: torch.Tensor) -> torch.Tensor:
    """Rows [i0, i0 + rows) of the corpus: N(0, diag σ²), σ_i = (1+i)^-0.6,
    from the chunk's own seed 1000 + i0 (scan53m.py:190-192)."""
    g = make_generator(1000 + i0, sigma.device)
    return torch.randn((rows, sigma.shape[0]), generator=g, device=sigma.device).mul_(sigma)


def stream(n: int, chunk: int, sigma: torch.Tensor, last: dict):
    """(first row, rows) chunk after chunk of the n-row corpus; ``last``
    keeps the latest chunk's rows and first row (the queries' sources)."""
    for i0 in range(0, n, chunk):
        x = gen_chunk(i0, min(chunk, n - i0), sigma)
        last.update(x=x, i0=i0)
        yield i0, x


def self_recall_queries(last: dict, nq: int, sigma: torch.Tensor):
    """Queries = rows of the last chunk jittered by 0.05σ → (queries, their
    source rows' global ids); the chunk's rows are dropped."""
    x = last.pop("x")
    g = make_generator(2, x.device)
    qi = torch.randint(0, x.shape[0], (nq,), generator=g, device=x.device)
    q = x[qi] + 0.05 * sigma * torch.randn((nq, x.shape[1]), generator=g, device=x.device)
    return q, qi + last["i0"]


def top1_recovery(ids: torch.Tensor, src: torch.Tensor) -> float:
    """Share of queries whose top-1 id is their source row."""
    return float((ids[:, 0].long() == src.long()).float().mean())


def keep_index(keep: Optional[dict], search, q: torch.Tensor, src: torch.Tensor,
               sigma: torch.Tensor) -> None:
    """Into ``keep`` (if not None): ``search`` (queries → the run's top-k
    over all n rows, as the run scanned), the run's queries and their
    source ids, and σ, so a caller can query the resident index again."""
    if keep is not None:
        keep.update(search=search, queries=q, sources=src, sigma=sigma)


def encode_pq(params, n: int, chunks: Iterable[Tuple[int, torch.Tensor]]) -> torch.Tensor:
    """(n, M) PQ codes of an n-row corpus given as (first row, rows) chunks,
    each encoded as it comes (``pq.encode``); only the codes stay."""
    from vq_tpu_torch.methods.pq import encode

    codes = None
    for i0, x in chunks:
        c = encode(params, x)
        if codes is None:
            codes = torch.empty((n, c.shape[1]), dtype=c.dtype, device=c.device)
        codes[i0:i0 + x.shape[0]] = c
    return codes


def run_pq(n: int, nq: int, device, chunk: int = CHUNK, k: int = 10, reps: int = 3,
           keep: Optional[dict] = None) -> dict:
    """PQ M=16 B=8 over the streamed corpus → the record (module docstring).
    ``keep``, if given, receives what stays resident for further queries
    (``keep_index``)."""
    from vq_tpu_torch.kernels.adc import scan_codes_topk
    from vq_tpu_torch.methods.pq import PQ

    dev = torch.device(device)
    sigma = powerlaw_sigma(D, 0.6, dev)
    t0 = time.perf_counter()
    pq = PQ(PQConfig(num_subquantizers=16, num_bits=8, kmeans=KMeansConfig(iters=15)),
            seed=0, device=dev).fit(gen_chunk(0, min(chunk, n), sigma))
    sync(dev)
    t_fit = time.perf_counter() - t0
    last = {}
    t0 = time.perf_counter()
    codes = encode_pq(pq.params, n, stream(n, chunk, sigma, last))
    sync(dev)
    t_encode = time.perf_counter() - t0
    q, src = self_recall_queries(last, nq, sigma)
    cb = pq.params.codebooks

    def search(qs):
        return scan_codes_topk(qs, codes, cb, k, Metric.L2, use_bf16=True)

    def scan():
        return search(q)

    top1 = top1_recovery(scan()[1], src)
    _, best = sustained(scan, dev, reps, reps)
    keep_index(keep, search, q, src, sigma)
    return {"method": "pq_m16x8", "n": n, "num_queries": nq, "fit_s": t_fit,
            "encode_s": t_encode, "encode_rows_per_s": n / t_encode,
            "scan_s_per_batch": best, "qps_per_chip": nq / best,
            "rows_scored_per_s": n * nq / best, "top1_source_recovery": top1,
            "code_bytes_total": codes.numel() * codes.element_size()}


def run_saq(n: int, nq: int, device, chunk: int = CHUNK, k: int = 10, reps: int = 3,
            keep: Optional[dict] = None) -> dict:
    """SAQ bpd=1 over the streamed corpus through the dense packed kernel →
    the record (module docstring).  ``keep`` as in ``run_pq``."""
    from vq_tpu_torch.methods import saq

    if chunk % TILE:
        raise ValueError(f"chunk {chunk} is not a multiple of the {TILE}-row tile")
    dev = torch.device(device)
    sigma = powerlaw_sigma(D, 0.6, dev)
    cfg = SAQConfig(bits_per_dim=1.0, allocator="uniform", use_pca=True)
    t0 = time.perf_counter()
    plan, params = saq.fit(gen_chunk(0, min(chunk, n), sigma), cfg, device=dev)
    sync(dev)
    t_fit = time.perf_counter() - t0
    last = {}
    t_enc = [0.0]

    def code_chunks():
        for i0, x in stream(n, chunk, sigma, last):
            t = time.perf_counter()
            codes = saq.encode(plan, params, x)
            sync(dev)
            t_enc[0] += time.perf_counter() - t
            yield i0, codes

    t0 = time.perf_counter()
    cache = fill_packed(plan, params, n, code_chunks(), dev)
    sync(dev)
    t_build = time.perf_counter() - t0
    q, src = self_recall_queries(last, nq, sigma)
    # the row count comes from a stand-in with no columns: the packed route
    # reads only the cache
    rows = torch.empty((n, 0), dtype=torch.uint8, device=dev)

    def search(qs):
        return saq.scan_topk(plan, params, qs, rows, k, Metric.L2, packed_cache=cache,
                             use_packed=True, prune_tiles=False)

    def scan():
        return search(q)

    top1 = top1_recovery(scan()[1], src)
    _, best = sustained(scan, dev, reps, reps)
    keep_index(keep, search, q, src, sigma)
    cache_bytes = sum(w.numel() * w.element_size() for w in cache.words) + \
        cache.factors.numel() * 4 + cache.tile_stats.numel() * 4
    return {"method": "saq_bpd1_packed", "n": n, "num_queries": nq, "fit_s": t_fit,
            "encode_s": t_enc[0], "fill_s": t_build - t_enc[0], "build_s": t_build,
            "encode_rows_per_s": n / t_enc[0], "scan_s_per_batch": best,
            "qps_per_chip": nq / best, "rows_scored_per_s": n * nq / best,
            "top1_source_recovery": top1, "packed_cache_bytes": cache_bytes,
            "segments": [{"len": ln, "bits": b} for ln, b in zip(plan.seg_lens, plan.seg_bits)]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m vq_tpu_torch.bench.scan53m",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=53_000_000)
    p.add_argument("--q", type=int, help="queries (default: 1024 for pq, 256 for saq)")
    p.add_argument("--method", choices=("pq", "saq"), default="pq")
    p.add_argument("--chunk", type=int, default=CHUNK)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(a.device)  # raises without a card unless --device cpu
    nq = a.q or (1024 if a.method == "pq" else 256)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rec = (run_pq if a.method == "pq" else run_saq)(a.n, nq, dev, a.chunk)
    rec["peak_device_bytes"] = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                                else None)
    rec["card_name"], rec["card_power_limit"] = card(dev)
    print(json.dumps(rec), flush=True)
    if rec["top1_source_recovery"] < SELF_RECALL_FLOOR:
        print(f"FATAL: top-1 source recovery {rec['top1_source_recovery']} < "
              f"{SELF_RECALL_FLOOR}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
