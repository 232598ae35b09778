"""IVF index: coarse k-means cells + residual-quantized inverted lists —
counterpart of ``vq_tpu/index/ivf.py``.

Rows are sorted by cluster into CSR form (``codes_sorted``, ``ids_sorted``,
``offsets``, ``sizes``, with ``_PAD_SLACK`` rows of tail padding); a search

  1. scores all K centroids with one product and takes the top-nprobe
     (``ordered_topk``: ``lax.top_k``'s order, so the probes equal the JAX
     package's),
  2. walks the probed lists in ``chunk``-row windows — by default the batch's
     UNION of probed lists (``scan_union_lists``: each window decodes once,
     every query scores it in one product, per-(query, cluster) membership
     masks keep each query's candidates exact); ``scan_probed_lists`` walks
     each (query, probe) pair's list instead,
  3. scores candidates against their cluster's RESIDUAL with the
     quantizer's decode, or its code-space ``residual_scorer``,
  4. folds every window into a running top-k per query.

This is XLA code in the JAX package (``lax.while_loop`` over windows,
``lax.map`` over query blocks), so here it is plain PyTorch: Python loops
over device tensors, with one host read a query block for the loop bound.
The build helpers stream ``chunk`` rows at a time, so a host corpus (numpy,
np.memmap) never comes whole onto the card; the index lives on the
quantizer's device.
"""

from __future__ import annotations

import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from vq_tpu_torch._device import as_f32, make_generator, to_device
from vq_tpu_torch.core.config import IVFConfig, Metric, SearchConfig
from vq_tpu_torch.data.sampling import chunk_rows_for_bytes, host_sample_rows
from vq_tpu_torch.index.base import BaseSearchIndex, nbytes_of
from vq_tpu_torch.kernels.kmeans import assign, kmeans, pairwise_sqdist_xc
from vq_tpu_torch.kernels.topk import ordered_topk
from vq_tpu_torch.methods.base import BaseQuantizer, tree_leaves

# Tail padding (rows) past the last cluster, kept for the JAX package's
# layout and footprint; the largest `chunk` scan_probed_lists takes.
_PAD_SLACK = 1024

# Working-buffer budget of the union scan's probed-distance recompute: the
# (Q, slab, D) difference slabs stay under this many bytes (tests shrink it
# to force the slab path at small shapes).
_QRS_SLAB_BYTES = 32 << 20

# Budget of a query block's decode and score buffers, from which
# search_with_scores sizes its query blocks as the JAX package does.
_DECODE_BUDGET_BYTES = 2 << 30


def _take_rows(X, idx, device) -> torch.Tensor:
    """Corpus rows by integer index (a tensor or numpy) → (len(idx), D) f32
    on ``device``.  A tensor corpus gathers on its own device (a card tensor
    is never copied off it, see ``_device.to_device``); a host corpus
    gathers host-side and moves one chunk."""
    if isinstance(X, torch.Tensor):
        return as_f32(X[torch.as_tensor(idx, device=X.device).long()], device)
    idx = idx.cpu().numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
    rows = X[idx]
    if isinstance(rows, torch.Tensor):
        return as_f32(rows, device)
    return as_f32(np.asarray(rows, dtype=np.float32), device)


def chunked_assign(X, centroids: torch.Tensor, chunk: int) -> torch.Tensor:
    """Nearest-centroid assignment streamed in ``chunk``-row slices → (N,)
    int32 on the centroids' device."""
    n = X.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=centroids.device)
    for i0 in range(0, n, chunk):
        i1 = min(i0 + chunk, n)
        out[i0:i1] = assign(as_f32(X[i0:i1], centroids.device), centroids)
    return out


def fit_quantizer_on_residuals(X, assignment, centroids: torch.Tensor,
                               quantizer: BaseQuantizer, cap: int = 200_000,
                               seed: int = 0) -> None:
    """Fit the residual quantizer on a ≤ cap-row sample of coarse residuals,
    the rows drawn with numpy's ``default_rng(seed)`` as the JAX package
    draws them."""
    n = X.shape[0]
    if n <= cap:
        idx = np.arange(n)
    else:
        idx = np.sort(np.random.default_rng(seed).choice(n, cap, replace=False))
    dev = centroids.device
    rows = _take_rows(X, idx, dev)
    asn = to_device(torch.as_tensor(assignment), dev).long()
    quantizer.fit(rows - centroids[asn[torch.as_tensor(idx, device=dev)]])


def encode_rows_ordered(X, order, assignment, centroids: torch.Tensor,
                        quantizer: BaseQuantizer, chunk: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual-encode rows X[order] in ``order`` sequence, ``chunk`` rows at
    a time → (codes (N, ...), norms (N,) f32 of the original rows), both on
    the quantizer's device.  ``order`` and ``assignment`` are integer
    tensors or numpy arrays; row i of the result is X[order[i]] minus its
    centroid centroids[assignment[order[i]]]."""
    dev = quantizer.device
    order = to_device(torch.as_tensor(order), dev).long()
    assignment = to_device(torch.as_tensor(assignment), dev).long()
    enc = quantizer.encode_fn() or quantizer.compress
    n = order.shape[0]
    codes = None
    norms = torch.empty((n,), dtype=torch.float32, device=dev)
    for i0 in range(0, n, chunk):
        idx = order[i0:i0 + chunk]
        rows = _take_rows(X, idx, dev)
        c = enc(rows - centroids[assignment[idx]])
        if codes is None:
            codes = torch.empty((n,) + tuple(c.shape[1:]), dtype=c.dtype, device=dev)
        codes[i0:i0 + idx.shape[0]] = c
        norms[i0:i0 + idx.shape[0]] = torch.linalg.norm(rows, dim=1)
    return codes, norms


def _code_rows(codes, idx):
    """codes[idx] for any code dtype: CUDA has no index kernel for uint16
    (PQ above 256 codewords), so those rows move as int16, the same bytes."""
    if codes.dtype == torch.uint16:
        return codes.view(torch.int16)[idx].view(torch.uint16)
    return codes[idx]


def _fold(run_s, run_i, s, ids, k):
    """Running top-k of [run ‖ window] in ``lax.top_k``'s order."""
    return ordered_topk(torch.cat([run_s, s], dim=1), k,
                        torch.cat([run_i.to(torch.int64), ids.to(torch.int64)], dim=1))


def _empty_topk(num_q, k, device):
    return (torch.full((num_q, k), -np.inf, dtype=torch.float32, device=device),
            torch.zeros((num_q, k), dtype=torch.int32, device=device))


def _masked_ids_to_zero(run_s, run_i):
    """Slots no candidate filled hold −inf with id 0 (the JAX package's
    running top-k keeps its initial ids there)."""
    return run_s, torch.where(run_s > -np.inf, run_i, torch.zeros_like(run_i))


def scan_probed_lists(q, probes, centroids, codes_sorted, ids_sorted, norms_sorted, offsets,
                      sizes, decode_fn, k: int, metric: Metric, chunk: int = 512,
                      scorer_window=None, q_side=None, c_side=None):
    """Scan each (query, probe) pair's list in ``chunk``-row windows →
    maximize-form (scores (Q, k), global ids (Q, k)).

    The loop stops at the largest list this batch probes (one host read);
    peak memory is the (Q, P, chunk) decoded window.  probes (Q, P) int.
    A window slice past a list's end reads (clamped) rows that the size
    mask drops.

    scorer_window + q_side + c_side take the code-space path
    (``methods/base.residual_scorer``): q_side = q_map(queries), c_side =
    q_map(centroids), which the caller computes once per index.  In the
    decode path the IP/NIP score dots r̂ with the FULL query (r̂·q + q·c),
    not the residual query, which would drop the c·r̂ term.
    """
    num_q, p_cnt = probes.shape
    dev = q.device
    probes = probes.long()
    cp = centroids[probes]  # (Q, P, D)
    qr = q[:, None, :] - cp  # residual queries
    qr_sq = torch.sum(qr * qr, dim=-1)  # (Q, P)
    q_cent = torch.einsum("qd,qpd->qp", q, cp)
    starts = offsets.long()[probes]
    szs = sizes.long()[probes]
    max_sz = int(szs.max()) if szs.numel() else 0
    if scorer_window is not None:
        q_cat, q_add = q_side
        c_cat, c_add = c_side
        if metric == Metric.L2:  # v·r̂ for v = q − c_p decomposes through q_map
            qc_cat = q_cat[:, None, :] - c_cat[probes]  # (Q, P, Dc)
            qc_add = q_add[:, None] - c_add[probes]
        else:
            qc_cat = q_cat[:, None, :].expand(-1, p_cnt, -1)
            qc_add = q_add[:, None].expand(-1, p_cnt)
    last = codes_sorted.shape[0] - 1
    lane = torch.arange(chunk, device=dev)
    run_s, run_i = _empty_topk(num_q, k, dev)
    for off in range(0, max_sz, chunk):
        rows = torch.clamp(starts[..., None] + off + lane, max=last)  # (Q, P, chunk)
        flat = rows.reshape(-1)
        ct = _code_rows(codes_sorted, flat)
        if scorer_window is not None:
            ohat, r2 = scorer_window(ct)
            ohat = ohat.reshape(num_q, p_cnt, chunk, -1)
            ip_r = torch.einsum("qpcd,qpd->qpc", ohat, qc_cat) + qc_add[..., None]
            if metric == Metric.L2:
                s = -(qr_sq[..., None] - 2.0 * ip_r + r2.reshape(num_q, p_cnt, chunk))
            elif metric == Metric.IP:
                s = ip_r + q_cent[..., None]
            else:
                nrm = norms_sorted[flat].reshape(num_q, p_cnt, chunk)
                s = (ip_r + q_cent[..., None]) / torch.clamp(nrm, min=1e-30)
        else:
            r_hat = decode_fn(ct).to(torch.float32).reshape(num_q, p_cnt, chunk, -1)
            if metric == Metric.L2:
                ip_r = torch.einsum("qpcd,qpd->qpc", r_hat, qr)
                s = -(qr_sq[..., None] - 2.0 * ip_r + torch.sum(r_hat * r_hat, dim=-1))
            else:
                ip_full = torch.einsum("qpcd,qpd->qpc", r_hat, qr + cp) + q_cent[..., None]
                if metric == Metric.IP:
                    s = ip_full
                else:
                    nrm = norms_sorted[flat].reshape(num_q, p_cnt, chunk)
                    s = ip_full / torch.clamp(nrm, min=1e-30)
        valid = lane < (szs[..., None] - off)
        s = torch.where(valid, s, torch.full_like(s, -np.inf))
        run_s, run_i = _fold(run_s, run_i, s.reshape(num_q, -1),
                             ids_sorted[flat].reshape(num_q, -1), k)
    return _masked_ids_to_zero(run_s, run_i)


def _probed_sqdist(q, centroids, probes):
    """(Q, P) ‖q − c_p‖² from the direct difference, in probe slabs whose
    (Q, slab, D) buffer stays under ``_QRS_SLAB_BYTES``."""
    num_q, num_p = probes.shape
    slab = max(1, int(_QRS_SLAB_BYTES // (4 * num_q * q.shape[1])))
    return torch.cat([torch.sum((q[:, None, :] - centroids[probes[:, j:j + slab]]) ** 2, dim=-1)
                      for j in range(0, num_p, slab)], dim=1)


def scan_union_lists(q, probes, cd, centroids, codes_sorted, ids_sorted, norms_sorted, offsets,
                     sizes, decode_fn, k: int, metric: Metric, chunk: int = 8192,
                     scorer_window=None, q_side=None, c_side=None, q_valid=None):
    """QUERY-SHARED union scan of the probed lists → maximize-form (scores
    (Q, k), global ids (Q, k)).

    The batch walks the concatenation of every list any (valid) query
    probes in ``chunk``-row windows: each window's rows decode once and all
    queries score them in one product; a per-(query, cluster) membership
    mask drops the rows of lists a query did not probe, so each query's
    candidates are exactly its own probed lists.  Window rows are found by
    a binary search of the union's prefix sums.  cd is the (Q, K) routing
    table of squared distances: for L2 its probed entries are recomputed
    from the direct difference (the expansion loses accuracy when norms
    dwarf the distances), in probe slabs; for IP/NIP the q·c table derives
    from it.  Pad queries (``q_valid`` False) add no lists to the union.
    """
    num_q = q.shape[0]
    dev = q.device
    kc = sizes.shape[0]
    probes = probes.long()
    qi = torch.arange(num_q, device=dev)[:, None].expand_as(probes)
    allowed = torch.zeros((num_q, kc), dtype=torch.bool, device=dev)
    allowed[qi, probes] = True
    if q_valid is not None:
        allowed &= q_valid[:, None]
    union = torch.any(allowed, dim=0)
    pref = torch.cumsum(torch.where(union, sizes.long(), torch.zeros_like(sizes.long())), 0)
    total = int(pref[-1])  # the loop bound: one host read
    if scorer_window is not None:
        q_cat, q_add = q_side
        c_cat, c_add = c_side
    if metric == Metric.L2:
        cd = cd.clone()
        cd[qi, probes] = _probed_sqdist(q, centroids, probes)
    else:
        qc = 0.5 * (torch.sum(q * q, dim=1, keepdim=True)
                    + torch.sum(centroids * centroids, dim=1)[None, :] - cd)
    last = codes_sorted.shape[0] - 1
    offs = offsets.long()
    lane = torch.arange(chunk, device=dev)
    run_s, run_i = _empty_topk(num_q, k, dev)
    for w0 in range(0, total, chunk):
        pos = w0 + lane
        kk = torch.clamp(torch.searchsorted(pref, pos, right=True), max=kc - 1)
        prev = torch.where(kk > 0, pref[torch.clamp(kk - 1, min=0)], torch.zeros_like(kk))
        row = torch.clamp(offs[kk] + (pos - prev), max=last)
        ct = _code_rows(codes_sorted, row)
        if scorer_window is not None:
            ohat, r2 = scorer_window(ct)
            ip_q = q_cat @ ohat.T + q_add[:, None]  # q·r̂
            c_dot = torch.sum(c_cat[kk] * ohat, dim=1) + c_add[kk]  # c·r̂
        else:
            r_hat = decode_fn(ct).to(torch.float32)
            r2 = torch.sum(r_hat * r_hat, dim=1)
            ip_q = q @ r_hat.T
            c_dot = torch.sum(centroids[kk] * r_hat, dim=1)
        if metric == Metric.L2:  # ‖q−c−r̂‖² = ‖q−c‖² − 2q·r̂ + 2c·r̂ + ‖r̂‖²
            s = -(cd[:, kk] - 2.0 * ip_q + (2.0 * c_dot + r2)[None, :])
        else:
            s = ip_q + qc[:, kk]
            if metric == Metric.NIP:
                s = s / torch.clamp(norms_sorted[row], min=1e-30)[None, :]
        valid = (pos < total)[None, :] & allowed[:, kk]
        s = torch.where(valid, s, torch.full_like(s, -np.inf))
        run_s, run_i = _fold(run_s, run_i, s, ids_sorted[row].expand(num_q, -1), k)
    return _masked_ids_to_zero(run_s, run_i)


class IvfQuantizedIndex(BaseSearchIndex):
    """IVF over any quantizer of the port, residuals per cluster."""

    name = "ivf"

    def __init__(self, quantizer: BaseQuantizer, ivf_cfg: IVFConfig = IVFConfig(),
                 search_cfg: SearchConfig = SearchConfig()):
        self.quantizer = quantizer
        self.ivf_cfg = ivf_cfg
        self.search_cfg = search_cfg
        self.centroids: Optional[torch.Tensor] = None
        self.codes_sorted: Optional[torch.Tensor] = None
        self.ids_sorted: Optional[torch.Tensor] = None  # (N + pad,) i32, −1 in the pad
        self.norms_sorted: Optional[torch.Tensor] = None
        self.offsets: Optional[torch.Tensor] = None  # (K,) i32 start row of each cluster
        self.sizes: Optional[torch.Tensor] = None  # (K,) i32
        self.max_cluster = 0
        self.num_rows = 0
        self._inv_perm: Optional[torch.Tensor] = None  # global row id → sorted position
        self._assignment: Optional[torch.Tensor] = None
        self._c_side = None  # q_map(centroids), once per index (residual_scorer path)

    @property
    def device(self) -> torch.device:
        return self.quantizer.device

    # ------------------------------------------------------------------ fit
    def fit(self, X, chunk_rows: int = 0, coarse=None) -> "IvfQuantizedIndex":
        """Coarse k-means on a host-side sample (or ``coarse=(centroids,
        assignment)`` computed elsewhere), streamed assignment, the residual
        quantizer fitted on a ≤ 200k-row residual sample (unless it already
        has params), and a streamed encode of the residuals in cluster
        order.  X: numpy / np.memmap (streamed a chunk at a time) or a
        tensor; the index lives on the quantizer's device."""
        n, d = X.shape
        chunk = chunk_rows or chunk_rows_for_bytes(d)
        dev = self.quantizer._bind_device(X)
        kcfg = self.ivf_cfg.kmeans
        if coarse is not None:
            self.centroids = as_f32(coarse[0], dev).contiguous()
            assignment = to_device(torch.as_tensor(coarse[1]), dev).to(torch.int32)
            k = self.centroids.shape[0]
        else:
            k = min(self.ivf_cfg.num_clusters, max(1, n // 2))
            cap = min(n, max(200_000, kcfg.max_points_per_centroid * k))
            xs = as_f32(host_sample_rows(X, cap, kcfg.seed), dev)
            self.centroids = kmeans(make_generator(kcfg.seed, dev), xs, k, kcfg).contiguous()
            del xs
            assignment = chunked_assign(X, self.centroids, chunk)
        if self.quantizer.params is None:
            fit_quantizer_on_residuals(X, assignment, self.centroids, self.quantizer,
                                       seed=kcfg.seed)
        order = torch.argsort(assignment, stable=True)
        sizes = torch.bincount(assignment.long(), minlength=k)
        offsets = torch.cumsum(sizes, 0) - sizes
        codes, norms = encode_rows_ordered(X, order, assignment, self.centroids,
                                           self.quantizer, chunk)
        self.max_cluster = int(sizes.max())
        pad = _PAD_SLACK
        self.codes_sorted = torch.cat([codes, codes.new_zeros((pad,) + tuple(codes.shape[1:]))])
        self.ids_sorted = torch.cat([order.to(torch.int32),
                                     torch.full((pad,), -1, dtype=torch.int32, device=dev)])
        self.norms_sorted = torch.cat([norms, torch.ones((pad,), dtype=torch.float32,
                                                         device=dev)])
        self.offsets = offsets.to(torch.int32)
        self.sizes = sizes.to(torch.int32)
        inv = torch.empty((n,), dtype=torch.int64, device=dev)
        inv[order] = torch.arange(n, device=dev)
        self._inv_perm = inv
        self._assignment = assignment
        self.num_rows = n
        self._c_side = None
        return self

    # --------------------------------------------------------- decompress
    def decompress(self, ids) -> torch.Tensor:
        """Rows by GLOBAL id: residual decode + the row's centroid."""
        if not isinstance(ids, torch.Tensor):
            ids = torch.from_numpy(np.asarray(ids, dtype=np.int64))
        ids = to_device(ids.reshape(-1), self.device).long()
        res = self.quantizer.decompress(_code_rows(self.codes_sorted, self._inv_perm[ids]))
        return res + self.centroids[self._assignment[ids].long()]

    # --------------------------------------------------------------- search
    def _auto_chunk(self, strategy: str) -> int:
        """Window rows a step: union a fixed 4096 (windows are batch-global,
        so the only trade is the decode buffer against the trip count);
        windows the next power of two ≥ the mean list size, in [128, 512]."""
        if strategy == "union":
            return 4096
        k = int(self.sizes.shape[0])
        mean = max(1, self.num_rows // max(1, k))
        return int(np.clip(1 << int(np.ceil(np.log2(mean))), 128, 512))

    def _search_block(self, q, q_valid, k: int, nprobe: int, chunk: int, strategy: str):
        """One query block → (scores (Q, k) in the metric's form, ids)."""
        metric = self.search_cfg.metric
        scorer = self.quantizer.residual_scorer()
        window_fn = q_side = None
        if scorer is not None:
            q_map, window_fn = scorer
            if self._c_side is None:
                self._c_side = q_map(self.centroids)
            q_side = q_map(q)
        cd = pairwise_sqdist_xc(q, self.centroids)
        _, probe = ordered_topk(-cd, nprobe)
        args = (self.centroids, self.codes_sorted, self.ids_sorted, self.norms_sorted,
                self.offsets, self.sizes, self.quantizer.decode_fn(), k, metric)
        if strategy == "union":
            ts, ti = scan_union_lists(q, probe, cd, *args, chunk=chunk, scorer_window=window_fn,
                                      q_side=q_side, c_side=self._c_side, q_valid=q_valid)
        else:
            ts, ti = scan_probed_lists(q, probe, *args, chunk=chunk, scorer_window=window_fn,
                                       q_side=q_side, c_side=self._c_side)
        return (-ts if metric == Metric.L2 else ts), ti

    def search_with_scores(self, queries, k: int = 10, chunk: Optional[int] = None,
                           strategy: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """(nq, D) → ((nq, k) uint32 ids, (nq, k) f32 scores) as numpy.

        strategy: "union" (the default under "auto") decodes each probed
        row once a batch; "windows" scans each (query, probe) pair's list.
        The batch runs in query blocks sized as the JAX package sizes them
        (union: one power-of-two block up to the decode budget; windows: the
        (block, nprobe, chunk) decoded window under the budget), pad queries
        masked out of the union."""
        if strategy == "auto":
            strategy = "union"
        if strategy not in ("union", "windows"):
            raise ValueError(f"strategy {strategy!r}")
        nprobe = min(self.ivf_cfg.nprobe, int(self.centroids.shape[0]))
        q = as_f32(queries, self.device)
        nq = q.shape[0]
        if chunk is None:
            chunk = self._auto_chunk(strategy)
        if strategy == "windows" and chunk > _PAD_SLACK:
            raise ValueError(f"windows chunk {chunk} > {_PAD_SLACK}")
        if strategy == "union":
            kc = int(self.sizes.shape[0])
            cap_rows = max(16, _DECODE_BUDGET_BYTES // (4 * (kc + 2 * chunk)))
            cap = 1 << int(np.log2(cap_rows))
            query_block = min(max(16, 1 << int(np.ceil(np.log2(max(1, nq))))), cap)
        else:
            d = int(self.centroids.shape[1])
            rows = max(1, _DECODE_BUDGET_BYTES // (4 * d * nprobe * chunk))
            query_block = int(np.clip(1 << int(np.log2(rows)), 1, 256))
        pad = (-nq) % query_block
        if pad:
            q = torch.cat([q, q.new_zeros((pad, q.shape[1]))])
        valid = torch.arange(q.shape[0], device=q.device) < nq
        outs = [self._search_block(q[b0:b0 + query_block], valid[b0:b0 + query_block], k,
                                   nprobe, chunk, strategy)
                for b0 in range(0, q.shape[0], query_block)]
        scores = torch.cat([o[0] for o in outs])[:nq].cpu().numpy()
        ids = torch.cat([o[1] for o in outs])[:nq].cpu().numpy()
        return np.where(ids < 0, 0, ids).astype(np.uint32), scores

    # ---------------------------------------------------------------- misc
    def memory_footprint(self) -> int:
        """Codes, ids and norms with their padding, centroids, offsets, sizes
        and the quantizer's params, in bytes."""
        arrays = (self.codes_sorted, self.ids_sorted, self.norms_sorted, self.centroids,
                  self.offsets, self.sizes)
        return (sum(nbytes_of(a) for a in arrays)
                + sum(nbytes_of(p) for p in tree_leaves(self.quantizer.params)))

    def reconstruction_mse(self, X, sample: Optional[int] = 10000) -> float:
        xs = as_f32(X[: sample or len(X)], self.device)
        res = xs - self.centroids[assign(xs, self.centroids).long()]
        rec = self.quantizer.decompress(self.quantizer.compress(res))
        return float(torch.mean((res - rec) ** 2))

    # ------------------------------------------------------------ save/load
    def _state(self) -> dict:
        def h(t):
            return t.cpu().numpy()

        return {
            "centroids": h(self.centroids), "codes_sorted": h(self.codes_sorted),
            "ids_sorted": h(self.ids_sorted), "norms_sorted": h(self.norms_sorted),
            "offsets": h(self.offsets), "sizes": h(self.sizes),
            "max_cluster": self.max_cluster, "num_rows": self.num_rows,
            "ivf_cfg": self.ivf_cfg, "search_cfg": self.search_cfg,
            "quantizer": pickle.dumps(self.quantizer),
            "inv_perm": h(self._inv_perm), "assignment": h(self._assignment),
        }

    def _restore(self, state: dict) -> None:
        self.quantizer = pickle.loads(state["quantizer"])
        dev = self.device
        for name in ("centroids", "codes_sorted", "ids_sorted", "norms_sorted", "offsets",
                     "sizes"):
            setattr(self, name, torch.as_tensor(state[name], device=dev))
        self._inv_perm = torch.as_tensor(state["inv_perm"], device=dev)
        self._assignment = torch.as_tensor(state["assignment"], device=dev)
        self.max_cluster = state["max_cluster"]
        self.num_rows = state["num_rows"]
        self.ivf_cfg = state["ivf_cfg"]
        self.search_cfg = state["search_cfg"]
        self._c_side = None
