"""Scan observability: effective-bandwidth / effective-FLOPs counters —
counterpart of ``vq_tpu/utils/profiling.py``.

Parity with the SAQ engine's QueryRuntimeMetrics (reference
external/saq/include/saq/caq_estimator.h:33-37, saq_searcher.h:157-165:
fast_bitsum / acc_bitsum / total_comp_cnt — bits actually scanned per
stage).  The scan is dense, so the counters are exact functions of the
scan geometry; combined with a measured wall time they give effective
memory bandwidth and operation rates per scan — the numbers that say how
far from speed-of-light a kernel is.
"""

from __future__ import annotations

from dataclasses import dataclass

from vq_tpu_torch.kernels.packed_scan import TILE


@dataclass(frozen=True)
class ScanStats:
    """Static cost model of one fused ADC scan."""

    num_rows: int
    num_queries: int
    dim: int
    code_bytes_per_row: float
    codebook_entries: int = 256  # K per subquantizer (PQ family)

    @property
    def bytes_scanned(self) -> float:
        """HBM traffic for the corpus codes (the quantity the reference
        counts as bits scanned)."""
        return self.num_rows * self.code_bytes_per_row

    @property
    def decode_flops(self) -> float:
        """One-hot × codebook decode: N·K·D MACs."""
        return 2.0 * self.num_rows * self.codebook_entries * self.dim

    @property
    def score_flops(self) -> float:
        """Q·x̂ᵀ scoring: Q·N·D MACs."""
        return 2.0 * self.num_queries * self.num_rows * self.dim

    @property
    def total_flops(self) -> float:
        return self.decode_flops + self.score_flops

    def report(self, wall_seconds: float) -> dict:
        """Effective rates for a measured scan time."""
        w = max(wall_seconds, 1e-12)
        return {
            "rows_scanned": self.num_rows,
            "bytes_scanned": self.bytes_scanned,
            "effective_code_bandwidth_gbps": self.bytes_scanned / w / 1e9,
            "effective_tflops": self.total_flops / w / 1e12,
            "qps": self.num_queries / w,
            "rows_per_s": self.num_rows * self.num_queries / w,
        }

    def report_staged(
        self, wall_seconds: float, tiles_scanned: int, tiles_total: int,
        tile: int = TILE,
    ) -> dict:
        """Per-stage counters for a variance-pruned packed scan — the
        direct QueryRuntimeMetrics analog (fast_bitsum / acc_bitsum /
        total_comp_cnt): stage 1 touches only the (3,) f32 tile stats of
        every tile (fast_bitsum); stage 2 unpacks/dequantizes/scores the
        codes of the tiles that survived (acc_bitsum, total_comp_cnt).
        `tiles_scanned` / `tiles_total` are the packed scan's third output
        and ``packed_scan.prune_units`` (tiles in the plain twin, (query
        block, tile) pairs on the card); ``tile`` defaults to the port's
        packed tile, ``kernels/packed_scan.TILE`` (512 rows, as the TPU
        layout's).
        """
        frac = tiles_scanned / max(tiles_total, 1)
        rows_scored = tiles_scanned * tile
        out = self.report(wall_seconds)
        out.update(
            fast_bitsum=tiles_total * 3 * 32,
            acc_bitsum=int(frac * self.bytes_scanned * 8),
            total_comp_cnt=rows_scored * self.num_queries,
            tiles_scanned=tiles_scanned,
            tiles_total=tiles_total,
            scan_fraction=frac,
        )
        return out
