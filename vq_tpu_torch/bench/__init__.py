from vq_tpu_torch.bench.registry import build_quantizer, ALL_METHODS, largest_divisor_leq, bpd_to_pq_m

__all__ = ["build_quantizer", "ALL_METHODS", "largest_divisor_leq", "bpd_to_pq_m"]
