"""Quantization methods of the port (PQ so far)."""
