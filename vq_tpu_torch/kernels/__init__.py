"""Compute of the port: ADC scan and top-k, k-means, and the hand-written
CUDA kernels (``csrc/``) behind ``pq_scan``."""
