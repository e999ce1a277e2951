"""Benchmark of f8net_tpu_torch on one NVIDIA H100 (see README.md)."""
