"""Plain PyTorch reference of the integer networks the benchmark runs.  It
imports nothing of the measured program (f8net_tpu_torch) and nothing of
the JAX package; it reads only the configuration's layer table (walked by
benchmark/families/), the rung's carry rule (rungs/) and the weights and
plan that the benchmark made from the seed."""

from .intnet import IntNet, requant

__all__ = ["IntNet", "requant"]
