"""Scalar meters (copy of `f8net_tpu/utils/meters.py`, myutils/meters.py
parity): cache per-batch values, flush to 3-decimal reductions each epoch."""

from __future__ import annotations

from typing import Dict, Iterable, List


class ScalarMeter:
    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def cache(self, value: float):
        self.values.append(float(value))

    def cache_list(self, values: Iterable[float]):
        self.values.extend(float(v) for v in values)

    def flush(self, reduction: str = "avg") -> float:
        if not self.values:
            return 0.0
        if reduction == "avg":
            out = sum(self.values) / len(self.values)
        elif reduction == "sum":
            out = sum(self.values)
        elif reduction == "max":
            out = max(self.values)
        elif reduction == "min":
            out = min(self.values)
        else:
            raise NotImplementedError(reduction)
        self.values = []
        return round(out, 3)


def flush_scalar_meters(meters: Dict[str, ScalarMeter], reduction: str = "avg") -> Dict[str, float]:
    return {name: m.flush(reduction) for name, m in meters.items()}
