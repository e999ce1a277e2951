"""One driver per path (`offline`, `serve`), named by a cell's `path`.
Each exposes run(cell, seed, seconds, trace, device, t_start) -> Outcome."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Outcome:
    end_to_end: dict  # {metric: value} of the unprofiled window, setup_s included
    readings: dict  # what the per-layer readers read (see metrics/)
    checks: list  # harness.checks.Check
    attempted: int
    failed: int
    memory_peak_bytes: int
    stretch: Optional[object] = None  # harness.trace.Stretch of a --trace 1 run
