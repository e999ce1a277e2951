"""The numbers a run compares, each beside its limit, and the result line."""

from __future__ import annotations

import dataclasses
import json
import time
import sys

OPS = {"<=": lambda v, lim: v <= lim, ">=": lambda v, lim: v >= lim}


@dataclasses.dataclass
class Check:
    name: str
    value: float
    op: str  # "<=" or ">="
    limit: float

    @property
    def ok(self) -> bool:
        return OPS[self.op](self.value, self.limit)


def result_line(correct, attempted, failed, metrics, device, breakdown, checks) -> str:
    """The run's last line of standard output; `checks` comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "op": c.op, "limit": c.limit} for c in checks}
    return json.dumps(out)


def print_checks(checks) -> None:
    """The run's last lines of standard error: each number compared beside
    its limit."""
    for c in checks:
        print(f"check {c.name} = {c.value!r} (limit {c.op} {c.limit!r}): "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)


def share_checks(ref, quant: dict) -> list:
    """The plan's guard, as the configuration states it: no 8-bit operand
    clamps on `max_clamp_share` or more of its values, none is zero on
    `max_zero_share` or more (the reference's largest shares)."""
    return [Check("operand_clamp_share", ref.clamped, "<=", quant["max_clamp_share"]),
            Check("operand_zero_share", ref.zero, "<=", quant["max_zero_share"])]


def logit_checks(pairs) -> list:
    """Exact comparison of (program logits, reference logits) pairs: how
    many logits differ and by how much at most; both limits are 0."""
    differ, gap, n = 0, 0.0, 0
    for got, want in pairs:
        got = got.to(want.device, want.dtype)
        d = (got - want).abs()
        differ += int((got != want).sum())
        gap = max(gap, float(d.max())) if d.numel() else gap
        n += 1
    return [Check("logits_differing", differ, "<=", 0), Check("max_logit_gap", gap, "<=", 0.0)], n


def log(t_start: float, *parts) -> None:
    """A progress line on standard error, with the seconds since start."""
    print(f"[{time.perf_counter() - t_start:8.2f} s]", *parts, file=sys.stderr, flush=True)
