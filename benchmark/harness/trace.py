"""A stretch of the run under torch.profiler, reduced to what the per-layer
metrics read: each device operation's name and interval, the union of those
intervals (device busy), the stretch's wall time on the host clock, and the
host operation under each idle gap.  The port's kernels carry `f8::` in
their names (every csrc/*.cu kernel lives in namespace f8); every other
device operation is glue or a copy."""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, List, Tuple

import torch

PORT_TAG = "f8::"


@dataclasses.dataclass
class Stretch:
    wall_s: float  # host clock, from the stretch's start to its closing synchronize
    # (the serve path narrows it to its first due request and last answer)
    units: int  # forwards, requests or steps the stretch ran
    device_ops: List[Tuple[str, float, float]]  # (name, start us, end us)
    host_ops: List[Tuple[str, float, float]]

    @property
    def busy_s(self) -> float:
        return union_us([(a, b) for _, a, b in self.device_ops]) / 1e6

    def device_s(self, port: bool) -> float:
        """Summed device seconds of the port's kernels (port=True) or of
        every other device operation."""
        return sum(b - a for n, a, b in self.device_ops if (PORT_TAG in n) == port) / 1e6

    def top_ops(self, n: int = 10) -> list:
        tot = {}
        for name, a, b in self.device_ops:
            key = short(name)
            tot[key] = tot.get(key, 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle seconds between device operations, summed by the innermost
        (shortest) host operation running at each gap's midpoint: one sweep
        over the gaps in time order with a heap of the host operations
        begun by then, keyed by duration."""
        spans = merged([(a, b) for _, a, b in self.device_ops])
        gaps = [((end + start) / 2, (start - end) / 1e6)
                for (_, end), (start, _) in zip(spans, spans[1:])]
        host = sorted(self.host_ops, key=lambda e: e[1])
        active, i, tot = [], 0, {}
        for mid, secs in gaps:
            while i < len(host) and host[i][1] <= mid:
                name, a, b = host[i]
                heapq.heappush(active, (b - a, b, name))
                i += 1
            while active and active[0][1] < mid:
                heapq.heappop(active)
            key = short(active[0][2]) if active else "host (no profiled op)"
            tot[key] = tot.get(key, 0.0) + secs
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]


def short(name: str, width: int = 90) -> str:
    """A kernel's or an operation's name without its return type, its
    namespaces' boilerplate and its argument list, cut to `width`."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::", "at::cuda::"):
        name = name.replace(junk, "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    name = name[:cut].strip()
    return name if len(name) <= width else name[: width - 3] + "..."


def merged(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_us(spans) -> float:
    return sum(b - a for a, b in merged(spans))


def profile(run: Callable[[], int], device) -> Stretch:
    """Runs `run()` (which returns how many units it ran) under the
    profiler, closes with a synchronize, and reduces the trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        units = run()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(span)
        else:
            host.append(span)
    return Stretch(wall, units, dev, host)
