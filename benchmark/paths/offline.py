"""Offline scoring: the cell's rung of IntEngine on `distinct_batches`
batches made on the device, dispatched back to back for the window (closed
loop: the host keeps at most LEAD forwards in flight), the window closing on
a synchronize.  images_per_s = images of every forward dispatched in the
window over the window's wall time.

A reservoir of SAMPLE forwards drawn from the seed (their logits copied as
they come) and the last forward are compared with the plain reference once
the window has closed and the program is freed."""

from __future__ import annotations

import collections
import math
import time

import numpy as np
import torch

from ..harness import checks as chk, counts, program, trace as tr, weights
from ..harness.weights import sub_seed
from ..reference import IntNet
from .. import traffic
from . import Outcome

LEAD = 2  # forwards in flight
SAMPLE = 12  # forwards compared, besides the last
ENQUEUE_S = 0.25  # host seconds of enqueue the entry's reading sums
PROFILED_S = 0.5  # device seconds of forwards under the profiler


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Reservoir:
    """A uniform sample of `k` forwards' outputs, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.items = k, []
        self.rng = np.random.default_rng(sub_seed(seed, "sample"))

    def offer(self, i: int, which: int, y: torch.Tensor) -> None:
        if len(self.items) < self.k:
            self.items.append((i, which, y.clone()))
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.items[j] = (i, which, y.clone())


def run(cell, seed, seconds, trace, device, t_start) -> Outcome:
    cfg, mix, wl = cell.config, cell.mix, cell.workload
    cuda = torch.device(device).type == "cuda"
    gen = traffic.load(mix)
    batches = gen.make(mix, cfg["image_size"], seed, device)
    records, params = weights.make_plan(cfg, seed, batches[0][: cfg["quant"]["calib_images"]])
    chk.log(t_start, "inputs, weights and plan made")
    eng = program.engine(cfg, records, params, wl["engine"], device)
    program.build_kernels(device)
    chk.log(t_start, "engine built, kernels loaded")
    for _ in range(2):  # every shape of the window, twice: kernels built, loaded, planned
        for b in batches:
            eng(b)
    sync(device)
    setup_s = time.perf_counter() - t_start
    chk.log(t_start, f"set-up done: {setup_s:.3f} s")

    n_b, size = len(batches), int(mix["batch"])
    sample, inflight, i = Reservoir(SAMPLE, seed), collections.deque(), 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        y = eng(batches[i % n_b])
        sample.offer(i, i % n_b, y)
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
            if len(inflight) > LEAD:
                inflight.popleft().synchronize()
        i += 1
    sync(device)
    window_s = time.perf_counter() - t0
    last = (i - 1, (i - 1) % n_b, y)
    rate = i * size / window_s
    readings = {"images_per_s": rate}
    chk.log(t_start, f"window: {i} forwards in {window_s:.3f} s, {rate:.1f} images/s")

    stretch = None
    if trace:
        readings["enqueue_ms"] = enqueue_ms(eng, batches[0], device)
        n_prof = max(3, min(400, math.ceil(PROFILED_S * rate / size)))

        def profiled():
            for k in range(n_prof):
                eng(batches[k % n_b])
            return n_prof

        stretch = tr.profile(profiled, device)
        readings.update(
            macs_per_image=counts.macs(cfg, cfg["image_size"]),
            bound_s_per_forward=counts.bound_s(cfg, cfg["image_size"], size),
            on_card=cuda)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del eng, y, batches
    if cuda:
        torch.cuda.empty_cache()

    ref = IntNet(cfg, params, {r[0]: r[1:] for r in records}, wl["rung"])
    kept = sample.items + ([last] if last[0] not in {k[0] for k in sample.items} else [])
    batches = gen.make(mix, cfg["image_size"], seed, device)  # made anew: the same
    want = {b: ref.logits(batches[b]) for b in sorted({k[1] for k in kept})}
    found, n = chk.logit_checks((y, want[b]) for _, b, y in kept)
    chk.log(t_start, f"reference: {len(want)} batches, {n} forwards compared")
    checks = found + [chk.Check("forwards_compared", n, ">=", 2)] + chk.share_checks(
        ref, cfg["quant"])
    return Outcome({"setup_s": setup_s, "images_per_s": rate}, readings, checks,
                   attempted=i * size, failed=0, memory_peak_bytes=peak, stretch=stretch)


def enqueue_ms(eng, batch, device) -> float:
    """Host ms from the call of a forward to its return, the card idle
    before each call; calls until their sum reaches ENQUEUE_S (at least 5,
    at most 200)."""
    total, n = 0.0, 0
    while (total < ENQUEUE_S or n < 5) and n < 200:
        sync(device)
        a = time.perf_counter()
        eng(batch)
        total += time.perf_counter() - a
        n += 1
    sync(device)
    return total / n * 1e3
