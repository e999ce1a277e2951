"""Serving: the cell's rung of IntEngine behind the port's ServingEngine
(buckets, ingestion ring, max_wait_ms as the workload file sets them), fed
by an open loop of independent clients (the mix's generator, traffic/).  A generator
thread sends each request at its due time; a request's latency runs from
its due time to the moment its logits reach its future, so a late send or a
queue that grows counts.  latency_p95_ms is the 95th percentile (nearest
rank) over every request due in the window; a request that fails or is not
answered within WAIT_S of the window's close counts with the latency it had
reached then.

After the window the logits of every answered request are compared with
the plain reference on the request's images."""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import math
import threading
import time

import numpy as np
import torch

from ..harness import checks as chk, program, trace as tr, weights
from ..reference import IntNet
from .. import traffic
from . import Outcome

WAIT_S = 60.0  # how long past the window's close a request may still come
TRACE_S = 2.0  # seconds of the same traffic under the profiler (--trace 1)


@dataclasses.dataclass
class Driven:
    t0: float
    sched: traffic.Schedule
    sent: np.ndarray
    done: np.ndarray
    futures: list

    def answered(self, k: int) -> bool:
        f = self.futures[k]
        return f is not None and f.done() and f.exception() is None and not math.isnan(
            self.done[k])

    def latencies_ms(self) -> np.ndarray:
        """Every request's latency; an unanswered one's as of the wait's end."""
        due = self.t0 + self.sched.due
        end = np.where([self.answered(k) for k in range(len(due))], self.done,
                       self.t0 + self.sched.seconds + WAIT_S)
        return (end - due) * 1e3

    def send_lag_ms(self) -> np.ndarray:
        return (self.sent - (self.t0 + self.sched.due)) * 1e3


def p95(values) -> float:
    v = np.sort(np.asarray(values, dtype=np.float64))
    return float(v[max(math.ceil(0.95 * len(v)) - 1, 0)])


def drive(srv, pool: np.ndarray, sched: traffic.Schedule) -> Driven:
    """Sends the schedule from a generator thread and waits for every
    request, at most WAIT_S past the window's close."""
    n = len(sched.due)
    sent, done, futures = np.full(n, np.nan), np.full(n, np.nan), [None] * n
    t0 = time.perf_counter() + 0.02

    def stamp(k):
        return lambda _: done.__setitem__(k, time.perf_counter())

    def generate():
        for k in range(n):
            wait = t0 + sched.due[k] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            sent[k] = time.perf_counter()
            s, m = int(sched.start[k]), int(sched.size[k])
            fut = srv.submit(pool[s: s + m])
            futures[k] = fut
            fut.add_done_callback(stamp(k))

    th = threading.Thread(target=generate, name="load-generator", daemon=True)
    th.start()
    th.join(timeout=sched.seconds + WAIT_S)
    deadline = t0 + sched.seconds + WAIT_S
    cf.wait([f for f in futures if f is not None],
            timeout=max(deadline - time.perf_counter(), 0.0))
    return Driven(t0, sched, sent, done, futures)


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in ("batches", "images", "padded")}


def setup(cell, seed, device):
    """(server, its engine, host pool, device pool, plan records, params)."""
    cfg, mix, wl = cell.config, cell.mix, cell.workload
    pool_t = traffic.load(mix).pool(mix, cfg["image_size"], seed, device)
    records, params = weights.make_plan(cfg, seed, pool_t[: cfg["quant"]["calib_images"]])
    eng = program.engine(cfg, records, params, wl["engine"], device)
    program.build_kernels(device)
    pool = pool_t.cpu().numpy()
    srv = program.server(eng, wl["server"], cfg["image_size"])
    for _ in range(2):  # every bucket's shape, through the ring, twice
        for b in wl["server"]["buckets"]:
            srv.infer(pool[:b], timeout=600.0)
    return srv, eng, pool, pool_t, records, params


def run(cell, seed, seconds, trace, device, t_start) -> Outcome:
    cfg, wl = cell.config, cell.workload
    cuda = torch.device(device).type == "cuda"
    srv, eng, pool, pool_t, records, params = setup(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    chk.log(t_start, f"set-up done: {setup_s:.3f} s")

    before = dict(srv.stats)
    gen = traffic.load(cell.mix)
    d = drive(srv, pool, gen.schedule(cell.mix, seed, seconds))
    stats = delta(srv.stats, before)
    lat = d.latencies_ms()
    chk.log(t_start, f"window: {len(lat)} requests, {stats}, p95 {p95(lat):.3f} ms")
    readings = {"stats": stats, "send_lag_ms": d.send_lag_ms()}
    runs = [d]
    stretch = None
    if trace:
        def profiled():
            runs.append(drive(srv, pool, gen.schedule(cell.mix, seed, TRACE_S, "trace")))
            return len(runs[-1].futures)

        stretch = tr.profile(profiled, device)
        # the served stretch runs from the first request's due time to the
        # last answer: the generator's lead-in and the profiler's close are
        # the harness's own idle time, not the server's
        last = runs[-1]
        stretch.wall_s = float(np.nanmax(last.done) - last.t0)
    srv.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del srv, eng
    if cuda:
        torch.cuda.empty_cache()

    ref = IntNet(cfg, params, {r[0]: r[1:] for r in records}, wl["rung"])
    want = ref.logits(pool_t).cpu()
    pairs, unanswered = [], 0
    for r in runs:
        for k, fut in enumerate(r.futures):
            if not r.answered(k):
                unanswered += 1
                continue
            s, m = int(r.sched.start[k]), int(r.sched.size[k])
            pairs.append((torch.from_numpy(np.asarray(fut.result())), want[s: s + m]))
    found, n = chk.logit_checks(pairs)
    chk.log(t_start, f"reference: {len(pool_t)} pool images, {n} requests compared")
    checks = [chk.Check("requests_unanswered", unanswered, "<=", 0)] + found + [
        chk.Check("requests_compared", n, ">=", 1)] + chk.share_checks(ref, cfg["quant"])
    failed = sum(not d.answered(k) for k in range(len(d.futures)))
    return Outcome({"setup_s": setup_s, "latency_p95_ms": p95(lat)}, readings, checks,
                   attempted=len(d.futures), failed=failed, memory_peak_bytes=peak,
                   stretch=stretch)
