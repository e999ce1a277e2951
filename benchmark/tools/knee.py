#!/usr/bin/env python3
"""Sweep of offered load for a serving cell, to find its knee once: the
highest rate the server sustains without a growing backlog.  The cell's
rate is then fixed in its traffic mix at about 0.8 of it.

    python3 benchmark/tools/knee.py --workload <serve cell> --seed <n> \
        --seconds 20 --rates 200,260,320

One process: the cell's server is set up once and driven at each rate in
turn with the mix's traffic at that rate.  Prints one JSON line per rate:
offered and completed images/s, the device rows (images and padding) per
second, p50/p95/p99 latency, how late the generator ran, and the mean
latency of the last quarter of requests over that of the first.  A rate is
`sustained` where every request is answered and that ratio stays at or
under BACKLOG: a backlog that grows through the window reads above it."""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path[0] = str(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.manifest import load_cell  # noqa: E402
from benchmark.paths import serve  # noqa: E402
from benchmark import traffic  # noqa: E402

BACKLOG = 1.05


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", required=True, help="requests per second, comma-separated")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("the sweep measures the card; no CUDA device found", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    srv, _, pool, *_ = serve.setup(cell, args.seed, "cuda")
    gen = traffic.load(cell.mix)
    mean_images = (cell.mix["images_min"] + cell.mix["images_max"]) / 2
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            mix = dict(cell.mix, rate_rps=rate)
            before = dict(srv.stats)
            d = serve.drive(srv, pool, gen.schedule(mix, args.seed, args.seconds))
            stats = serve.delta(srv.stats, before)
            lat = d.latencies_ms()
            done = np.array([d.answered(k) for k in range(len(lat))])
            q = max(len(lat) // 4, 1)
            span = np.nanmax(d.done) - d.t0 if done.any() else float("nan")
            completed = float(d.sched.size[done].sum() / span)
            growth = float(lat[-q:].mean() / lat[:q].mean())
            print(json.dumps({
                "rate_rps": rate, "offered_images_per_s": rate * mean_images,
                "completed_images_per_s": completed,
                "device_rows_per_s": (stats["images"] + stats["padded"]) / span,
                "padded_row_share": stats["padded"] / max(stats["images"] + stats["padded"], 1),
                "unanswered": int((~done).sum()),
                "p50_ms": float(np.percentile(lat, 50)), "p95_ms": serve.p95(lat),
                "p99_ms": float(np.percentile(lat, 99)),
                "send_lag_p95_ms": serve.p95(d.send_lag_ms()),
                "last_over_first_quarter": growth,
                "sustained": bool(done.all() and growth <= BACKLOG),
                "card": torch.cuda.get_device_name(0),
            }), flush=True)
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
