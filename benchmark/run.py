#!/usr/bin/env python3
"""Benchmark of f8net_tpu_torch on NVIDIA H100s.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One run is one process: it makes the cell's
inputs, weights and plan from the seed on the card, builds the port's
engine through its public entry, warms up every shape the cell uses
(set-up, timed from the process's start as setup_s), measures for
`--seconds`, compares what the timed path produced with the plain
reference (benchmark/reference/), and prints one JSON line: with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics (a profiled stretch follows the unprofiled window).  The numbers
compared come last, beside their limits, on standard error and under the
line's `checks` key.

Exits 2 and prints no result without as many CUDA cards as the cell asks
for, and 3 if JAX or the JAX package was loaded into the process."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)  # the package is imported as `benchmark`, from the root
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "f8net_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (the part before the first dot),
    compared whole, is JAX's, Flax's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of `cell` on `device`: the parts of the result line (the CPU
    runs this too, at a rehearsal's small size, for the tests)."""
    import torch

    from benchmark.manifest import load_reader

    path = importlib.import_module(f"benchmark.paths.{cell.workload['path']}")
    out = path.run(cell, seed, seconds, trace, device, t_start)
    cuda = torch.device(device).type == "cuda"
    unit = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        readings = dict(out.readings, stretch=out.stretch, **out.end_to_end)
        metrics = {}
        for m in cell.per_layer:
            v = load_reader(m["name"]).read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": unit[m["name"]]}
    else:
        metrics = {m["name"]: {"value": float(out.end_to_end[m["name"]]), "unit": unit[m["name"]]}
                   for m in cell.end_to_end}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": int(cell.workload["chips"]) if cuda else 0,
        "memory_peak_bytes": int(out.memory_peak_bytes),
    }
    breakdown = None
    if trace and out.stretch is not None:
        device_info["busy_s"] = out.stretch.busy_s
        device_info["window_s"] = out.stretch.wall_s
        breakdown = {"device_ops": out.stretch.top_ops(), "idle_gaps": out.stretch.idle_gaps()}
    return {"correct": all(c.ok for c in out.checks), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device_info,
            "breakdown": breakdown, "checks": out.checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.harness import checks as chk
    from benchmark.manifest import load_cell

    cell = load_cell(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print("modules of JAX or the JAX package were loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    chk.print_checks(res["checks"])
    print(chk.result_line(res["correct"], res["attempted"], res["failed"], res["metrics"],
                          res["device"], res["breakdown"], res["checks"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
