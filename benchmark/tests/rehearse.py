"""A CPU rehearsal of a cell at a small size, through the same run as on
the card (run.run_cell with device "cpu"): the tests' way into the harness.

    python3 -m benchmark.tests.rehearse <cell> [seed] [trace]

prints the result line and, last, the loaded modules of JAX or the JAX
package (none, if the run is clean)."""

from __future__ import annotations

import json
import sys
import time

SMALL = {
    "offline": {"config": {"image_size": 32}, "traffic": {"batch": 4, "distinct_batches": 2}},
    "serve": {"config": {"image_size": 32},
              "traffic": {"rate_rps": 8.0, "pool_images": 16},
              "workload": {"server": {"buckets": [2, 4, 8], "max_wait_ms": 5.0,
                                      "ring_capacity": 16}}},
}
SECONDS = 1.0


def rehearse(name: str, seed: int = 7, trace: bool = False, seconds: float = SECONDS,
             base=None) -> dict:
    import torch

    from benchmark import manifest, run

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    kw = {} if base is None else {"base": base}
    wl = json.loads(((base or manifest.HERE) / "workloads" / f"{name}.json").read_text())
    cell = manifest.load_cell(name, SMALL[wl["path"]], **kw)
    return run.run_cell(cell, seed, seconds, trace, "cpu", t0)


if __name__ == "__main__":
    from benchmark import run
    from benchmark.harness import checks as chk

    args = sys.argv[1:]
    res = rehearse(args[0], int(args[1]) if len(args) > 1 else 7,
                   bool(int(args[2])) if len(args) > 2 else False)
    print(chk.result_line(res["correct"], res["attempted"], res["failed"], res["metrics"],
                          res["device"], res["breakdown"], res["checks"]))
    print(json.dumps({"forbidden_modules": run.forbidden_modules()}))
