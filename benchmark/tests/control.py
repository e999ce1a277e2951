"""The control of each cell's comparison, and the faults it must catch.

The control puts a lower precision in the program's place and runs the
cell's own path, so its numbers come out of the same comparison as a run's.
The workload file names it under `control`:

  * a strict cell: the program's own int8-boundary rung (1-byte carries
    where the configuration states int32 ones), {"engine": {"int8_boundary":
    true}};
  * an int8-boundary cell: the plain reference with every 8-bit operand
    and weight kept to its 4 high bits (int4 for int8), as the engine,
    {"reference": {"operand_bits": 4}}.

A fault leaves the program as it is and alters one answer where it is
produced: logit [0, 0] of every batch the engine returns, plus one.

    python3 -m benchmark.tests.control <cell> <seed> [<seed> ...]

runs the control at the cell's own size, on the card (a short window at
the cell's own load), and prints the compared numbers of each seed."""

from __future__ import annotations

import contextlib
import json
import sys
import time

import torch

from benchmark.harness import program
from benchmark.reference import IntNet

CONTROL_SECONDS = 3.0


class ReferenceEngine:
    """The plain reference, called as the program's engine is."""

    def __init__(self, net: IntNet, device):
        self.net, self.device = net, torch.device(device)

    def __call__(self, x):
        return self.net.logits(x.to(self.device))


class AlteredEngine:
    """The program's engine with one answer altered where it is produced."""

    def __init__(self, eng):
        self.eng, self.device = eng, eng.device

    def __call__(self, x):
        y = self.eng(x).clone()
        y[0, 0] += 1.0
        return y


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def control(workload: dict):
    """The context in which a cell's path runs its control, as the workload
    file's `control` names it: {"engine": options} runs the program with
    those IntEngine options in place of the cell's; {"reference": options}
    puts the plain reference, built with those options, in the program's
    place."""
    spec = workload["control"]
    if "engine" in spec:
        real = program.engine

        def engine(cfg, records, params, options, device):
            return real(cfg, records, params, spec["engine"], device)

        return patched(program, "engine", engine)
    if "reference" in spec:
        def engine(cfg, records, params, options, device):
            plan = {r[0]: r[1:] for r in records}
            return ReferenceEngine(IntNet(cfg, params, plan, workload["rung"],
                                          **spec["reference"]), device)

        return patched(program, "engine", engine)
    raise NotImplementedError(f"no control of the kind {sorted(spec)}")


def fault():
    real = program.engine

    def engine(*args, **kw):
        return AlteredEngine(real(*args, **kw))

    return patched(program, "engine", engine)


def readings(res: dict) -> dict:
    return {c.name: c.value for c in res["checks"]}


def main(argv) -> int:
    from benchmark import manifest, run

    if not torch.cuda.is_available():
        print("the control runs at the cell's size on the card; no CUDA device found",
              file=sys.stderr)
        return 2
    name, seeds = argv[0], [int(s) for s in argv[1:]]
    cell = manifest.load_cell(name)
    for seed in seeds:
        t0 = time.perf_counter()
        with control(cell.workload):
            res = run.run_cell(cell, seed, CONTROL_SECONDS, False, "cuda", t0)
        print(json.dumps({"control": name, "seed": seed, "correct": res["correct"],
                          "readings": readings(res), "card": torch.cuda.get_device_name(0),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
