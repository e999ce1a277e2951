"""On the card, at each cell's own size: a short run is correct, and the
control, on three seeds, is not (its readings set the upper end of each
limit; PERF.md keeps them).  Skips without a card.

    python3 -m pytest benchmark/tests -q -m cuda
"""

import json
import time

import pytest

from benchmark import manifest, run
from benchmark.tests import control

BENCH = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = (2**40 + 101, 2**40 + 103, 2**40 + 107)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct_on_the_card(card, cell):
    c = manifest.load_cell(cell)
    res = run.run_cell(c, SEEDS[0], 2.0, False, card, time.perf_counter())
    assert res["correct"], control.readings(res)
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(card, cell):
    c = manifest.load_cell(cell)
    for seed in SEEDS:
        with control.control(c.workload):
            res = run.run_cell(c, seed, control.CONTROL_SECONDS, False, card,
                               time.perf_counter())
        r = control.readings(res)
        print(json.dumps({"control": cell, "seed": seed, "readings": r}))
        assert not res["correct"] and r["logits_differing"] > 0
