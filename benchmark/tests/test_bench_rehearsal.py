"""CPU rehearsals of every cell at a small size, through the run the card
makes (run.run_cell on "cpu"), with the control and a fault, which must
come out not correct; and the measuring entry, which refuses to run
without a card."""

import json
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.manifest import HERE, ROOT
from benchmark.tests import control
from benchmark.tests.rehearse import rehearse

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def workload(cell):
    return json.loads((HERE / "workloads" / f"{cell}.json").read_text())


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct_and_reports_the_cells_metrics(cell):
    res = rehearse(cell, seed=2**40 + 1)
    assert res["correct"], control.readings(res)
    want = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    assert list(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"  # a CPU run never names a device metric


@pytest.mark.parametrize("cell", CELLS)
def test_traced_rehearsal_reads_what_a_cpu_can(cell):
    res = rehearse(cell, seed=3, trace=True, seconds=0.5)
    assert res["correct"]
    layer = {m["name"] for m in BENCH["per_layer"] if cell in m["workloads"]}
    assert set(res["metrics"]) <= layer
    # no device trace on the CPU: the device readers return nothing, never 0
    assert not any(k.startswith(("idle_share", "forward_roofline", "mfu", "glue_device",
                                 "port_kernel")) for k in res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    with control.control(workload(cell)):
        res = rehearse(cell, seed=5)
    assert not res["correct"]
    r = control.readings(res)
    assert r["logits_differing"] > 0 and r["max_logit_gap"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_is_not_correct(cell):
    with control.fault():
        res = rehearse(cell, seed=6)
    assert not res["correct"]
    assert control.readings(res)["max_logit_gap"] == 1.0


def test_the_measuring_entry_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_a_run_loads_nothing_of_jax_or_the_jax_package():
    """A whole rehearsal in a process of its own, then its modules: the top
    name of each, compared whole (f8net_tpu_torch begins with f8net_tpu)."""
    out = subprocess.run([sys.executable, "-m", "benchmark.tests.rehearse", CELLS[0], "4"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2])["correct"]
    assert json.loads(lines[-1]) == {"forbidden_modules": []}
    sys.modules.setdefault("f8net_tpu_torch_lookalike", sys)
    try:
        assert "f8net_tpu_torch_lookalike" not in run.forbidden_modules()
        sys.modules["jaxlib.fake"] = sys
        assert run.forbidden_modules() == ["jaxlib.fake"]
    finally:
        sys.modules.pop("jaxlib.fake", None)
        sys.modules.pop("f8net_tpu_torch_lookalike", None)
