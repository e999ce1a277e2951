"""The port's int8- and bf16-boundary rungs of ResNet-18 against the JAX
engine's, on the JAX bake (init -> one train-mode apply -> bake_plan), as
tests/test_torch_engine.py has it: 32 and 64 px, normalized input and not.

Each case goes through `f8net_tpu.engine.IntEngine(int_only=True,
int8_boundary=True | bf16_boundary=True)` and through the port's
`IntEngine(..., int8_boundary=True | bf16_boundary=True)` on the CPU, where
the port runs its kernels' plain versions; params reach the port through
`params_from_numpy` and through a JAX deploy bundle.  Block outputs, the
pool's input and output and the logits are compared as
tests/_rung_reference.py says (bitwise; the one stated tolerance is the bf16
rung's f32 pool sum, and the bf16 reference is compiled without XLA's
excess precision).  ResNet-50, MobileNetV2 and the float-mean pool are in
tests/test_torch_boundary_engine_synth.py.
"""

import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

import _rung_reference as ref
import chip_smoke
from f8net_tpu_torch.engine import IntEngine
from f8net_tpu_torch.export import load_deploy_bundle, model_from_topology, params_from_numpy

CASES = {
    "r18_32": ("resnet18", 32, False, False, "jax", ref.CFG),
    "r18_32_norm": ("resnet18", 32, True, False, "jax", ref.CFG),
    "r18_64": ("resnet18", 64, False, False, "jax", ref.CFG),
    "r18_64_norm": ("resnet18", 64, True, False, "jax", ref.CFG),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref.jax_runs(CASES, tmp_path_factory)


@pytest.mark.parametrize("rung", ref.RUNGS)
@pytest.mark.parametrize("case", list(CASES))
def test_rung_matches_jax_params_from_numpy(runs, case, rung):
    records, arrays, x, _, results = runs[case]
    want, taps = results[rung]
    assert not np.array_equal(want[0], want[1])  # non-degenerate: the images' logits differ
    plan, params = params_from_numpy(records, arrays, "cpu")
    eng = IntEngine(ref.port_model(CASES[case]), plan, params, device="cpu", **{rung: True})
    port = ref.port_run(eng, x)
    assert port[0].dtype == np.float32 and port[0].shape == (2, ref.CLASSES)
    ref.check(CASES[case], rung, port, want, taps, plan)


@pytest.mark.parametrize("rung", ref.RUNGS)
@pytest.mark.parametrize("case", list(CASES))
def test_rung_matches_jax_bundle(runs, case, rung):
    _, _, x, path, results = runs[case]
    want, taps = results[rung]
    topo, plan, params = load_deploy_bundle(path, device="cpu")
    eng = IntEngine(model_from_topology(topo, image_size=CASES[case][1]), plan, params,
                    device="cpu", **{rung: True})
    ref.check(CASES[case], rung, ref.port_run(eng, x), want, taps, plan)


def test_rungs_differ_from_strict_and_from_each_other(runs):
    """The rungs are other arithmetic than the strict rung, not the same
    under another name: on ResNet-18 at 64 px the three engines give three
    sets of logits, and the block outputs between blocks are int32, packed
    int8 and bf16."""
    records, arrays, x, _, _ = runs["r18_64"]
    got = {}
    for rung in ("strict",) + ref.RUNGS:
        kw = {} if rung == "strict" else {rung: True}
        eng = IntEngine(ref.port_model(CASES["r18_64"]),
                        *params_from_numpy(records, arrays, "cpu"), device="cpu", **kw)
        logits, blocks, _, _ = ref.port_run(eng, x)
        got[rung] = logits
        dtypes = {b.x.dtype for b in blocks[:-1]}
        assert dtypes == {{"strict": torch.int32, "int8_boundary": torch.int8,
                           "bf16_boundary": torch.bfloat16}[rung]}, (rung, dtypes)
    assert not np.array_equal(got["strict"], got["int8_boundary"])
    assert not np.array_equal(got["strict"], got["bf16_boundary"])
    assert not np.array_equal(got["int8_boundary"], got["bf16_boundary"])


def test_both_rungs_raise():
    model = ref.port_model(CASES["r18_32"])
    records, arrays, _ = chip_smoke.synthetic_bundle(
        model, 0, torch.from_numpy(ref.images(32, False, 0))
    )
    with pytest.raises(ValueError, match="exclude each other"):
        IntEngine(model, *params_from_numpy(records, arrays, "cpu"), device="cpu",
                  int8_boundary=True, bf16_boundary=True)
