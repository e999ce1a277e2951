"""The port's int8- and bf16-boundary rungs of ResNet-50 and MobileNetV2
(32 px) and of ResNet-18 under the float-mean pool (64 px, quant_avgpool
off) against the JAX engine's, on chip_smoke.py's synthetic bake, as
tests/test_torch_{r50,mbv2}_engine.py have it (a JAX bake of those takes
about a minute each on a CPU).  MobileNetV2 is held against the JAX engine
with `fuse_ir` off (every block per layer) and on (its Pallas K5, in
interpret mode, where it takes the block).  One ResNet-50 case moves every
shortcut's input grid off its block's body.0 grid, so that the int8 rung
repacks the 1-byte carry for the shortcut (K7 on stage 0's, K2 on the
1x1/s2 ones) instead of reusing its bytes.

Each case goes through `f8net_tpu.engine.IntEngine(int_only=True,
int8_boundary=True | bf16_boundary=True)` and through the port's
`IntEngine(..., int8_boundary=True | bf16_boundary=True)` on the CPU, where
the port runs its kernels' plain versions; params reach the port through
`params_from_numpy` and through a JAX deploy bundle.  Block outputs, the
pool's input and output and the logits are compared as
tests/_rung_reference.py says.
"""

import numpy as np
import pytest

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

import _rung_reference as ref
from f8net_tpu_torch.engine import IntEngine
from f8net_tpu_torch.export import load_deploy_bundle, model_from_topology, params_from_numpy

CASES = {
    "r50_32": ("resnet50", 32, False, False, "synthetic", ref.CFG),
    "r50_32_norm": ("resnet50", 32, True, False, "synthetic", ref.CFG),
    "r50_32_regrid": ("resnet50", 32, False, False, "synthetic_regrid", ref.CFG),
    "mbv2_32": ("mobilenet_v2", 32, False, False, "synthetic", ref.CFG),
    "mbv2_32_fused": ("mobilenet_v2", 32, False, True, "mbv2_32", ref.CFG),
    "r18_64_float_pool": ("resnet18", 64, False, False, "synthetic", ref.FLOAT_POOL_CFG),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref.jax_runs(CASES, tmp_path_factory, seed0=10)


@pytest.mark.parametrize("rung", ref.RUNGS)
@pytest.mark.parametrize("case", list(CASES))
def test_rung_matches_jax_params_from_numpy(runs, case, rung):
    records, arrays, x, _, results = runs[case]
    want, taps = results[rung]
    assert not np.array_equal(want[0], want[1])  # non-degenerate: the images' logits differ
    plan, params = params_from_numpy(records, arrays, "cpu")
    eng = IntEngine(ref.port_model(CASES[case]), plan, params, device="cpu", **{rung: True})
    ref.check(CASES[case], rung, ref.port_run(eng, x), want, taps, plan)


@pytest.mark.parametrize("rung", ref.RUNGS)
@pytest.mark.parametrize("case", ["r50_32", "mbv2_32", "r18_64_float_pool"])
def test_rung_matches_jax_bundle(runs, case, rung):
    _, _, x, path, results = runs[case]
    want, taps = results[rung]
    topo, plan, params = load_deploy_bundle(path, device="cpu")
    eng = IntEngine(model_from_topology(topo, image_size=CASES[case][1]), plan, params,
                    device="cpu", **{rung: True})
    ref.check(CASES[case], rung, ref.port_run(eng, x), want, taps, plan)


def test_mobilenet_v2_rungs_route_k5_forms(runs):
    """In the int8 rung K5 takes its residual blocks' carries packed (1
    byte) and ends them in requant8; in the bf16 rung it ends them in bf16
    and takes no carry; neither rung changes which blocks K5 runs."""
    records, arrays, x, _, _ = runs["mbv2_32"]
    for rung, carry_dtypes, outs in (
        ("int8_boundary", {"int8"}, {"requant8"}),
        ("bf16_boundary", set(), {"bf16", "requant8"}),
    ):
        eng = IntEngine(ref.port_model(CASES["mbv2_32"]),
                        *params_from_numpy(records, arrays, "cpu"), device="cpu", **{rung: True})
        calls, irk = [], eng._irk

        def record(*args, **kw):
            calls.append((args, kw))
            return irk(*args, **kw)

        eng._irk = record
        eng(eng.condition_input(x))
        assert len(calls) == 12
        carries = {str(a[7].dtype).split(".")[1] for a, _ in calls if len(a) > 7}
        assert carries == carry_dtypes and {kw["out"] for _, kw in calls} == outs, rung
        if rung == "int8_boundary":
            offsets = {kw["carry_add_offset"] for a, kw in calls if len(a) > 7}
            assert offsets <= {0, 128} and len([1 for a, _ in calls if len(a) > 7]) == 10


def test_int8_rung_repacks_a_carry_only_for_another_grid(runs):
    """A 1-byte carry feeding body.0 and a shortcut is reused as it is when
    the two grids coincide and widened and requantized when they differ:
    ResNet-50's 4 shortcuts take 0 and 4 repacks."""
    for case, repacks in (("r50_32", 0), ("r50_32_regrid", 4)):
        records, arrays, x, _, _ = runs[case]
        eng = IntEngine(ref.port_model(CASES[case]), *params_from_numpy(records, arrays, "cpu"),
                        device="cpu", int8_boundary=True)
        widened, widen = [], eng._widen
        eng._widen = lambda act: widened.append(act.packed_for) or widen(act)
        eng(eng.condition_input(x))
        # the identity shortcuts' residual adds widen their carries too
        adds = sum(m.shortcut is None for m in eng.model.blocks)
        assert len(widened) == adds + repacks, case
