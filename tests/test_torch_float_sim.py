"""The port's float-dtype cross-check, `IntEngine(int_only=False)`, against
the JAX package's (`f8net_tpu.engine.IntEngine(int_only=False)`, its
`float_sim_forward`) for ResNet-18, MobileNetV2 and MobileNetV1 at 32 px,
batch 2, 10 classes, on chip_smoke.py's synthetic bake, normalized and not.

Both carry the integer engine's values in float32 through a float conv
(XLA's there, F.conv2d here).  Every operand is an integer of at most 8
bits (255 unsigned), so a conv's float32 sum is exact, whatever its order,
while every partial sum stays below 2^24; the tolerance covers the rest.
For each layer the test bounds |sum| by 255 * sum|w| + |b| over its output
channels: where every layer's bound is below 2^24 the logits must be
bitwise equal to JAX's and to the port's own integer engine (the strict
rung); otherwise they may part by the roundings of sums past 2^24, bounded
here by 2^-20 of the largest logit (a few roundings of 2^-24 relative,
each possibly moving one 8-bit operand of a later layer by a step, which
the requant scales back down), and the argmax must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

import chip_smoke
from f8net_tpu.engine import IntEngine as JaxIntEngine
from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.quant.plan import LayerPlan as JaxLayerPlan
from f8net_tpu.quant.plan import QuantPlan as JaxQuantPlan
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu_torch.engine import IntEngine
from f8net_tpu_torch.export import params_from_numpy
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.utils import QuantConfig

CFG = dict(format_from_metric=True, metric="std", quant_bias=True, quant_avgpool=True,
           pool_fusing=True)
CASES = [(name, norm) for name in ("resnet18", "mobilenet_v2", "mobilenet_v1")
         for norm in (False, True)]


def _images(normalize, seed):
    rng = np.random.RandomState(seed)
    if normalize:
        return rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    return (np.round(255 * rng.rand(2, 32, 32, 3)) / 256).astype(np.float32)


@pytest.fixture(scope="module", params=CASES, ids=[f"{n}-{'norm' if z else 'u8'}" for n, z in CASES])
def case(request):
    """(port model, records, arrays, images, JAX float-sim logits)."""
    name, normalize = request.param
    x = _images(normalize, seed=30 + CASES.index(request.param))
    model = get_model(name, QuantConfig(normalize=normalize, **CFG), num_classes=10, image_size=32)
    records, arrays, _ = chip_smoke.synthetic_bundle(model, 3, torch.from_numpy(x))
    jmodel = jax_get_model(name, JaxQuantConfig(normalize=normalize, **CFG), 10, 32)
    plan = JaxQuantPlan(tuple(JaxLayerPlan(*r) for r in records))
    ip = {k: {kk: jnp.asarray(v) for kk, v in d.items()} for k, d in arrays.items()}
    eng = JaxIntEngine(jmodel, plan, ip, int_only=False)
    return model, records, arrays, x, np.asarray(eng(eng.condition_input(jnp.asarray(x))))


def _f32_exact(arrays) -> bool:
    """Whether every layer's |conv + bias| stays below 2^24 for any 8-bit
    operand up to 255."""
    for entry in arrays.values():
        w = np.abs(entry["w"].astype(np.int64))
        col = 255 * w.reshape(-1, w.shape[-1]).sum(0) + np.abs(entry["b"].astype(np.int64))
        if col.max() >= 1 << 24:
            return False
    return True


def test_float_sim_matches_jax(case):
    model, records, arrays, x, want = case
    eng = IntEngine(model, *params_from_numpy(records, arrays, "cpu"), device="cpu",
                    int_only=False)
    xc = eng.condition_input(x)
    assert xc.dtype == torch.float32
    got = eng(xc).numpy()
    assert got.shape == want.shape == (2, 10) and np.isfinite(got).all()
    assert not np.array_equal(want[0], want[1])
    strict = IntEngine(model, *params_from_numpy(records, arrays, "cpu"), device="cpu")
    ints = strict(strict.condition_input(x)).numpy()
    if _f32_exact(arrays):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ints)
    else:
        tol = 2.0**-20 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        np.testing.assert_allclose(got, ints, rtol=0, atol=tol)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_float_sim_conditions_input_as_jax(case):
    model, records, arrays, x, _ = case
    plan, params = params_from_numpy(records, arrays, "cpu")
    jplan = JaxQuantPlan(tuple(JaxLayerPlan(*r) for r in records))
    jmodel = jax_get_model(model.name, JaxQuantConfig(normalize=model.cfg.normalize, **CFG), 10, 32)
    want = np.asarray(JaxIntEngine(jmodel, jplan, {}, int_only=False).condition_input(jnp.asarray(x)))
    got = IntEngine(model, plan, params, device="cpu", int_only=False).condition_input(x).numpy()
    np.testing.assert_array_equal(got, want)


def test_float_sim_refuses_the_boundary_rungs():
    model = get_model("mobilenet_v1", QuantConfig(**CFG), num_classes=4, image_size=32)
    with pytest.raises(ValueError, match="int_only"):
        IntEngine(model, None, {}, device="cpu", int_only=False, bf16_boundary=True)
