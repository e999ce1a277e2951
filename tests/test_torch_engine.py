"""The port's ResNet-18 strict integer engine against the JAX engine.

The same JAX-baked model (init -> one train-mode apply -> bake_plan) goes
through `f8net_tpu.engine.IntEngine(int_only=True)` and through the port's
`IntEngine` on the CPU, where the port runs its kernels' plain versions.
The params reach the port two ways: `params_from_numpy` on the arrays, and a
JAX `save_deploy_bundle` -> port `load_deploy_bundle` round trip.  Logits
must be bitwise equal (tolerance 0: the strict rung is integer throughout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from f8net_tpu.engine import IntEngine as JaxIntEngine
from f8net_tpu.export.bundle import save_deploy_bundle as jax_save_bundle
from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.quant import bake_plan
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu_torch.engine import IntEngine
from f8net_tpu_torch.export import load_deploy_bundle, model_from_topology, params_from_numpy
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.utils import QuantConfig

CFG = dict(
    format_from_metric=True, metric="std", quant_bias=True, quant_avgpool=True,
    pool_fusing=True,
)
CASES = [(hw, norm) for hw in (32, 64) for norm in (False, True)]
FLOAT_POOL = (64, False)  # quant_avgpool off: the reference's float-mean pool


def _images(hw, normalize, seed):
    rng = np.random.RandomState(seed)
    if normalize:
        return rng.standard_normal((2, hw, hw, 3)).astype(np.float32)
    return (np.round(255 * rng.rand(2, hw, hw, 3)) / 256).astype(np.float32)


@pytest.fixture(scope="module")
def baked(tmp_path_factory):
    """{(hw, normalize) or "float_pool": (jax model, plan, int params,
    images, jax logits, bundle path)} -- every JAX computation of the file,
    done once."""
    out = {}
    for key in CASES + ["float_pool"]:
        hw, normalize = FLOAT_POOL if key == "float_pool" else key
        cfg = JaxQuantConfig(normalize=normalize, **_cfg(key))
        model = jax_get_model("resnet18", cfg, num_classes=10, image_size=hw)
        params, state = model.init(jax.random.PRNGKey(0))
        x = _images(hw, normalize, seed=hw + normalize)
        _, state = model.apply(params, state, jnp.asarray(x), mode="train")
        plan, ip = bake_plan(model, params, state)
        eng = JaxIntEngine(model, plan, ip, int_only=True)
        logits = np.asarray(eng(eng.condition_input(jnp.asarray(x))))
        path = str(tmp_path_factory.mktemp("bundle") / f"r18_{hw}_{int(normalize)}")
        path = jax_save_bundle(path, model, plan, ip)
        out[key] = (model, plan, ip, x, logits, path)
    return out


def _cfg(key):
    return dict(CFG, quant_avgpool=False, pool_fusing=False) if key == "float_pool" else CFG


def _port_model(hw, normalize, key=None):
    return get_model(
        "resnet18", QuantConfig(normalize=normalize, **_cfg(key)), num_classes=10,
        image_size=hw,
    )


def _port_params(plan, ip):
    records = [(p.name, p.input_fl, p.weight_fl, p.input_symmetric) for p in plan.layers]
    arrays = {k: {kk: np.asarray(v) for kk, v in d.items()} for k, d in ip.items()}
    return params_from_numpy(records, arrays, device="cpu")


@pytest.mark.parametrize("hw,normalize", CASES)
def test_logits_bitwise_params_from_numpy(baked, hw, normalize):
    _, plan, ip, x, want, _ = baked[(hw, normalize)]
    eng = IntEngine(_port_model(hw, normalize), *_port_params(plan, ip), device="cpu")
    got = eng(eng.condition_input(x))
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw,normalize", CASES)
def test_logits_bitwise_bundle_round_trip(baked, hw, normalize):
    _, plan, ip, x, want, path = baked[(hw, normalize)]
    topo, tplan, tparams = load_deploy_bundle(path, device="cpu")
    assert tplan.layers == tuple(
        type(tplan.layers[0])(p.name, p.input_fl, p.weight_fl, p.input_symmetric)
        for p in plan.layers
    )
    for name, entry in ip.items():
        for key, arr in entry.items():
            np.testing.assert_array_equal(tparams[name][key].numpy(), np.asarray(arr))
    eng = IntEngine(model_from_topology(topo, image_size=hw), tplan, tparams, device="cpu")
    np.testing.assert_array_equal(eng(eng.condition_input(x)).numpy(), want)


def test_condition_input_matches_jax(baked):
    """The wire input (uint8 unnormalized, int8 normalized) is the JAX
    engine's, value and dtype."""
    for hw, normalize in CASES[:2]:
        model, plan, ip, x, _, _ = baked[(hw, normalize)]
        want = np.asarray(JaxIntEngine(model, plan, ip).condition_input(jnp.asarray(x)))
        eng = IntEngine(_port_model(hw, normalize), *_port_params(plan, ip), device="cpu")
        got = eng.condition_input(x).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_logits_bitwise_float_mean_pool(baked):
    """quant_avgpool off: the average pool is the reference's float mean,
    requantized onto the classifier's grid.  At 64 px the pool sums 4
    integers, exact in float32 in any order, so the logits are bitwise."""
    _, plan, ip, x, want, _ = baked["float_pool"]
    eng = IntEngine(_port_model(*FLOAT_POOL, "float_pool"), *_port_params(plan, ip), device="cpu")
    np.testing.assert_array_equal(eng(eng.condition_input(x)).numpy(), want)


def test_port_bundle_loads_in_jax(baked, tmp_path):
    """A bundle the port writes is one the JAX package reads back with the
    same plan and the same integers."""
    from f8net_tpu.export.bundle import load_deploy_bundle as jax_load_bundle
    from f8net_tpu_torch.export import save_deploy_bundle

    model, plan, ip, _, _, _ = baked[(32, False)]
    tplan, tparams = _port_params(plan, ip)
    path = save_deploy_bundle(str(tmp_path / "port"), _port_model(32, False), tplan, tparams)
    topo, jplan, jparams = jax_load_bundle(path)
    assert jplan == plan and topo["model"] == model.name
    for name, entry in ip.items():
        for key, arr in entry.items():
            np.testing.assert_array_equal(np.asarray(jparams[name][key]), np.asarray(arr))


@pytest.mark.parametrize("h,w", [(36, 36), (40, 40), (32, 48)])
def test_logits_bitwise_other_input_sizes_float_mean_pool(baked, h, w):
    """Inputs whose side is not a multiple of 8, or that are not square:
    the JAX engine runs its stem in XLA there, the port in K3 as at every
    size.  Under the float-mean pool the logits are bitwise (the final maps
    are 2x2 and 1x2: sums of at most 4 integers, exact in float32).  The
    shift-sum pool (quant_avgpool) cannot take these sizes: the JAX model's
    `fxq_avgpool` raises when the pool's extent differs from the built
    image_size // 32."""
    model, plan, ip, _, _, _ = baked["float_pool"]
    x = (np.round(255 * np.random.RandomState(h + w).rand(2, h, w, 3)) / 256).astype(np.float32)
    jeng = JaxIntEngine(model, plan, ip, int_only=True)
    want = np.asarray(jeng(jeng.condition_input(jnp.asarray(x))))
    eng = IntEngine(_port_model(*FLOAT_POOL, "float_pool"), *_port_params(plan, ip), device="cpu")
    got = eng(eng.condition_input(x)).numpy()
    assert not np.array_equal(want[0], want[1])
    np.testing.assert_array_equal(got, want)
