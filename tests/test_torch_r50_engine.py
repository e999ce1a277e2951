"""The port's ResNet-50 strict integer engine against the JAX engine.

One baked ResNet-50 per input pipeline (32 px, 16 classes, batch 2, full
widths, the published [3, 4, 6, 3] setting; `normalize` off, and on as in
the reference's `resnet50_tf` configuration, whose head input is signed)
goes through `f8net_tpu.engine.IntEngine(int_only=True)` and through the
port's `IntEngine` on the CPU, where the port runs its kernels' plain
versions (K7 for the 33 pointwise convs, K2, K3, K1).  The plan and the
integers are chip_smoke.py's synthetic bake -- random int8 weights and
fraclens calibrated in one float pass -- because the JAX `bake_plan` of a
ResNet-50 takes about a minute per configuration on a CPU.  The params reach
the port through `params_from_numpy` and through a JAX deploy bundle; a
bundle the port writes loads in JAX.  Logits must be bitwise equal
(tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

import chip_smoke
from f8net_tpu.engine import IntEngine as JaxIntEngine
from f8net_tpu.export.bundle import load_deploy_bundle as jax_load_bundle
from f8net_tpu.export.bundle import save_deploy_bundle as jax_save_bundle
from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.quant.plan import LayerPlan as JaxLayerPlan
from f8net_tpu.quant.plan import QuantPlan as JaxQuantPlan
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu_torch.engine import IntEngine
from f8net_tpu_torch.export import (
    load_deploy_bundle, model_from_topology, params_from_numpy, save_deploy_bundle,
)
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.utils import QuantConfig

CFG = dict(
    format_from_metric=True, metric="std", quant_bias=True, quant_avgpool=True,
    pool_fusing=True,
)
HW, CLASSES = 32, 16


def _images(normalize, seed):
    rng = np.random.RandomState(seed)
    if normalize:
        return rng.standard_normal((2, HW, HW, 3)).astype(np.float32)
    return (np.round(255 * rng.rand(2, HW, HW, 3)) / 256).astype(np.float32)


def _port_model(normalize):
    return get_model("resnet50", QuantConfig(normalize=normalize, **CFG), CLASSES, HW)


@pytest.fixture(scope="module")
def baked(tmp_path_factory):
    """{normalize: (jax model, records, numpy params, images, jax logits,
    jax bundle path)} -- every JAX computation of the file, done once."""
    out = {}
    for normalize in (False, True):
        x = _images(normalize, seed=5 + normalize)
        records, arrays, _ = chip_smoke.synthetic_bundle(
            _port_model(normalize), 11 + normalize, torch.from_numpy(x)
        )
        model = jax_get_model("resnet50", JaxQuantConfig(normalize=normalize, **CFG), CLASSES, HW)
        plan = JaxQuantPlan(tuple(JaxLayerPlan(*r) for r in records))
        ip = {k: {kk: jnp.asarray(v) for kk, v in d.items()} for k, d in arrays.items()}
        eng = JaxIntEngine(model, plan, ip, int_only=True)
        logits = np.asarray(eng(eng.condition_input(jnp.asarray(x))))
        path = str(tmp_path_factory.mktemp("bundle") / f"r50_{int(normalize)}")
        path = jax_save_bundle(path, model, plan, ip)
        out[normalize] = (model, records, arrays, x, logits, path)
    return out


@pytest.mark.parametrize("normalize", [False, True])
def test_logits_bitwise_params_from_numpy(baked, normalize):
    _, records, arrays, x, want, _ = baked[normalize]
    assert not np.array_equal(want[0], want[1])  # non-degenerate: the images' logits differ
    plan, params = params_from_numpy(records, arrays, "cpu")
    eng = IntEngine(_port_model(normalize), plan, params, device="cpu")
    got = eng(eng.condition_input(x))
    assert got.dtype == torch.float32 and got.shape == (2, CLASSES)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("normalize", [False, True])
def test_logits_bitwise_jax_bundle_in_port(baked, normalize):
    _, records, arrays, x, want, path = baked[normalize]
    topo, plan, params = load_deploy_bundle(path, device="cpu")
    assert [(p.name, p.input_fl, p.weight_fl, p.input_symmetric) for p in plan.layers] == [
        tuple(r) for r in records
    ]
    for name, entry in arrays.items():
        for key, arr in entry.items():
            np.testing.assert_array_equal(params[name][key].numpy(), arr)
    eng = IntEngine(model_from_topology(topo, image_size=HW), plan, params, device="cpu")
    np.testing.assert_array_equal(eng(eng.condition_input(x)).numpy(), want)


def test_port_bundle_loads_in_jax(baked, tmp_path):
    """A ResNet-50 bundle the port writes -- three-conv bodies, shortcuts on
    stage 0's first block and on the downsample blocks -- is one the JAX
    package reads back with the same topology, plan and integers."""
    model, records, arrays, _, _, jax_path = baked[True]
    plan, params = params_from_numpy(records, arrays, "cpu")
    path = save_deploy_bundle(str(tmp_path / "port"), _port_model(True), plan, params)
    topo, jplan, jparams = jax_load_bundle(path)
    jtopo, _, _ = jax_load_bundle(jax_path)
    assert topo["blocks"] == jtopo["blocks"] and topo["model"] == model.name
    assert all(len(b["body"]) == 3 for b in topo["blocks"])
    assert [i for i, b in enumerate(topo["blocks"]) if b["shortcut"]] == [0, 3, 7, 13]
    assert jplan == JaxQuantPlan(tuple(JaxLayerPlan(*r) for r in records))
    for name, entry in arrays.items():
        for key, arr in entry.items():
            np.testing.assert_array_equal(np.asarray(jparams[name][key]), arr)
