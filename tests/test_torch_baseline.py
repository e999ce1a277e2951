"""The port's bf16 speed baseline (`f8net_tpu_torch.engine.baseline`)
against the JAX one (`f8net_tpu.engine.baseline`): the same random float
weights through both `plain_forward`s, both in float32, for ResNet-18 and
MobileNetV2 at 32 px.  Not bitwise: the two packages' convolutions sum in
different orders (XLA's on the CPU, and torch's), so the logits agree within
rtol 1e-4 of the largest logit, about a hundred float32 rounding steps over
a forward of some twenty layers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from f8net_tpu.engine.baseline import plain_forward as jax_plain_forward
from f8net_tpu.engine.baseline import plain_params as jax_plain_params
from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu_torch.engine import plain_forward, plain_params
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.utils import QuantConfig

RTOL = 1e-4


def _weights(model, seed):
    """He-scaled float weights and small biases, so that the activations
    stay in range through the whole network."""
    rng = np.random.RandomState(seed)
    out = {}
    for name in model.graph.names():
        shape = model.graph[name].weight_shape()
        std = np.sqrt(2.0 / np.prod(shape[:-1]))
        out[name] = {
            "w": (rng.standard_normal(shape) * std).astype(np.float32),
            "b": (0.05 * rng.standard_normal(shape[-1])).astype(np.float32),
        }
    return out


@pytest.mark.parametrize("name", ["resnet18", "mobilenet_v2"])
def test_plain_forward_matches_jax(name):
    model = get_model(name, QuantConfig(), num_classes=10, image_size=32)
    jmodel = jax_get_model(name, JaxQuantConfig(), num_classes=10, image_size=32)
    arrays = _weights(model, 0)
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(jax_plain_forward(
        jmodel, jax_plain_params(jmodel, {k: {kk: jnp.asarray(v) for kk, v in d.items()}
                                          for k, d in arrays.items()}, jnp.float32),
        jnp.asarray(x), jnp.float32,
    ))
    params = plain_params(
        model, {k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in arrays.items()},
        torch.float32,
    )
    got = plain_forward(model, params, torch.from_numpy(x), torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    assert np.isfinite(want).all() and not np.array_equal(want[0], want[1])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL * np.abs(want).max())


def test_plain_params_layout():
    """Conv weights OIHW in channels_last (cuDNN's preferred layout), the
    classifier's (in, out), bf16 by default; values are the engine's."""
    model = get_model("resnet18", QuantConfig(), num_classes=10, image_size=32)
    ints = {k: {kk: torch.from_numpy(v * 100).to(torch.int32) for kk, v in d.items()}
            for k, d in _weights(model, 2).items()}
    p = plain_params(model, ints)
    w = p["stage_0_layer_0.body.0"]["w"]
    assert w.dtype == torch.bfloat16 and w.shape == (64, 64, 3, 3)
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(w.permute(2, 3, 1, 0), ints["stage_0_layer_0.body.0"]["w"].to(torch.bfloat16))
    assert p["classifier"]["w"].shape == (512, 10)
