"""The port's static graph against the JAX package's, its independence of
JAX, and its refusal to fall back to the CPU."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu_torch.engine import IntEngine
from f8net_tpu_torch.export import params_from_numpy
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.ops import gemm_v2 as gemm_v2_ops
from f8net_tpu_torch.utils import QuantConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _specs(graph):
    return [(type(s).__name__, dataclasses.asdict(s)) for s in graph]


@pytest.mark.parametrize("depth", [18, 34, 50, 101, 152])
@pytest.mark.parametrize("normalize,pool_fusing", [(False, True), (True, False)])
def test_resnet_graph_equals_reference(depth, normalize, pool_fusing):
    kw = dict(quant_avgpool=True, pool_fusing=pool_fusing, normalize=normalize)
    ref = jax_get_model(f"resnet{depth}", JaxQuantConfig(**kw), num_classes=10, image_size=64)
    got = get_model(f"resnet{depth}", QuantConfig(**kw), num_classes=10, image_size=64)
    assert _specs(got.graph) == _specs(ref.graph)
    assert got.graph.names() == ref.graph.names()
    assert [tuple(m) for m in got.blocks] == [tuple(m) for m in ref.blocks]
    assert got.conv_order == ref.conv_order
    assert (got.name, got.block_setting, got.num_classes) == (
        ref.name, ref.block_setting, ref.num_classes
    )
    assert (got.pool_kernel, got.pool_fuse_layer) == (ref.pool_kernel, ref.pool_fuse_layer)


@pytest.mark.parametrize("normalize,pool_fusing", [(False, True), (True, False)])
def test_mobilenet_v2_graph_equals_reference(normalize, pool_fusing):
    kw = dict(quant_avgpool=True, pool_fusing=pool_fusing, normalize=normalize)
    ref = jax_get_model("mobilenet_v2", JaxQuantConfig(**kw), num_classes=10, image_size=224)
    got = get_model("mobilenet_v2", QuantConfig(**kw), num_classes=10, image_size=224)
    assert _specs(got.graph) == _specs(ref.graph)
    assert got.graph.names() == ref.graph.names()
    assert [tuple(m) for m in got.blocks] == [tuple(m) for m in ref.blocks]
    assert got.conv_order == ref.conv_order
    assert (got.name, got.block_setting, got.num_classes) == (
        ref.name, ref.block_setting, ref.num_classes
    )
    assert (got.pool_kernel, got.pool_fuse_layer) == (ref.pool_kernel, ref.pool_fuse_layer)


def test_mobilenet_v1_not_ported():
    """MobileNetV1, refused while its graph was not ported, now builds (its
    graph against the reference's: tests/test_torch_mbv1_engine.py); a name
    the registry does not know still raises."""
    model = get_model("mobilenet_v1", QuantConfig(), num_classes=4, image_size=32)
    assert model.name == "mobilenet_v1" and len(model.blocks) == 13
    with pytest.raises(ValueError, match="unknown model"):
        get_model("mobilenet_v3", QuantConfig(), num_classes=4, image_size=32)


def test_port_and_chip_smoke_import_no_jax():
    """With `jax` made unimportable, the whole port and chip_smoke.py still
    import: neither needs JAX or anything of f8net_tpu."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['f8net_tpu'] = None\n"
        "import pkgutil, importlib, f8net_tpu_torch\n"
        "for m in pkgutil.walk_packages(f8net_tpu_torch.__path__, 'f8net_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'f8net_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr


def _tiny_params():
    model = get_model("resnet18", QuantConfig(quant_avgpool=True), num_classes=4, image_size=32)
    records = [(n, 6, 7, False) for n in model.graph.names()]
    arrays = {
        n: {"w": np.zeros(model.graph[n].weight_shape(), np.int8),
            "b": np.zeros(model.graph[n].weight_shape()[-1], np.int32)}
        for n in model.graph.names()
    }
    return model, *params_from_numpy(records, arrays, device="cpu")


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, plan, params = _tiny_params()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IntEngine(model, plan, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy([], {})
    IntEngine(model, plan, params, device="cpu")  # asked for explicitly: runs


def test_resnet50_routes_pointwise_convs_to_k7():
    """A ResNet-50 engine sends each Bottleneck block's 1x1/s1 convs --
    body.0, body.2 and stage 0's 1x1/s1 shortcut, 33 in all -- to K7, and
    nothing else: the 3x3 convs and the 1x1/s2 shortcuts stay on K2."""
    model = get_model("resnet50", QuantConfig(quant_avgpool=True), num_classes=4, image_size=32)
    records = [(n, 6, 7, False) for n in model.graph.names()]
    arrays = {
        n: {"w": np.zeros(model.graph[n].weight_shape(), np.int8),
            "b": np.zeros(model.graph[n].weight_shape()[-1], np.int32)}
        for n in model.graph.names()
    }
    eng = IntEngine(model, *params_from_numpy(records, arrays, device="cpu"), device="cpu")
    want = {n for m in model.blocks for n in (m.body[0], m.body[2])}
    want.add("stage_0_layer_0.shortcut.0")
    assert {n for n in model.graph.names() if eng.on_k7(n)} == want and len(want) == 33
    routed = []
    eng._gemm2 = lambda *a, **kw: routed.append(a[1]) or gemm_v2_ops.int8_gemm_v2_plain(*a, **kw)
    eng(torch.zeros((1, 32, 32, 3), dtype=torch.uint8))
    assert len(routed) == 33
    # each call carries the weights packed for K7 at construction
    assert all(any(w is eng._packed[n] for n in want) for w in routed)


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert capsys.readouterr().out == ""
