"""Bake-time channel padding in the port (`quant.pad_channels`,
`IntEngine(..., pad_channels_to=N)`) against the JAX package's
`f8net_tpu.quant.pad_channels` and against the port's unpadded engine, on
the CPU, where the engine runs its kernels' plain versions.

  * the policy `_pad_to`, and the transform's graph (every spec field) and
    arrays bitwise JAX's `pad_channels` on the same int params, a 'b_zp'
    entry dropped (numpy and specs only: a JAX bake of a MobileNetV2 takes
    about a minute on a CPU);
  * the padded engine's logits bitwise the unpadded engine's (tolerance 0:
    padding is exact by construction) for ResNet-18, ResNet-50, MobileNetV2
    and MobileNetV1 at 32 px on chip_smoke.py's synthetic bake, at N = 64
    and 128, strict rung; MobileNetV2 and ResNet-18 in the int8 and bf16
    rungs, normalized input and not; the kernel calls of each forward
    equal to the padded engine's launch table (its routing at the padded
    shapes: K7 takes the GEMMs padding widens out of K1's range);
  * every kernel call of the padded engines at 224 px, batch 8, in every
    rung, inside its kernel's own domain (the wrappers' checks on `meta`
    tensors, as tests/test_torch_tp.py walks the TP shards), the calls per
    kernel the launch table: a shape the card's kernels or planners refuse
    fails here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)
from test_torch_tp import _checked, _shape_params

import chip_smoke
from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.quant.pad_channels import _pad_to as jax_pad_to
from f8net_tpu.quant.pad_channels import pad_channels as jax_pad_channels
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu_torch.engine import IntEngine
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.ops import stem
from f8net_tpu_torch.quant import LayerPlan, QuantPlan, pad_channels
from f8net_tpu_torch.quant.pad_channels import _pad_to
from f8net_tpu_torch.utils import QuantConfig

CFG = dict(format_from_metric=True, metric="std", quant_bias=True, quant_avgpool=True,
           pool_fusing=True)
HW, CLASSES, BATCH = 32, 16, 2
FAMILIES = ("resnet18", "resnet50", "mobilenet_v2", "mobilenet_v1")
RUNGS = {"strict": {}, "int8": dict(int8_boundary=True), "bf16": dict(bf16_boundary=True)}


def _images(normalize, seed=0, n=BATCH):
    rng = np.random.RandomState(seed)
    if normalize:
        return torch.from_numpy(rng.standard_normal((n, HW, HW, 3)).astype(np.float32))
    return torch.from_numpy((np.round(255 * rng.rand(n, HW, HW, 3)) / 256).astype(np.float32))


_BAKES = {}


def _bake(family, normalize=False):
    """chip_smoke.py's synthetic bake of `family` at 32 px (int8 weights,
    input fraclens from one float pass on these images): (model, plan, int
    params as tensors)."""
    key = (family, normalize)
    if key not in _BAKES:
        model = get_model(family, QuantConfig(**CFG, normalize=normalize), CLASSES, HW)
        records, arrays, _ = chip_smoke.synthetic_bundle(model, 0, _images(normalize, 9, 4))
        plan = QuantPlan(tuple(LayerPlan(*r) for r in records))
        params = {k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in arrays.items()}
        _BAKES[key] = (model, plan, params)
    return _BAKES[key]


@pytest.mark.parametrize("multiple,threshold", [(128, 128), (64, 64), (32, 128), (16, 48)])
def test_pad_policy_equals_jax(multiple, threshold):
    cs = list(range(0, 300)) + [320, 576, 960, 1024, 1280, 2048]
    assert [_pad_to(c, multiple, threshold) for c in cs] == [
        jax_pad_to(c, multiple, threshold) for c in cs]
    assert _pad_to(3, multiple, threshold) == 3 and _pad_to(4, multiple, threshold) == 4


@pytest.mark.parametrize("to", [64, 128])
@pytest.mark.parametrize("family", FAMILIES)
def test_transform_equals_jax(family, to):
    """The padded graph field for field and the padded arrays bitwise JAX's
    on the same int params (a b_zp entry dropped on both); real values in
    place, zeros around them, depthwise groups following their channels."""
    model, _, params = _bake(family)
    params = {k: dict(v) for k, v in params.items()}
    params["head"]["b_zp"] = params["head"]["b"] + 1
    jmodel = jax_get_model(family, JaxQuantConfig(**CFG), CLASSES, HW)
    pm, pp = pad_channels(model, params, multiple=to, threshold=to)
    jm, jp = jax_pad_channels(jmodel, {k: {kk: v.numpy() for kk, v in d.items()}
                                       for k, d in params.items()}, multiple=to, threshold=to)
    assert pm.graph.names() == jm.graph.names()
    widened = 0
    for name in pm.graph.names():
        assert dataclasses.asdict(pm.graph[name]) == dataclasses.asdict(jm.graph[name]), name
        assert set(pp[name]) == set(jp[name]) == set(params[name]) - {"b_zp"}, name
        for k, v in pp[name].items():
            assert v.dtype == params[name][k].dtype
            np.testing.assert_array_equal(v.numpy(), np.asarray(jp[name][k]), err_msg=name)
            orig = params[name][k]
            assert torch.equal(v[tuple(slice(0, s) for s in orig.shape)], orig)
            assert int(v.abs().sum()) == int(orig.abs().sum())
            widened += v.shape != orig.shape
        spec = pm.graph[name]
        if getattr(spec, "is_depthwise", False):
            assert spec.groups == spec.in_ch == spec.out_ch
    assert widened > 0 if (family.startswith("mobilenet") or to == 128) else widened == 0
    assert pm.blocks == model.blocks and pm.name == model.name


def _run(eng, x):
    """Logits and the kernel calls of one forward, by kernel name."""
    calls = []
    for attr in chip_smoke.ENGINE_ATTRS.values():
        fn = getattr(eng, attr)
        setattr(eng, attr, lambda *a, _fn=fn, _attr=attr, **kw: calls.append(_attr) or _fn(*a, **kw))
    logits = eng(x)
    names = {v: k for k, v in chip_smoke.ENGINE_ATTRS.items()}
    return logits, {names[a]: calls.count(a) for a in set(calls)}


# (family, rung, normalize): the strict rung of every family; the relaxed
# rungs for MobileNetV2 (K5's carry and output forms) and ResNet-18
CASES = ([(f, "strict", False) for f in FAMILIES]
         + [(f, r, n) for f in ("mobilenet_v2", "resnet18") for r in ("int8", "bf16")
            for n in (False, True)]
         + [("resnet18", "strict", True)])


@pytest.mark.parametrize("to", [64, 128])
@pytest.mark.parametrize("family,rung,normalize", CASES)
def test_padded_engine_bitwise_unpadded(family, rung, normalize, to):
    model, plan, params = _bake(family, normalize)
    eng = IntEngine(model, plan, params, device="cpu", **RUNGS[rung])
    peng = IntEngine(model, plan, params, device="cpu", pad_channels_to=to, **RUNGS[rung])
    x = eng.condition_input(_images(normalize))
    want, _ = _run(eng, x)
    got, calls = _run(peng, x)
    assert got.shape == (BATCH, CLASSES) and torch.equal(got, want)
    assert not torch.equal(want[0], want[1])
    assert calls == peng.launch_table()
    assert peng.graph is not eng.graph


def test_padded_routing_follows_padded_shapes():
    """MobileNetV2 at N = 64: the 1x1 GEMMs K7 left to K1 (K = 24, N = 16
    and 24) are 64 wide and go to K7; the head's K2 writes 64 channels.
    ResNet-18 at 128: the stem's K3 writes 128 channels; at 64 nothing
    pads.  The float-dtype engine is never padded."""
    model, plan, params = _bake("mobilenet_v2")
    base = IntEngine(model, plan, params, device="cpu").launch_table()
    padded = IntEngine(model, plan, params, device="cpu", pad_channels_to=64)
    assert base["int8_gemm"] == 4 and padded.launch_table()["int8_gemm"] == 1
    assert padded.launch_table()["int8_gemm_v2"] == base["int8_gemm_v2"] + 3
    assert padded.graph["head"].out_ch == 64 and padded._packed["head"].o == 64
    model, plan, params = _bake("resnet18")
    assert IntEngine(model, plan, params, device="cpu", pad_channels_to=128)._stem_w.shape == (
        128, stem.STEM_K)
    r64 = IntEngine(model, plan, params, device="cpu", pad_channels_to=64)
    assert list(r64.graph) == list(model.graph)
    sim = IntEngine(model, plan, params, device="cpu", int_only=False, pad_channels_to=128)
    assert sim.graph is model.graph


def _checked_padded(calls):
    """tests/test_torch_tp.py's checked kernels, K3's output as wide as its
    packed weights."""
    fns = _checked(calls)

    def stemk(x, w, b, **kw):
        calls.append("stem_pool")
        wp = stem.stem_pool_check(x, w, b, **kw)
        _, _, ph, pw = stem.stem_out_hw(x.shape[1], x.shape[2])
        return torch.empty((x.shape[0], ph, pw, wp.shape[0]), dtype=torch.int32, device=x.device)

    fns["_stemk"] = stemk
    return fns


@pytest.mark.parametrize("to", [64, 128])
@pytest.mark.parametrize("family", FAMILIES)
def test_every_padded_call_at_224_px_lies_in_its_kernels_domain(family, to):
    model = get_model(family, QuantConfig(**CFG), num_classes=1000, image_size=224)
    arrays, plan = _shape_params(model)
    params = {k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in arrays.items()}
    images = torch.zeros((8, 224, 224, 3), device="meta")
    for rung, kw in RUNGS.items():
        eng = IntEngine(model, plan, params, device="meta", pad_channels_to=to, **kw)
        calls = []
        for attr, fn in _checked_padded(calls).items():
            setattr(eng, attr, fn)
        logits = eng(eng.condition_input(images))
        assert logits.shape == (8, 1000), (family, to, rung)
        assert {k: calls.count(k) for k in set(calls)} == eng.launch_table(), (family, to, rung)
