"""The port's exports (f8net_tpu_torch.export.torch_export, .native_bundle)
against the JAX package's, at 32 px, batch 2, 10 classes, on chip_smoke.py's
synthetic bake.

The JAX side is built from the port's plan through the port's deploy bundle
and the JAX `load_deploy_bundle`, its graph by `f8net_tpu.models.get_model`
(building a graph compiles nothing).  Tolerance 0 throughout: the int32
module of either package, its traced TorchScript reloaded, the port's
`IntEngine` (strict, on the CPU) and `csrc/infer_main` on the port's F8NB
bundle give the same integers, and the port writes the JAX writer's bytes.
One property of the reference is pinned: its stem maxpool runs in float32,
which rounds a stem output above 2^24; the port's is exact.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

import chip_smoke
from f8net_tpu.export import build_torch_int_model as jax_build_torch_int_model
from f8net_tpu.export.bundle import load_deploy_bundle as jax_load_deploy_bundle
from f8net_tpu.export.native_bundle import save_native_bundle as jax_save_native_bundle
from f8net_tpu.export.torch_export import condition_input_torch as jax_condition_input_torch
from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu_torch.engine import IntEngine
from f8net_tpu_torch.export import (
    build_torch_int_model, condition_input_torch, export_torchscript, load_native_bundle,
    params_from_numpy, save_deploy_bundle, save_native_bundle,
)
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.utils import QuantConfig

CFG = dict(format_from_metric=True, metric="std", quant_bias=True, quant_avgpool=True,
           pool_fusing=True)
HW, CLASSES = 32, 10
CASES = {
    "resnet18": ("resnet18", False),
    "resnet18_norm": ("resnet18", True),
    "mobilenet_v1": ("mobilenet_v1", False),
    "mobilenet_v2": ("mobilenet_v2", False),
}
INFER_MAIN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "csrc", "infer_main")


def _build(case, tmp_path, seed=3, head_bias=None):
    """(port model, plan, params, JAX model, JAX plan, JAX int params,
    float NHWC images, the port engine's wire input)."""
    name, normalize = CASES[case]
    cfg = dict(CFG, normalize=normalize)
    model = get_model(name, QuantConfig(**cfg), CLASSES, HW)
    rng = np.random.RandomState(seed)
    if normalize:
        x = rng.standard_normal((2, HW, HW, 3)).astype(np.float32)
    else:
        x = (np.round(255 * rng.rand(2, HW, HW, 3)) / 256).astype(np.float32)
    records, arrays, _ = chip_smoke.synthetic_bundle(model, seed, torch.from_numpy(x))
    if head_bias is not None:
        arrays["head"]["b"] = np.full_like(arrays["head"]["b"], head_bias)
    plan, params = params_from_numpy(records, arrays, "cpu")
    path = save_deploy_bundle(str(tmp_path / case), model, plan, params)
    _, jplan, jip = jax_load_deploy_bundle(path)
    jmodel = jax_get_model(name, JaxQuantConfig(**cfg), CLASSES, HW)
    eng = IntEngine(model, plan, params, device="cpu")
    return model, plan, params, jmodel, jplan, jip, x, eng.condition_input(x)


def _nchw(wire):
    return wire.permute(0, 3, 1, 2).contiguous().to(torch.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_int_model_and_torchscript_bitwise(case, tmp_path):
    model, plan, params, jmodel, jplan, jip, x, wire = _build(case, tmp_path)
    want = IntEngine(model, plan, params, device="cpu")(wire)
    assert not torch.equal(want[0], want[1])  # non-degenerate
    xt = _nchw(wire)
    cond = condition_input_torch(torch.from_numpy(x).permute(0, 3, 1, 2), plan, model.cfg)
    assert torch.equal(cond, xt)
    assert torch.equal(jax_condition_input_torch(
        torch.from_numpy(x).permute(0, 3, 1, 2), jplan, jmodel.cfg), xt)
    with torch.no_grad():
        got = build_torch_int_model(model, plan, params)(xt)
        ref = jax_build_torch_int_model(jmodel, jplan, jip)(xt)
    assert got.dtype == torch.float32 and got.shape == (2, CLASSES)
    assert torch.equal(got, want) and torch.equal(ref, want)
    path = export_torchscript(model, plan, params, str(tmp_path / "m.pt"), image_size=HW)
    with torch.no_grad():
        assert torch.equal(torch.jit.load(path)(xt), want)


@pytest.mark.parametrize("case", list(CASES))
def test_native_bundle_bytes_and_runtime(case, tmp_path):
    model, plan, params, jmodel, jplan, jip, x, wire = _build(case, tmp_path)
    path = save_native_bundle(str(tmp_path / "port.f8nb"), model, plan, params)
    ref = jax_save_native_bundle(str(tmp_path / "jax.f8nb"), jmodel, jplan, jip)
    with open(path, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    b = load_native_bundle(path)
    assert (b["family"], b["num_classes"], b["quant_avgpool"]) == (
        {"resnet18": 0, "mobilenet_v1": 1, "mobilenet_v2": 2}[model.name], CLASSES, True)
    for rec, p in zip(b["layers"], plan.layers, strict=True):
        assert (rec["input_fl"], rec["weight_fl"], rec["symmetric"]) == (
            p.input_fl, p.weight_fl, p.input_symmetric)
        np.testing.assert_array_equal(rec["w"], params[p.name]["w"].numpy())
        np.testing.assert_array_equal(rec["b"], params[p.name]["b"].numpy())

    if not os.path.exists(INFER_MAIN):
        subprocess.run(["make", "-C", os.path.dirname(INFER_MAIN), "infer_main"],
                       check=False, capture_output=True)
    raw = str(tmp_path / "in.raw")
    wire.to(torch.int32).numpy().tofile(raw)
    out = subprocess.run([INFER_MAIN, path, raw, "2", str(HW), str(HW)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[:300]
    got = np.array([[int(v) for v in ln.split()] for ln in out.stdout.strip().splitlines()])
    want = IntEngine(model, plan, params, device="cpu")(wire)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))


@pytest.mark.parametrize("corrupt", ["magic", "version", "trailing"])
def test_native_bundle_rejects_corrupt_files(corrupt, tmp_path):
    model, plan, params, *_ = _build("mobilenet_v1", tmp_path)
    path = save_native_bundle(str(tmp_path / "m.f8nb"), model, plan, params)
    raw = bytearray(open(path, "rb").read())
    if corrupt == "magic":
        raw[:4] = b"F8NX"
    elif corrupt == "version":
        raw[4:8] = (2).to_bytes(4, "little")
    else:
        raw += b"\0"
    with open(path, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(ValueError, match={"magic": "not an F8NB", "version": "version",
                                          "trailing": "trailing"}[corrupt]):
        load_native_bundle(path)


def test_stem_maxpool_exact_above_2_24(tmp_path, monkeypatch):
    """A head bias of 2^25 + 1 puts every stem output above 2^24, where
    float32 keeps every fourth integer.  The port's module, traced or not,
    equals the engine (K3's pool is exact); the reference's float32 maxpool
    rounds its input, a property of the reference recorded in ROADMAP
    section 3."""
    model, plan, params, jmodel, jplan, jip, x, wire = _build(
        "resnet18", tmp_path, head_bias=2**25 + 1)
    eng = IntEngine(model, plan, params, device="cpu")
    xt = _nchw(wire)
    stem = eng.head(wire).x.permute(0, 3, 1, 2)  # strict: the pooled int32
    assert int(stem.min()) > 2**24 and bool((stem % 4 != 0).any())
    tm = build_torch_int_model(model, plan, params)
    with torch.no_grad():
        got, _ = tm.stem(xt, plan["head"].input_fl)
        assert torch.equal(got, stem)
        want = eng(wire)
        assert torch.equal(tm(xt), want)
        path = export_torchscript(model, plan, params, str(tmp_path / "m.pt"), image_size=HW)
        assert torch.equal(torch.jit.load(path)(xt), want)

    pooled = []
    max_pool2d = torch.nn.functional.max_pool2d

    def spy(v, *args, **kw):
        out = max_pool2d(v, *args, **kw)
        pooled.append(out)
        return out

    monkeypatch.setattr(torch.nn.functional, "max_pool2d", spy)
    with torch.no_grad():
        jax_build_torch_int_model(jmodel, jplan, jip)(xt)
    (ref,) = pooled
    assert ref.dtype == torch.float32
    assert torch.equal(ref, stem.to(torch.float32)) and not torch.equal(ref.int(), stem)
