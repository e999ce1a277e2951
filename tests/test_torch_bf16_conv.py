"""The bf16-operand QAT training conv (`cfg.train_conv_bf16`): the port's
`nn.quant_layers.conv2d_bf16` against the JAX package's `_conv2d_bf16` /
`_conv2d` on the same seeded numpy inputs, on the CPU, where the port runs
its plain version (bfloat16-rounded operands, a float32 conv).

Tolerances, and why:
  * the rounding onto bfloat16's grid: bitwise `astype(jnp.bfloat16)`
    (round to nearest even, ties included);
  * the forward on operands on 8-bit quantization grids (every value exact
    in bfloat16): rtol 2e-6, atol 2e-5 (tests/test_train.py's tolerance for
    the reference's own flagged conv against its float32 conv: the sums
    run in another order);
  * the VJP: within 1e-6 of JAX's in relative L2 norm (measured 3.5e-7 at
    most): both are the float32 conv's gradients of the unrounded operands,
    summed in another order (the port's is bitwise its own float32 conv's);
  * arbitrary (batch-statistics conv) operands: within 1e-5 of the largest
    output (the same exact products, summed in another order);
  * one layer in train and calib mode with the flag: the tolerances of
    tests/test_torch_qat.py (outputs within 1e-5 but at a few flipped
    channels, EMA updates bitwise, BN statistics 1e-5, gradients 1e-4);
  * the model contract of tests/test_train.py::test_train_conv_bf16_model_
    contract on the port: the head's BN mean within 1e-2 and every EMA
    fraclen within 5e-2 relative / 0.1 of the unflagged run after one
    train forward, and the flag-trained bake's IntEngine bitwise its
    int_only=False cross-check;
  * one QAT step with the flag on a (1, 2) mesh of two gloo processes
    (tests/_torch_tp_train_worker.py) against one process: every EMA
    fraclen equal, BN state within 1e-5 of each tensor's largest element.
"""

import contextlib
import io
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)
import _torch_tp_train_worker as worker
from _cli_compare import BASE
from test_torch_qat import (  # noqa: F401  (layers: the fixture)
    CFG, _check_grads, _check_updates, _run_layer, assert_close_but_flips, layers,
)

from f8net_tpu.nn import quant_layers as jql
from f8net_tpu.nn.spec import ConvBNSpec as JaxConvBNSpec
from f8net_tpu_torch import native as port_native
from f8net_tpu_torch import run as port_cli
from f8net_tpu_torch.engine import IntEngine
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.nn import quant_layers as ql
from f8net_tpu_torch.nn.spec import ConvBNSpec
from f8net_tpu_torch.quant import bake_plan
from f8net_tpu_torch.train import Trainer, load_checkpoint, make_train_step, sgd_init
from f8net_tpu_torch.utils import QuantConfig, TrainConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QAT_BN_LIMIT = 1e-5  # tests/test_torch_tp_train.py's

# (name, in, out, kernel, stride, padding, groups, input shape): ResNet's 3x3
# (tests/test_train.py's case), its 7x7/s2 stem, a 1x1/s2 shortcut and
# MobileNetV2's 3x3/s2 depthwise conv
SPECS = {
    "3x3": (32, 48, 3, 1, 1, 1, (2, 16, 16, 32)),
    "stem": (3, 16, 7, 2, 3, 1, (2, 20, 20, 3)),
    "1x1s2": (24, 40, 1, 2, 0, 1, (2, 9, 9, 24)),
    "dw": (24, 24, 3, 2, 1, 24, (2, 11, 11, 24)),
}


def _specs(key):
    ci, co, k, s, p, g, shape = SPECS[key]
    kw = dict(name="t", in_ch=ci, out_ch=co, kernel=(k, k), stride=(s, s), padding=(p, p),
              groups=g)
    return JaxConvBNSpec(**kw), ConvBNSpec(**kw), shape


def _grid_operands(key, seed=3):
    """x = k * 2^-8 with k in [0, 255], w = k * 2^-7 with |k| <= 127: exact in
    bfloat16."""
    _, ps, shape = _specs(key)
    rng = np.random.RandomState(seed)
    x = (rng.randint(0, 256, shape) / 256.0).astype(np.float32)
    w = (rng.randint(-127, 128, ps.weight_shape()) / 128.0).astype(np.float32)
    return x, w


def _free_operands(key, seed=4):
    _, ps, shape = _specs(key)
    rng = np.random.RandomState(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            (rng.standard_normal(ps.weight_shape()) * 0.1).astype(np.float32))


def _port(x, w, key, grad=False):
    _, ps, _ = _specs(key)
    tx, tw = torch.tensor(x, requires_grad=grad), torch.tensor(w, requires_grad=grad)
    return ql.conv2d_bf16(tx, tw, ps), tx, tw


@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e30, 3.7e-39])
def test_bf16_round_is_xla_convert(scale):
    """bf16_round against astype(jnp.bfloat16) on random values, exact ties
    (odd and even upper halves), values next to them, signed zeros and
    bfloat16 overflow, at several scales (subnormals at 3.7e-39)."""
    rng = np.random.RandomState(int(np.log10(scale) + 100))
    x = (rng.standard_normal(4096) * scale).astype(np.float32)
    bits = rng.randint(0, 1 << 16, 1024).astype(np.uint32) << 16
    ties = (bits | 0x8000).view(np.float32)
    near = np.concatenate([(bits | 0x7FFF).view(np.float32), (bits | 0x8001).view(np.float32)])
    extra = np.array([0.0, -0.0, 3.4e38, -3.4e38, 1.0, -1.0], np.float32)
    x = np.concatenate([x, ties, near, extra])
    x = x[np.isfinite(x)]
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    got = ql.bf16_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("key", list(SPECS))
def test_forward_on_grid_operands_matches_jax(key):
    """Grid operands: the port's flagged conv against JAX's _conv2d_bf16 and
    its float32 _conv2d within rtol 2e-6, atol 2e-5."""
    js, _, _ = _specs(key)
    x, w = _grid_operands(key)
    got = _port(x, w, key)[0].numpy()
    for fn in (jql._conv2d_bf16, jql._conv2d):
        want = np.asarray(fn(jnp.asarray(x), jnp.asarray(w), js))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-5, err_msg=fn.__name__)


def _vjp_port(x, w, key, g=None, fn=ql.conv2d_bf16):
    """(gx, gw, the cotangent) of the port's `fn` at x, w."""
    _, ps, _ = _specs(key)
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    y = fn(tx, tw, ps)
    if g is None:
        g = np.random.RandomState(5).standard_normal(tuple(y.shape)).astype(np.float32)
    (y * torch.from_numpy(g)).sum().backward()
    return tx.grad, tw.grad, g


@pytest.mark.parametrize("key", list(SPECS))
def test_vjp_is_the_float32_convs(key):
    """On grid and on arbitrary operands, with an arbitrary cotangent, the
    VJP of the flagged conv against JAX's (its custom float32 backward)
    within 1e-6 in relative L2.  On arbitrary operands, bitwise the port's
    float32 conv's VJP at the unrounded operands, and not the VJP at the
    rounded ones."""
    js, _, _ = _specs(key)
    for x, w in (_grid_operands(key), _free_operands(key)):
        gx, gw, g = _vjp_port(x, w, key)
        _, vjp = jax.vjp(lambda a, b: jql._conv2d_bf16(a, b, js), jnp.asarray(x),
                         jnp.asarray(w))
        for got, want in zip((gx.numpy(), gw.numpy()), vjp(jnp.asarray(g))):
            want = np.asarray(want)
            assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)
    fx, fw, _ = _vjp_port(x, w, key, g, ql.conv2d_nhwc)
    assert torch.equal(gx, fx) and torch.equal(gw, fw)
    rw = _vjp_port(ql.bf16_round(torch.from_numpy(x)).numpy(),
                   ql.bf16_round(torch.from_numpy(w)).numpy(), key, g, ql.conv2d_nhwc)[1]
    assert not torch.equal(gw, rw)


@pytest.mark.parametrize("key", list(SPECS))
def test_stat_conv_operands_match_jax(key):
    """Arbitrary operands (the batch-statistics conv reads fix_scaling * x):
    the port within 1e-5 of the largest output of JAX's flagged conv, and
    as far from the float32 conv as bfloat16 operand rounding puts it."""
    js, _, _ = _specs(key)
    x, w = _free_operands(key)
    got = _port(x, w, key)[0].numpy()
    want = np.asarray(jql._conv2d_bf16(jnp.asarray(x), jnp.asarray(w), js))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    f32 = np.asarray(jql._conv2d(jnp.asarray(x), jnp.asarray(w), js))
    assert 1e-5 < np.abs(got - f32).max() / scale < 2e-2


@pytest.mark.parametrize("mode", ["train", "calib"])
@pytest.mark.parametrize("name", ["a", "b", "c"])
def test_layer_with_flag_matches_jax(layers, mode, name):
    """conv_bn_apply with train_conv_bf16 on tests/test_torch_qat.py's
    layers (a dense 3x3, a depthwise 3x3/s2, a double-side 1x1) against
    JAX's with the flag: output, EMA and BN updates, and in train mode the
    STE gradients.  The flag is live: the BN statistics move against the
    port's unflagged layer."""
    jg, pg, params, state, xs = layers
    cfg = dict(CFG, train_conv_bf16=True)
    what = f"{name} {mode} bf16"
    jy, jupd, jgr, py, pupd, pgr = _run_layer(jg, pg, name, params, state, xs[name], mode, cfg,
                                               grad=mode == "train")
    _check_updates(jupd, pupd, what)
    assert_close_but_flips(py.x, jy.x, what)
    if mode == "train":
        _check_grads(jgr, pgr, name, what)
    off = _run_layer(jg, pg, name, params, state, xs[name], mode, CFG, grad=False)[4]
    assert not torch.equal(off[name]["bn_mean"], pupd[name]["bn_mean"]), what


MODEL_CFG = dict(format_from_metric=True, metric="std", quant_bias=True, quant_avgpool=True,
                 pool_fusing=True)


def test_model_contract_with_flag():
    """tests/test_train.py::test_train_conv_bf16_model_contract on the port:
    one train forward of a ResNet-18 (10 classes, 32 px) with and without
    the flag from one init; the head's BN mean and every EMA fraclen close;
    two more flagged forwards, the bake, and the strict IntEngine bitwise
    its int_only=False cross-check."""
    x = torch.round(255 * torch.from_numpy(
        np.random.RandomState(1).rand(4, 32, 32, 3).astype(np.float32))) / 256
    results = {}
    for flag in (False, True):
        cfg = QuantConfig(**MODEL_CFG, train_conv_bf16=flag)
        model = get_model("resnet18", cfg, num_classes=10, image_size=32)
        params, state = model.init(torch.Generator().manual_seed(0), device="cpu")
        with torch.no_grad():
            _, state = model.apply(params, state, x, mode="train")
        results[flag] = (model, params, state)
    s32, sb16 = results[False][2], results[True][2]
    np.testing.assert_allclose(sb16["head"]["bn_mean"].numpy(), s32["head"]["bn_mean"].numpy(),
                               rtol=1e-2, atol=1e-2)
    assert not torch.equal(sb16["head"]["bn_mean"], s32["head"]["bn_mean"])
    for lname, sub in s32.items():
        np.testing.assert_allclose(sb16[lname]["input_fl_ema"].numpy(),
                                   sub["input_fl_ema"].numpy(), rtol=5e-2, atol=0.1,
                                   err_msg=lname)
    model, params, state = results[True]
    with torch.no_grad():
        for _ in range(2):
            _, state = model.apply(params, state, x, mode="train")
    plan, int_params = bake_plan(model, params, state)
    ei = IntEngine(model, plan, int_params, device="cpu")
    es = IntEngine(model, plan, int_params, device="cpu", int_only=False)
    xe = torch.round(255 * torch.from_numpy(
        np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32))) / 256
    got = ei(ei.condition_input(xe))
    assert torch.equal(got, es(es.condition_input(xe)))
    assert not torch.equal(got[0], got[1])


def test_trainer_steps_with_flag():
    """The Trainer on the CPU with the flag: two steps on one batch, the
    loss finite, every conv weight moved, the flagged conv's backward
    reached (a conv's gradient is that of the float32 conv of the
    unrounded operands: tested above)."""
    tcfg = TrainConfig(batch_size=4, lr=0.01, lr_scheduler="constant", weight_decay=0.0,
                       topk=(1,), num_classes=10)
    cfg = QuantConfig(**MODEL_CFG, train_conv_bf16=True)
    model = get_model("mobilenet_v1", cfg, num_classes=10, image_size=32)
    tr = Trainer(model, model.cfg, tcfg, log=lambda *a: None, device="cpu")
    params, state, opt = tr.init(torch.Generator().manual_seed(0))
    before = {l: sub["w"].clone() for l, sub in params.items()}
    rng = np.random.RandomState(0)
    batch = (rng.rand(4, 32, 32, 3).astype(np.float32), rng.randint(0, 10, 4).astype(np.int32))
    params, state, opt, res = tr.run_epoch(params, state, opt, [batch, batch], 0, 2, "train")
    assert np.isfinite(res["loss"])
    assert all(not torch.equal(params[l]["w"], w) for l, w in before.items())


def test_cli_trains_with_flag(tmp_path, monkeypatch):
    """run.main on the CPU trains an epoch of tests/_cli_compare.py's
    scenario with `train_conv_bf16: True` in the YAML: the flag reaches the
    model's config and its convs, the epoch's loss is finite and the
    checkpoint is written."""
    monkeypatch.setattr(port_native, "imageops_available", lambda: False)
    flags = dict(BASE, train_conv_bf16=True, log_dir=str(tmp_path / "log"))
    path = tmp_path / "bf16.yml"
    path.write_text(yaml.safe_dump(flags))
    seen = []
    real = ql.conv2d_bf16
    monkeypatch.setattr(ql, "conv2d_bf16", lambda *a: seen.append(1) or real(*a))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_cli.main([f"app:{path}", f"bs:{flags['batch_size']}"], device="cpu")
    lines = buf.getvalue().splitlines()
    assert "Start training." in lines and seen
    loss = [ln for ln in lines if "\ttrain\t0/1: loss: " in ln]
    assert loss and np.isfinite(float(loss[0].split("loss: ")[1].split()[0].rstrip(",")))
    trees, meta = load_checkpoint(str(tmp_path / "log" / "latest_checkpoint"))
    assert meta["last_epoch"] == 1 and set(trees) == {"params", "state", "opt_momentum"}


# -- one flagged QAT step on a (1, 2) mesh ---------------------------------------


@pytest.fixture(scope="module")
def mesh_step(tmp_path_factory):
    """Both ranks' results of the flagged QAT step on (1, 2), and one
    process's step on the same global batch."""
    out = tmp_path_factory.mktemp("bf16_tp")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests",
                                                            "_torch_tp_train_worker.py"),
                               str(port), str(r), "2", str(out), "bf16"],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        model, (params, state) = worker.init(worker.QAT_BF16)
        step = make_train_step(model, model.cfg, TrainConfig(**worker.TRAIN_KW))
        images, labels = worker.global_batch(1)
        _, ref_state, _, ref_m = step(params, state, sgd_init(params), torch.from_numpy(images),
                                      torch.from_numpy(labels), 0.01)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:  # exact-PID cleanup only
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"{p.args[2:5]} failed:\n{log[-4000:]}"
    ranks = [torch.load(out / f"w2-rank{r}.pt", weights_only=False)[(1, 2)] for r in range(2)]
    return ranks, ref_state, {k: float(v) for k, v in ref_m.items()}


def test_tp_step_with_flag_matches_one_process(mesh_step):
    """The flagged QAT step with params out-channel sharded over two gloo
    ranks (the flagged conv on each rank's slice of every cut layer)
    against one process with the flag: every fraclen EMA equal, BN state
    within QAT_BN_LIMIT of each tensor's largest element, the metrics'
    row count the global batch's; both ranks' gathered params, state and
    momentum bitwise alike."""
    ranks, ref_state, ref_m = mesh_step
    _, state, _, m, digests = ranks[0]["qat_bf16_steps"][0]
    assert m["n"] == ref_m["n"] == worker.GLOBAL_BATCH
    for lname, sub in ref_state.items():
        assert torch.equal(state[lname]["input_fl_ema"], sub["input_fl_ema"]), lname
        for k in ("bn_mean", "bn_var"):
            if k in sub:
                scale = float(sub[k].abs().max())
                assert float((state[lname][k] - sub[k]).abs().max()) <= QAT_BN_LIMIT * scale, (
                    lname, k)
    assert ranks[1]["qat_bf16_steps"][0][4] == digests
    assert ranks[1]["qat_bf16_steps"][0][3] == m
