"""The port's training stack against the JAX package's: LR schedules, decay
masks, the SGD update, the loss and top-k counts, a whole train step, the
Trainer, and checkpoints in both directions.

Tolerances: the schedules, the decay masks, the top-k counts and the
checkpoint files are exact.  `sgd_update` is bitwise against the JAX one
run op by op (each elementwise op its own XLA computation, as the port's
are), and within four float32 roundings of its terms of the jitted one,
where XLA's CPU backend may fuse a multiply and an add into one rounding.  The loss is within 1e-6
relative (log_softmax's sums run in another order).  A whole train step is
compared under `floating_wo_clip`, the smooth float baseline: params,
momentum and BN state within float32 tolerances stated at the test (the
QAT forward at random init is chaotic end to end: one ulp of input moves
its logits by more than a tenth).  Under the quantized config the port's
update given JAX's gradients is the JAX update, bit for bit.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.train import checkpoint as jax_checkpoint
from f8net_tpu.train import loop as jax_loop
from f8net_tpu.train import optim as jax_optim
from f8net_tpu.train.schedules import lr_schedule as jax_lr_schedule
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu.utils.config import TrainConfig as JaxTrainConfig
from f8net_tpu_torch.export import qat_from_numpy, qat_to_numpy, tensors_from_numpy
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.train import (
    AsyncCheckpointer, SGDState, Trainer, cross_entropy_loss, load_checkpoint, lr_schedule,
    make_train_step, save_checkpoint, sgd_init, sgd_update, topk_correct, weight_decay_mask,
)
from f8net_tpu_torch.train import checkpoint as port_checkpoint
from f8net_tpu_torch.utils import QuantConfig, TrainConfig

QAT = dict(format_from_metric=True, metric="std")
SCHEDULES = ("constant", "multistep", "multistep_iter", "exp_decaying", "exp_decaying_iter",
             "linear_decaying", "cos_annealing", "cos_annealing_iter")


def _np_tree(tree):
    return {k: {kk: np.asarray(v) for kk, v in d.items()} for k, d in tree.items()}


def _torch_tree(tree):
    return {k: {kk: torch.from_numpy(np.array(v)) for kk, v in d.items()}
            for k, d in tree.items()}


def _port_init(name, cfg, classes=10, size=32, seed=0):
    model = get_model(name, QuantConfig(**cfg), num_classes=classes, image_size=size)
    return model, model.init(torch.Generator().manual_seed(seed), device="cpu")


def test_train_config_fields_match():
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(TrainConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JaxTrainConfig)]


@pytest.mark.parametrize("name", SCHEDULES)
def test_lr_schedule_equals_jax(name):
    """Every step of 6 epochs of 10 steps: the warmup (2 epochs at batch
    1024), milestones at epochs 1 and 3, decays per epoch and per 2 epochs."""
    kw = dict(num_epochs=6, warmup_epochs=2, batch_size=1024, lr_scheduler=name,
              multistep_lr_milestones=(1, 3), multistep_lr_gamma=0.3,
              exp_decaying_lr_gamma=0.9, exp_decaying_period=2)
    port, ref = lr_schedule(TrainConfig(**kw), 10), jax_lr_schedule(JaxTrainConfig(**kw), 10)
    got, want = [port(i) for i in range(60)], [ref(i) for i in range(60)]
    assert got == want
    assert name == "constant" or len(set(got)) >= 3  # the span moves every other schedule


@pytest.mark.parametrize("name", ["mobilenet_v1", "resnet18"])
@pytest.mark.parametrize("scheme", ["all", "only_no_depthwise", "only_no_bn",
                                    "no_depthwise_no_bn"])
def test_weight_decay_mask_equals_jax(name, scheme):
    model, (params, _) = _port_init(name, QAT)
    jmodel = jax_get_model(name, JaxQuantConfig(**QAT), 10, 32)
    got = weight_decay_mask(model.graph, params, scheme, 4e-5)
    want = jax_optim.weight_decay_mask(jmodel.graph, qat_to_numpy(params, {})[0], scheme, 4e-5)
    assert got == want
    if name == "mobilenet_v1" and scheme == "only_no_depthwise":
        assert got["stage_0_layer_0.body.0"]["w"] == 0.0  # the depthwise conv
        assert got["stage_0_layer_0.body.1"]["w"] == 4e-5


def _random_sgd_inputs(seed):
    """Params, grads and momentum of ResNet-18-like shapes, values spread
    over a few decades, and a mask with decay on most leaves."""
    rng = np.random.RandomState(seed)
    shapes = {"conv": {"w": (3, 3, 16, 32), "alpha": (), "gamma": (32,), "beta": (32,)},
              "fc": {"w": (32, 10), "alpha": (), "bias": (10,)}}

    def draw():
        return {lname: {k: (rng.randn(*s) * 10.0 ** rng.uniform(-3, 1, s)).astype(np.float32)
                        for k, s in sub.items()} for lname, sub in shapes.items()}

    mask = {lname: {k: (0.0 if k == "alpha" else 4e-5) for k in sub}
            for lname, sub in shapes.items()}
    return draw(), draw(), draw(), mask


@pytest.mark.parametrize("nesterov", [True, False])
def test_sgd_update_bitwise_against_jax(nesterov):
    params, grads, bufs, mask = _random_sgd_inputs(3 + nesterov)
    lr, mu = 0.0375, 0.9
    jp, js = jax_optim.sgd_update(params, grads, jax_optim.SGDState(bufs), lr, mask, mu, nesterov)
    p, m = _torch_tree(params), _torch_tree(bufs)
    out_p, out_s = sgd_update(p, _torch_tree(grads), SGDState(m), lr, mask, mu, nesterov)
    assert out_p is p and out_s.momentum is m  # in place
    for lname, sub in params.items():
        for k in sub:
            np.testing.assert_array_equal(p[lname][k].numpy(), np.asarray(jp[lname][k]))
            np.testing.assert_array_equal(m[lname][k].numpy(), np.asarray(js.momentum[lname][k]))
    # the jitted reference may fuse a multiply and an add into one rounding:
    # each of its results lies within a few float32 roundings of the terms
    # that make it (a fused op under cancellation can be many ulps of the
    # result away, never more than that)
    jit_p, jit_s = jax.jit(jax_optim.sgd_update, static_argnums=(5, 6))(
        params, grads, jax_optim.SGDState(bufs), lr, mask, mu, nesterov)
    eps = float(np.finfo(np.float32).eps)
    for lname, sub in params.items():
        for k, p0 in sub.items():
            terms_buf = mu * np.abs(bufs[lname][k]) + np.abs(grads[lname][k]) + mask[lname][k] * np.abs(p0)
            terms_p = np.abs(p0) + lr * (1 + mu) * terms_buf
            assert np.all(np.abs(m[lname][k].numpy() - np.asarray(jit_s.momentum[lname][k]))
                          <= 4 * eps * terms_buf), (lname, k)
            assert np.all(np.abs(p[lname][k].numpy() - np.asarray(jit_p[lname][k]))
                          <= 4 * eps * terms_p), (lname, k)


def test_sgd_update_missing_grad_is_zero():
    p = {"l": {"w": torch.tensor([1.0, -2.0]), "alpha": torch.tensor(8.0)}}
    st = sgd_init(p)
    sgd_update(p, {"l": {"w": torch.tensor([0.5, 0.5]), "alpha": None}}, st, 0.1,
               {"l": {"w": 0.0, "alpha": 0.0}}, 0.9, True)
    assert float(p["l"]["alpha"]) == 8.0 and float(st.momentum["l"]["alpha"]) == 0.0
    # g = 0.5, buf = 0.5, d = 0.5 + 0.9 * 0.5 = 0.95
    np.testing.assert_array_equal(p["l"]["w"].numpy(),
                                  np.float32([1.0, -2.0]) - np.float32(0.1) * np.float32(0.95))


def test_loss_and_topk_against_jax():
    rng = np.random.RandomState(0)
    logits = (rng.randn(64, 16) * 5).astype(np.float32)
    labels = rng.randint(0, 16, 64).astype(np.int32)
    got = float(cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    want = float(jax_loop.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)
    got = topk_correct(torch.from_numpy(logits), torch.from_numpy(labels), (1, 5))
    want = jax_loop.topk_correct(jnp.asarray(logits), jnp.asarray(labels), (1, 5))
    assert {k: int(v) for k, v in got.items()} == {k: int(v) for k, v in want.items()}
    assert 0 < int(got[1]) < int(got[5]) < 64


def _batch(seed, n=4, size=32, classes=10):
    rng = np.random.RandomState(seed)
    return rng.rand(n, size, size, 3).astype(np.float32), rng.randint(0, classes, n).astype(np.int32)


def test_float_train_step_matches_jax():
    """One train step of a ResNet-18 at 16 px, batch 16, under
    floating_wo_clip (weight decay 4e-5, nesterov, lr 0.01) on the same
    params, state and images.  The differences are float32 sums in other
    orders; on these inputs the largest measured are 2.1e-6 relative in
    the loss, 1.7e-6 of a BN running statistic's largest element, and
    2.8e-5 of the largest element of a tensor's update (p - p') or
    momentum.  The limits sit above them: 1e-5, 1e-5 and 1e-4.  (The step
    is smooth but for ReLU's kink: on other images a pre-activation that
    lies within rounding of 0 can take the other side and move a
    gradient by percents, which no float tolerance separates from a
    fault.)"""
    cfg = dict(floating_wo_clip=True)
    model, (params, state) = _port_init("resnet18", cfg, size=16)
    params_np, state_np = qat_to_numpy(params, state)
    tkw = dict(lr=0.01, weight_decay=4e-5, momentum=0.9, nesterov=True, topk=(1,))
    jmodel = jax_get_model("resnet18", JaxQuantConfig(**cfg), 10, 16)
    jstep = jax_loop.make_train_step(jmodel, jmodel.cfg, JaxTrainConfig(**tkw))
    images, labels = _batch(1, n=16, size=16)
    jp, jstate, jopt, jm = jstep(
        jax.tree.map(jnp.asarray, params_np), jax.tree.map(jnp.asarray, state_np),
        jax_optim.sgd_init(jax.tree.map(jnp.asarray, params_np)), jnp.asarray(images),
        jnp.asarray(labels), 0.01)
    step = make_train_step(model, model.cfg, TrainConfig(**tkw))
    p, s, opt, m = step(params, state, sgd_init(params), torch.from_numpy(images),
                        torch.from_numpy(labels), 0.01)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    assert int(m["top1"]) == int(jm["top1"]) and int(m["n"]) == 16

    def close(got, want, rtol, what):
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale, err_msg=what)

    moved = 0
    for lname, sub in params_np.items():
        for k, p0 in sub.items():
            want_step = p0 - np.asarray(jp[lname][k])
            close(p0 - p[lname][k].numpy(), want_step, 1e-4, f"{lname}/{k} update")
            close(opt.momentum[lname][k].numpy(), np.asarray(jopt.momentum[lname][k]), 1e-4,
                  f"{lname}/{k} momentum")
            moved += bool(np.any(want_step != 0))
    for lname, sub in state_np.items():
        for k in sub:
            close(s[lname][k].numpy(), np.asarray(jstate[lname][k]), 1e-5, f"{lname}/{k}")
    assert moved > 40  # the step changed most tensors
    assert not any(t.requires_grad for sub in p.values() for t in sub.values())


def test_quantized_update_from_jax_grads_is_bitwise():
    """Under the quantized config: JAX's gradients of one train-mode
    forward of a ResNet-18 (16 px, batch 2), fed to both packages'
    sgd_update with JAX's momentum after that step: the same params and
    momentum, bit for bit."""
    model, (params, state) = _port_init("resnet18", QAT, size=16)
    params_np, state_np = qat_to_numpy(params, state)
    jmodel = jax_get_model("resnet18", JaxQuantConfig(**QAT), 10, 16)
    images, labels = _batch(2, n=2, size=16)
    x = jnp.round(255.0 * jnp.asarray(images)) / 256.0

    def loss_fn(p):
        logits, _ = jmodel.forward(p, jax.tree.map(jnp.asarray, state_np), x, "train", jmodel.cfg)
        return jax_loop.cross_entropy_loss(logits, jnp.asarray(labels))

    grads = _np_tree(jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray, params_np)))
    assert sum(np.abs(g).sum() > 0 for sub in grads.values() for g in sub.values()) > 40
    mask = jax_optim.weight_decay_mask(jmodel.graph, params_np, "all", 4e-5)
    bufs = _np_tree(jax.tree.map(lambda g: 0.5 * g, grads))
    jp, js = jax_optim.sgd_update(params_np, grads, jax_optim.SGDState(bufs), 0.05, mask)
    p, m = _torch_tree(params_np), _torch_tree(bufs)
    sgd_update(p, _torch_tree(grads), SGDState(m), 0.05, mask)
    for lname, sub in params_np.items():
        for k in sub:
            np.testing.assert_array_equal(p[lname][k].numpy(), np.asarray(jp[lname][k]))
            np.testing.assert_array_equal(m[lname][k].numpy(), np.asarray(js.momentum[lname][k]))


def test_trainer_overfits_tiny_batch():
    """The port's Trainer on the CPU: six epochs over two fixed batches of
    a 16-class ResNet-18 under the configs' fix_quant flags, constant lr,
    the loss falls (as tests/test_train.py's JAX one does);
    finetune_iters caps the batches, print_each_iter logs every one."""
    tcfg = TrainConfig(num_epochs=6, batch_size=4, lr=0.01, lr_scheduler="constant",
                       weight_decay=0.0, topk=(1,), num_classes=16)
    cfg = QuantConfig(**QAT, quant_bias=True, quant_avgpool=True, pool_fusing=True)
    model = get_model("resnet18", cfg, num_classes=16, image_size=32)
    lines = []
    tr = Trainer(model, model.cfg, tcfg, log=lines.append, device="cpu")
    params, state, opt = tr.init(torch.Generator().manual_seed(0))
    batches = [_batch(i, classes=16) for i in (1, 2)]
    losses = []
    for epoch in range(6):
        params, state, opt, res = tr.run_epoch(params, state, opt, batches, epoch, 2, "train")
        losses.append(res["loss"])
    assert losses[-1] < 0.5 * losses[0], losses
    _, _, _, res = tr.run_epoch(params, state, opt, batches, 0, 2, "val")
    assert 0.0 <= res["top1_error"] <= 1.0 and lines[-1].split("\t")[1] == "val"
    tr = Trainer(model, model.cfg, tcfg.replace(finetune_iters=1, print_each_iter=True, lr=0.0),
                 log=lines.append, device="cpu")
    before = qat_to_numpy(params, state)[0]
    params, _, _, _ = tr.run_epoch(params, state, opt, batches, 0, 2, "train")
    assert len([ln for ln in lines if ln.startswith("top1 err: ")]) == 1
    after = qat_to_numpy(params, state)[0]
    for lname, sub in before.items():  # lr 0 and no decay: params unchanged
        for k, v in sub.items():
            np.testing.assert_array_equal(after[lname][k], v)


def test_checkpoints_cross_packages(tmp_path):
    """A port checkpoint loads in the JAX package and a JAX one in the
    port: the same keys, the arrays bitwise, the sidecar equal; the trees
    go back onto a device with qat_from_numpy / tensors_from_numpy."""
    model, (params, state) = _port_init("mobilenet_v1", QAT, size=16)
    opt = sgd_init(params)
    for sub in opt.momentum.values():
        for t in sub.values():
            t.normal_(generator=torch.Generator().manual_seed(5))
    trees = {"params": params, "state": state, "opt_momentum": opt.momentum}
    meta = {"last_epoch": 3, "best_val": 0.25}
    path = save_checkpoint(str(tmp_path / "port" / "latest_checkpoint"), trees, meta)
    jtrees, jmeta = jax_checkpoint.load_checkpoint(path[:-4])
    assert jmeta == meta
    with np.load(path) as z:
        keys = sorted(z.files)
    assert keys == sorted(f"{name}/{l}/{k}" for name, t in trees.items() for l, sub in t.items()
                          for k in sub)
    for name, tree in trees.items():
        for lname, sub in tree.items():
            for k, t in sub.items():
                np.testing.assert_array_equal(jtrees[name][lname][k], t.numpy())
    # and back: the JAX writer's file in the port
    jpath = jax_checkpoint.save_checkpoint(str(tmp_path / "jax" / "ck"), jtrees, meta)
    ptrees, pmeta = load_checkpoint(jpath)
    assert pmeta == meta
    qp, qs = qat_from_numpy(ptrees["params"], ptrees["state"], device="cpu")
    mom = tensors_from_numpy(ptrees["opt_momentum"], device="cpu")
    for got, want in ((qp, params), (qs, state), (mom, opt.momentum)):
        for lname, sub in want.items():
            for k, t in sub.items():
                assert got[lname][k].dtype == t.dtype and torch.equal(got[lname][k], t)


def test_async_checkpointer(tmp_path):
    """Stale queued saves of a path are superseded, distinct paths all land,
    and a save is a copy: an in-place update after save() (the next SGD
    step) does not reach the file."""
    ck = AsyncCheckpointer()
    gate = threading.Event()
    real_write = port_checkpoint._write

    def slow_write(*a):
        gate.wait(10)
        real_write(*a)

    port_checkpoint._write = slow_write
    try:
        path = str(tmp_path / "latest")
        ck.save(str(tmp_path / "first"), {"x": torch.zeros(2)})  # holds the worker
        w = torch.zeros(8, 8)
        for epoch in range(4):
            w.fill_(float(epoch))
            ck.save(path, {"params": {"w": w}}, meta={"last_epoch": epoch})
        w.fill_(99.0)  # after the last save: must not reach the file
        gate.set()
        ck.wait()
    finally:
        port_checkpoint._write = real_write
    trees, meta = load_checkpoint(path)
    assert meta == {"last_epoch": 3}
    np.testing.assert_array_equal(trees["params"]["w"], np.full((8, 8), 3, np.float32))
    for name in ("a", "b"):
        ck.save(str(tmp_path / name), {"x": np.arange(3)}, meta={"n": name})
    ck.close()
    for name in ("a", "b"):
        assert load_checkpoint(str(tmp_path / name))[1] == {"n": name}


def test_async_checkpointer_surfaces_errors(tmp_path, monkeypatch):
    ck = AsyncCheckpointer()

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(port_checkpoint.np, "savez", boom)
    ck.save(str(tmp_path / "x"), {"x": np.arange(2)})
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    monkeypatch.undo()  # the checkpointer stays usable after the error
    ck.save(str(tmp_path / "y"), {"x": np.arange(2)})
    ck.close()
    np.testing.assert_array_equal(load_checkpoint(str(tmp_path / "y"))[0]["x"], np.arange(2))
    assert not os.path.exists(str(tmp_path / "x.npz"))
