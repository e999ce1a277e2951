"""The port's QAT forward -- `ops.fxp.ste_quant` and the fraclen rules,
`nn.quant_layers.conv_bn_apply` / `linear_apply` and the models' train-mode
forward -- against the JAX package's, on the CPU.

Tolerances, and why:
  * ste_quant's forward and its gradient mask, metric2fraclen (random
    metrics and metrics at exact powers of two) and fraclen_gridsearch:
    bitwise.  One ulp off a power of two, XLA's float32 log2 itself rounds
    some quotients the wrong way; the port takes the log2 in float64, and
    there the test holds both to the exact floor and names the reference's
    misses.
  * A layer on the same input, params and state: EMA updates bitwise (the
    JAX layer runs op by op, as a jitted one would fuse the EMA's multiply
    and add); BN statistics within 1e-5 relative (the conv's float32 sums
    run in another order).  Outputs within 1e-5 of their largest value at
    all but 5% of the output channels (at least one) and 1e-2 in relative
    L2: a BN scale one ulp off can move a folded weight across a rounding
    boundary, and that weight's output channel then parts by one weight
    step.  Eval and calib outputs,
    whose folded weights do not depend on this batch, within 1e-5 of their
    largest value everywhere; the integer simulation (int_infer) within
    2e-6 relative (XLA's float32 exp2 is not exact at 2^13 and up, so the
    reference's bias and output scales part from the powers of two by up
    to 1e-6; the integers agree).
  * STE gradients of a scalar loss through one layer: 1e-4 relative L2
    for weights, BN parameters and the input; alpha's gradient, which the
    BatchNorm cancels analytically, within 1e-4 of the weight gradient's
    norm.
  * The whole train-mode forward of ResNet-18 and MobileNetV1 at 32 px is
    compared layer by layer, each of the port's layers against the JAX
    layer on the port's own input and state (the EMA fraclens, BN stats,
    activations and logits above).  End to end the forward amplifies any
    float32 difference: the reference's own logits move by more than a
    tenth when its input moves by one ulp (test_reference_train_forward_
    is_sensitive), so no tolerance on the end-to-end values means anything.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.nn import quant_layers as jql
from f8net_tpu.nn.spec import ConvBNSpec as JaxConvBNSpec
from f8net_tpu.nn.spec import LayerGraph as JaxLayerGraph
from f8net_tpu.nn.spec import LinearSpec as JaxLinearSpec
from f8net_tpu.ops import fxp as jfxp
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu_torch.export import qat_from_numpy, qat_to_numpy
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.nn import quant_layers as ql
from f8net_tpu_torch.nn import runner as port_runner
from f8net_tpu_torch.nn.spec import ConvBNSpec, LayerGraph, LinearSpec
from f8net_tpu_torch.ops import fxp
from f8net_tpu_torch.quant import reset_bn_for_calib
from f8net_tpu_torch.utils import QuantConfig

CFG = dict(format_from_metric=True, metric="std", quant_bias=True)
MODEL_CFG = dict(CFG, quant_avgpool=True, pool_fusing=True)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree, grad=False):
    return {k: {kk: torch.tensor(np.asarray(v), requires_grad=grad) for kk, v in d.items()}
            for k, d in tree.items()}


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def assert_close_but_flips(got, want, what):
    """Within 1e-5 of the largest |want| but in at most 5% of the output
    channels (at least one), and 1e-2 in relative L2: where a folded weight
    crossed a rounding boundary, its channel parts by one weight step."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    far = (np.abs(got - want) > 1e-5 * np.abs(want).max()).reshape(-1, got.shape[-1])
    channels = int(far.any(0).sum())
    assert channels <= max(1, 0.05 * got.shape[-1]), (what, channels, int(far.sum()))
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want), what


# -- fixed-point primitives -------------------------------------------------------


def _quant_inputs(rng, fl):
    """Random values, exact ties (k + 1/2) / 2^fl, the clamp edges and 0."""
    x = rng.standard_normal((6, 5, 4)).astype(np.float32) * 60 / 2.0**fl
    ties = (rng.randint(-300, 300, (6, 5, 4)) + 0.5) / 2.0**fl
    edges = np.array([127, 128, -127, -128, 255, 256, 0, -0.4], np.float32) / 2.0**fl
    x.reshape(-1)[:40] = ties.reshape(-1)[:40]
    x.reshape(-1)[40:48] = edges
    return x.astype(np.float32)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("floating", [False, True])
def test_ste_quant_forward_and_gradient_mask(signed, per_channel, floating):
    rng = np.random.RandomState(1 + 2 * signed + per_channel)
    x = _quant_inputs(rng, 5)
    fl = np.array([3, 5, 7, 0], np.float32) if per_channel else np.array([5.0], np.float32)
    axis = 2
    g = rng.standard_normal(x.shape).astype(np.float32)
    want, mask = jfxp.fix_quant(jnp.asarray(x), 8, jnp.asarray(fl), axis, signed, floating)
    grad = jax.grad(lambda v: jnp.sum(jfxp.ste_quant(v, jnp.asarray(fl), 8, axis, signed, floating)
                                      * g))(jnp.asarray(x))
    tx, tfl = torch.tensor(x, requires_grad=True), torch.tensor(fl, requires_grad=True)
    got = fxp.ste_quant(tx, tfl, 8, axis, signed, floating)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(grad))
    np.testing.assert_array_equal(fxp.fix_quant(tx, 8, tfl, axis, signed, floating)[1].numpy(),
                                  np.asarray(mask))
    assert tfl.grad is None  # no gradient to the fraclen


def _exact_floor_log2(q: np.ndarray) -> np.ndarray:
    """floor(log2(q)) of float32 quotients, exactly (frexp's exponent)."""
    return np.array([math.frexp(float(v))[1] - 1 for v in q], np.float32)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("metric", ["std", "mae", "rms"])
def test_metric2fraclen(signed, metric):
    coeff = (fxp.SIGNED_COEFF if signed else fxp.UNSIGNED_COEFF)[metric]
    assert coeff == (jfxp.SIGNED_COEFF if signed else jfxp.UNSIGNED_COEFF)[metric]
    top = 8 - int(signed)
    rng = np.random.RandomState(3)
    exact = (np.float32(coeff) / (2.0 ** np.arange(-2, 12))).astype(np.float32)
    rand = rng.lognormal(0, 3, 20000).astype(np.float32)
    for vals in (rand, exact):
        want = np.asarray(jfxp.metric2fraclen(jnp.asarray(vals), metric, 1.0, signed))
        np.testing.assert_array_equal(fxp.metric2fraclen(torch.from_numpy(vals), metric, 1.0,
                                                         signed).numpy(), want)
    near = np.concatenate([np.nextafter(exact, np.float32(0)), np.nextafter(exact, np.float32(1e9))])
    q = (np.float32(coeff) / near).astype(np.float32)
    truth = np.clip(_exact_floor_log2(q), 0, top)
    got = fxp.metric2fraclen(torch.from_numpy(near), metric, 1.0, signed).numpy()
    np.testing.assert_array_equal(got, truth)
    jax_fl = np.asarray(jfxp.metric2fraclen(jnp.asarray(near), metric, 1.0, signed))
    misses = [(float(m), float(j), float(t)) for m, j, t in zip(near, jax_fl, truth) if j != t]
    print(f"{metric} signed={signed}: XLA's float32 log2 misses the floor at (metric, "
          f"fraclen, exact) {misses}")


@pytest.mark.parametrize("signed", [True, False])
def test_fraclen_gridsearch_and_metric_fn(signed):
    rng = np.random.RandomState(4)
    for scale in (0.01, 0.3, 2.0, 40.0):
        x = (rng.standard_normal((3, 4, 5, 6)) * scale).astype(np.float32)
        want = np.asarray(jfxp.fraclen_gridsearch(jnp.asarray(x), 8, 3, signed))
        got = fxp.fraclen_gridsearch(torch.from_numpy(x), 8, 3, signed).numpy()
        np.testing.assert_array_equal(got, want)
        for name in ("std", "mae", "rms"):
            for axes in ((0, 1, 2, 3), (0, 1, 2)):
                w = np.asarray(jfxp.metric_fn(name, axes)(jnp.asarray(x)))
                g = fxp.metric_fn(name, axes)(torch.from_numpy(x)).numpy()
                np.testing.assert_allclose(g, w, rtol=2e-6)


# -- one layer --------------------------------------------------------------------


def _layer_specs(conv, linear):
    """A dense 3x3 conv on an unsigned input, a depthwise 3x3/s2, a signed
    pointwise conv and a linear layer, wired by `following`."""
    return {
        "a": conv(name="a", in_ch=8, out_ch=16, kernel=(3, 3), padding=(1, 1), following="b"),
        "b": conv(name="b", in_ch=16, out_ch=16, kernel=(3, 3), stride=(2, 2), padding=(1, 1),
                  groups=16, following="c"),
        "c": conv(name="c", in_ch=16, out_ch=12, kernel=(1, 1), double_side=True, following="fc"),
        "fc": linear(name="fc", in_features=12, out_features=10),
    }


@pytest.fixture(scope="module")
def layers():
    """(JAX graph, port graph, params, state, inputs) as numpy."""
    rng = np.random.RandomState(5)
    jg = JaxLayerGraph(_layer_specs(JaxConvBNSpec, JaxLinearSpec))
    pg = LayerGraph(_layer_specs(ConvBNSpec, LinearSpec))
    params, state = {}, {}
    for n in ("a", "b", "c"):
        s = pg[n]
        params[n] = {
            "w": (rng.standard_normal(s.weight_shape()) * 0.3).astype(np.float32),
            "alpha": np.float32(rng.uniform(4, 10)),
            "gamma": rng.uniform(0.5, 1.5, s.out_ch).astype(np.float32),
            "beta": (0.1 * rng.standard_normal(s.out_ch)).astype(np.float32),
        }
        state[n] = {
            "bn_mean": (0.1 * rng.standard_normal(s.out_ch)).astype(np.float32),
            "bn_var": rng.uniform(0.5, 2, s.out_ch).astype(np.float32),
            "bn_count": np.float32(3),
            "input_fl_ema": np.array([rng.uniform(3, 6)], np.float32),
        }
    params["fc"] = {"w": (0.1 * rng.standard_normal((12, 10))).astype(np.float32),
                    "alpha": np.float32(6.0), "bias": (0.1 * rng.standard_normal(10)).astype(np.float32)}
    state["fc"] = {"input_fl_ema": np.array([5.3], np.float32)}
    xs = {
        "a": rng.standard_normal((4, 8, 8, 8)).astype(np.float32),
        "b": rng.standard_normal((4, 8, 8, 16)).astype(np.float32),
        "c": rng.standard_normal((4, 4, 4, 16)).astype(np.float32),
        "fc": rng.standard_normal((4, 12)).astype(np.float32),
    }
    return jg, pg, params, state, xs


CFG_VARIANTS = {
    "metric": CFG,
    "no_quant_bias": dict(CFG, quant_bias=False),
    "grid_search": dict(format_grid_search=True, quant_bias=True),
    "floating_model": dict(CFG, floating_model=True),
    "floating_wo_clip": dict(CFG, floating_wo_clip=True),
}


def _run_layer(jg, pg, name, params, state, x, mode, cfg_kw, grad):
    """The JAX and the port layer on the same input: (jax out, jax updates,
    jax grads, port out, port updates, port grads); grads of sum(y * r)
    with respect to the layer's params and x, when `grad`."""
    fn_j = jql.linear_apply if name == "fc" else jql.conv_bn_apply
    fn_p = ql.linear_apply if name == "fc" else ql.conv_bn_apply
    jcfg, pcfg = JaxQuantConfig(**cfg_kw), QuantConfig(**cfg_kw)
    r = np.random.RandomState(6).standard_normal(
        (x.shape[0], 10) if name == "fc" else x.shape[:1] + (4 if name == "b" else x.shape[1],) * 2
        + (pg[name].out_ch,)).astype(np.float32)

    def jax_loss(p, xx):
        y, upd = fn_j(jg, jcfg, name, p, _j(state), jql.Act(xx), mode)
        return jnp.sum(y.x * r), (y, upd)

    jp = _j(params)
    _, (jy, jupd) = jax_loss(jp, jnp.asarray(x))  # op by op: the EMA unfused
    jgr = None
    if grad:
        jgr = jax.jit(jax.grad(lambda p, xx: jax_loss(p, xx)[0], argnums=(0, 1)))(
            jp, jnp.asarray(x))
    tp, tx = _t(params, grad), torch.tensor(x, requires_grad=grad)
    py, pupd = fn_p(pg, pcfg, name, tp, _t(state), ql.Act(tx), mode)
    if grad:
        (py.x * torch.from_numpy(r)).sum().backward()
    pgr = ({k: v.grad for k, v in tp[name].items()}, tx.grad) if grad else None
    return jy, jupd, jgr, py, pupd, pgr


def _check_updates(jupd, pupd, what):
    assert set(jupd) == set(pupd), what
    for lname, d in jupd.items():
        assert set(d) == set(pupd[lname]), what
        for k, v in d.items():
            got, want = _np(pupd[lname][k]), np.asarray(v)
            if k == "input_fl_ema":
                np.testing.assert_array_equal(got, want, err_msg=f"{what} {lname}/{k}")
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{what} {lname}/{k}")


def _check_grads(jgr, pgr, name, what):
    (jp, jx), (pp, px) = jgr, pgr
    gw = np.linalg.norm(np.asarray(jp[name]["w"]))
    for k, v in jp[name].items():
        want = np.asarray(v)
        got = np.zeros_like(want) if pp[k] is None else _np(pp[k])
        if k == "alpha":
            assert np.abs(got - want).max() <= 1e-4 * gw, (what, k)
        else:
            assert np.linalg.norm(got - want) <= 1e-4 * max(np.linalg.norm(want), 1e-30), (what, k)
    assert np.linalg.norm(_np(px) - np.asarray(jx)) <= 1e-4 * np.linalg.norm(np.asarray(jx)), what


# int_infer simulates the quantized model, so not with the float baselines
MODES = [(mode, variant) for mode in ("train", "eval", "calib", "int_infer")
         for variant in CFG_VARIANTS
         if not (mode == "int_infer" and variant.startswith("floating"))]


@pytest.mark.parametrize("mode,variant", MODES)
@pytest.mark.parametrize("name", ["a", "b", "c", "fc"])
def test_layer_matches_jax(layers, mode, variant, name):
    """One layer in one mode and configuration; the STE gradients in
    training with the metric-chosen fraclens (the default QAT)."""
    jg, pg, params, state, xs = layers
    cfg_kw = dict(CFG_VARIANTS[variant])
    if mode == "int_infer":
        cfg_kw["int_infer"], mode = True, "eval"
    what = f"{name} {mode} {variant}"
    train = mode == "train" or (mode == "calib" and name != "fc")
    grad = mode == "train" and variant == "metric"
    jy, jupd, jgr, py, pupd, pgr = _run_layer(jg, pg, name, params, state, xs[name], mode,
                                               cfg_kw, grad=grad)
    _check_updates(jupd, pupd, what)
    if cfg_kw.get("int_infer"):
        np.testing.assert_allclose(_np(py.x), np.asarray(jy.x), rtol=2e-6, atol=0, err_msg=what)
        if jy.fl is not None:
            np.testing.assert_array_equal(_np(py.fl), np.asarray(jy.fl))
    elif train:
        assert_close_but_flips(py.x, jy.x, what)
    else:
        np.testing.assert_allclose(_np(py.x), np.asarray(jy.x), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(jy.x)).max(), err_msg=what)
    if pgr is not None:
        _check_grads(jgr, pgr, name, what)


def test_fix_scalings_and_reset_for_calib(layers):
    jg, pg, params, state, _ = layers
    cfg = dict(CFG, input_fraclen_sharing=True)
    want = jql.all_fix_scalings(jg, JaxQuantConfig(**cfg), _j(params), _j(state))
    got = ql.all_fix_scalings(pg, QuantConfig(**cfg), _t(params), _t(state))
    for n in want:
        np.testing.assert_array_equal(_np(got[n]), np.asarray(want[n]), err_msg=n)
    reset = reset_bn_for_calib(_t(state))
    assert float(reset["a"]["bn_count"]) == 0 and bool((reset["a"]["bn_var"] == 1).all())
    assert bool((reset["a"]["bn_mean"] == 0).all()) and "bn_mean" not in reset["fc"]


def test_pools_and_residual_add():
    rng = np.random.RandomState(7)
    x = np.maximum(rng.standard_normal((2, 7, 7, 5)), 0).astype(np.float32)
    xi = rng.randint(-50, 200, (2, 9, 9, 3)).astype(np.int32)
    fl = np.array([4.0], np.float32)
    for jf, pf, v in ((jql.maxpool, ql.maxpool, x), (jql.fxq_maxpool, ql.fxq_maxpool, x),
                      (jql.fxq_maxpool, ql.fxq_maxpool, xi)):
        want = jf(jql.Act(jnp.asarray(v)), 3, 2, 1).x
        np.testing.assert_array_equal(pf(ql.Act(torch.from_numpy(v)), 3, 2, 1).x.numpy(),
                                      np.asarray(want))
    want = jql.fxq_avgpool(jql.Act(jnp.asarray(x), jnp.asarray(fl)), 7)
    got = ql.fxq_avgpool(ql.Act(torch.from_numpy(x), torch.from_numpy(fl)), 7)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-6)  # float sums
    np.testing.assert_array_equal(got.fl.numpy(), np.asarray(want.fl))
    np.testing.assert_allclose(ql.adaptive_avgpool(torch.from_numpy(x)).x.numpy(),
                               np.asarray(jql.adaptive_avgpool(jnp.asarray(x)).x), rtol=1e-6)
    with pytest.raises(ValueError, match="extent"):
        ql.fxq_avgpool(ql.Act(torch.from_numpy(x)), 5)
    a = rng.standard_normal((2, 3)).astype(np.float32)
    b = rng.standard_normal((2, 3)).astype(np.float32)
    fa, fb = np.array([3.0], np.float32), np.array([6.0], np.float32)
    want = jql.residual_add_int_sim(jql.Act(jnp.asarray(a), jnp.asarray(fa)),
                                    jql.Act(jnp.asarray(b), jnp.asarray(fb)))
    got = ql.residual_add_int_sim(ql.Act(torch.from_numpy(a), torch.from_numpy(fa)),
                                  ql.Act(torch.from_numpy(b), torch.from_numpy(fb)))
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.fl.numpy(), np.asarray(want.fl))


# -- the whole train-mode forward ----------------------------------------------------


def _images(n, seed):
    return np.random.RandomState(seed).rand(n, 32, 32, 3).astype(np.float32)


@pytest.mark.parametrize("name", ["resnet18", "mobilenet_v1"])
def test_train_forward_layer_by_layer(name, monkeypatch):
    """Each layer of the port's train-mode forward (Model.init from a
    torch.Generator, carried to JAX through qat_to_numpy) against the JAX
    layer on the same input and state, all JAX layers in one jitted
    program: fraclens bitwise, BN stats, activations and the logits within
    the module's tolerances, and the STE gradients of a scalar loss through
    four layers.  The port's new state is every layer's updates, merged."""
    model = get_model(name, QuantConfig(**MODEL_CFG), num_classes=10, image_size=32)
    jmodel = jax_get_model(name, JaxQuantConfig(**MODEL_CFG), 10, 32)
    assert [dataclasses.asdict(s) for s in model.graph] == [dataclasses.asdict(s) for s in jmodel.graph]
    params, state = model.init(torch.Generator().manual_seed(8), device="cpu")
    params_np, state_np = qat_to_numpy(params, state)
    calls = []
    for kind in ("conv", "linear"):
        method = getattr(port_runner.Runner, kind)

        def record(self, lname, act, _method=method):
            before = {k: {kk: _np(v).copy() for kk, v in d.items()} for k, d in self.state.items()}
            x = ql.as_act(act).x
            out = _method(self, lname, act)
            calls.append((lname, _np(x).copy(), before, out))
            return out

        monkeypatch.setattr(port_runner.Runner, kind, record)
    logits, new_state = model.apply(params, state, torch.from_numpy(_images(4, 9)), mode="train")
    monkeypatch.undo()
    assert [c[0] for c in calls] == model.graph.names()
    assert logits.shape == (4, 10) and bool(torch.isfinite(logits).all())
    graph_j, graph_p = jmodel.graph, model.graph
    # STE gradients through a few layers on their recorded inputs: the head,
    # a shortcut or a depthwise conv, the last conv and the classifier
    picks = {"resnet18": ["head", "stage_1_layer_0.shortcut.0", "stage_3_layer_1.body.1"],
             "mobilenet_v1": ["head", "stage_2_layer_0.body.0", "stage_4_layer_1.body.1"]}[name]
    picks.append("classifier")
    rs = {c[0]: np.random.RandomState(10).standard_normal(c[3].x.shape).astype(np.float32)
          for c in calls if c[0] in picks}

    def jax_layers(p, xs, befores):
        """Every JAX layer on the port's recorded input and state, and the
        gradients of sum(y * r) through the picked ones; one XLA program."""
        outs, grads = [], {}
        for (lname, _, _, _), xx, before in zip(calls, xs, befores):
            fn = jql.linear_apply if lname == "classifier" else jql.conv_bn_apply

            def loss(pp, v, fn=fn, lname=lname, before=before):
                y, upd = fn(graph_j, jmodel.cfg, lname, pp, before, jql.Act(v), "train")
                return jnp.sum(y.x * rs.get(lname, 0.0)), (y.x, upd)

            if lname in rs:
                (_, out), grads[lname] = jax.value_and_grad(loss, (0, 1), has_aux=True)(p, xx)
            else:
                _, out = loss(p, xx)
            outs.append(out)
        return outs, grads

    outs, grads = jax.jit(jax_layers)(_j(params_np), [jnp.asarray(c[1]) for c in calls],
                                       [_j(c[2]) for c in calls])
    merged = {k: dict(v) for k, v in state_np.items()}
    for (lname, _, _, out), (jy, jupd) in zip(calls, outs):
        assert_close_but_flips(out.x, jy, f"{name} {lname}")
        for k, d in jupd.items():
            merged[k].update({kk: np.asarray(v) for kk, v in d.items()})
    for lname, d in merged.items():
        for k, v in d.items():
            got, what = _np(new_state[lname][k]), f"{name} {lname}/{k}"
            if k == "input_fl_ema":
                # the fraclen exactly; the EMA itself within the ulp of XLA's
                # fused multiply-add under jit (bitwise op by op: the layer
                # tests)
                np.testing.assert_array_equal(np.round(got), np.round(v), err_msg=what)
                np.testing.assert_array_max_ulp(got, v, maxulp=1)
            else:
                np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-6, err_msg=what)
    for lname, x, before, _ in calls:
        if lname not in rs:
            continue
        fn_p = ql.linear_apply if lname == "classifier" else ql.conv_bn_apply
        tp, tx = _t(params_np, grad=True), torch.tensor(x, requires_grad=True)
        y, _ = fn_p(graph_p, model.cfg, lname, tp, _t(before), ql.Act(tx), "train")
        (y.x * torch.from_numpy(rs[lname])).sum().backward()
        _check_grads(grads[lname], ({k: v.grad for k, v in tp[lname].items()}, tx.grad), lname,
                     f"{name} {lname} gradient")


def test_reference_train_forward_is_sensitive():
    """Why the whole forward is compared layer by layer: MobileNetV1's JAX
    train-mode forward at 32 px, batch 8, moves its logits by more than a
    tenth (relative L2) when every input pixel moves by one ulp."""
    jmodel = jax_get_model("mobilenet_v1", JaxQuantConfig(**MODEL_CFG), 10, 32)
    model = get_model("mobilenet_v1", QuantConfig(**MODEL_CFG), num_classes=10, image_size=32)
    params, state = qat_to_numpy(*model.init(torch.Generator().manual_seed(0), device="cpu"))
    fwd = jax.jit(lambda p, s, v: jmodel.apply(p, s, v, mode="train")[0])
    x = np.random.RandomState(0).rand(8, 32, 32, 3).astype(np.float32)
    y0 = np.asarray(fwd(_j(params), _j(state), jnp.asarray(x)))
    y1 = np.asarray(fwd(_j(params), _j(state), jnp.asarray(np.nextafter(x, np.float32(2)))))
    assert np.linalg.norm(y1 - y0) > 0.1 * np.linalg.norm(y0)


def test_qat_pytrees_round_trip():
    model = get_model("mobilenet_v1", QuantConfig(**MODEL_CFG), num_classes=10, image_size=32)
    params, state = model.init(torch.Generator().manual_seed(1), device="cpu")
    pn, sn = qat_to_numpy(params, state)
    p2, s2 = qat_from_numpy(pn, sn, device="cpu")
    for a, b in ((params, p2), (state, s2)):
        assert set(a) == set(b)
        for k in a:
            for kk in a[k]:
                assert torch.equal(a[k][kk], b[k][kk])
    jparams, jstate = jmodel_init_shapes()
    assert {k: {kk: v.shape for kk, v in d.items()} for k, d in pn.items()} == jparams
    assert {k: {kk: v.shape for kk, v in d.items()} for k, d in sn.items()} == jstate
    with pytest.raises(TypeError, match="float32"):
        qat_from_numpy({"head": {"w": np.zeros(3, np.float64)}}, {}, device="cpu")


def jmodel_init_shapes():
    """The JAX init's pytree shapes for MobileNetV1 at 32 px (traced, not run)."""
    jmodel = jax_get_model("mobilenet_v1", JaxQuantConfig(**MODEL_CFG), 10, 32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    return tuple({k: {kk: tuple(v.shape) for kk, v in d.items()} for k, d in t.items()} for t in shapes)


def test_init_defaults_to_the_card(monkeypatch):
    """Model.init, an entry point, runs on the card unless asked for the
    CPU, and raises where there is none."""
    model = get_model("mobilenet_v1", QuantConfig(**MODEL_CFG), num_classes=10, image_size=32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    params, _ = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert params["head"]["w"].device.type == "cpu"
