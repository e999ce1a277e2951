"""What tests/test_torch_boundary_engine*.py share: the JAX engine's int8-
and bf16-boundary rungs run once per case with their block outputs, pool
input and pool output sent to the host, the port's engine run with the same
taps, and the comparison of the two.

The JAX engine sends its taps with `jax.debug.callback` from inside its own
jitted forward; the port's are hooks on its engine.

The bf16 rung's reference is the JAX engine's own jitted forward compiled
with XLA's `xla_allow_excess_precision` off.  That option, on by default,
lets XLA keep a bf16 value in float32 inside a fusion instead of rounding
it: the JAX engine's bf16 residual add, fused into the pack of the next
conv, then feeds it an unrounded sum, and what the reference computes
depends on how XLA fused it (MobileNetV2 at 32 px parts from the rounded
values at its first stride-2 block after a residual one).  With the option
off every bf16 value is rounded where the engine's code says so, which is
the contract the port keeps (`IntEngine.add_int`: float32 add, one
rounding to bf16).  The int8 rung has no float value and runs as the JAX
engine ships.

Tolerance: 0 everywhere, but for one case.  The bf16 rung's average pool
sums bf16 values in float32, and XLA and torch may add the terms in another
order; where the pool's outputs differ (never at 32 px, whose pool has one
term), each element of the classifier's 8-bit input may lie one step of its
grid apart, and the logits of the images whose inputs are equal stay
bitwise.  Everything before the pool is bitwise in both rungs.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from f8net_tpu.engine import IntEngine as JaxIntEngine
from f8net_tpu.engine import int_engine as jax_int_engine
from f8net_tpu.export.bundle import save_deploy_bundle as jax_save_bundle
from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.quant import bake_plan
from f8net_tpu.quant.plan import LayerPlan as JaxLayerPlan
from f8net_tpu.quant.plan import QuantPlan as JaxQuantPlan
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.ops.fxp import pack_real
from f8net_tpu_torch.utils import QuantConfig

CFG = dict(
    format_from_metric=True, metric="std", quant_bias=True, quant_avgpool=True,
    pool_fusing=True,
)
FLOAT_POOL_CFG = dict(CFG, quant_avgpool=False, pool_fusing=False)
RUNGS = ("int8_boundary", "bf16_boundary")
CLASSES = 10


def images(hw, normalize, seed):
    rng = np.random.RandomState(seed)
    if normalize:
        return rng.standard_normal((2, hw, hw, 3)).astype(np.float32)
    return (np.round(255 * rng.rand(2, hw, hw, 3)) / 256).astype(np.float32)


def _np(v):
    """A tapped tensor as numpy, bf16 widened to float32 (exact)."""
    v = np.asarray(v)
    return v.astype(np.float32) if v.dtype == jnp.bfloat16 else v


@contextlib.contextmanager
def jax_taps(taps):
    """While active, a JAX engine that traces its forward sends to `taps`
    each block's output ("block", i), each ReLU's output ("relu", i: the
    tail's is MobileNetV2's only one) and the classifier's input
    ("classifier", 0), each as (array, fl, packed_for, scaled)."""
    count = {}

    def tap(kind, act):
        i = count[kind] = count.get(kind, -1) + 1

        def put(v, i=i):
            taps[(kind, i)] = (_np(v), act.fl, act.packed_for, act.scaled)

        jax.debug.callback(put, act.x)

    def wrap(kind, fn):
        @functools.wraps(fn)
        def call(w, *args, **kw):
            out = fn(w, *args, **kw)
            tap(kind, out if kind != "classifier" else args[0])
            return out

        return call

    saved = dict(
        _block_resnet_int=jax_int_engine._block_resnet_int,
        _block_mbv1_int=jax_int_engine._block_mbv1_int,
        _block_mbv2_int=jax_int_engine._block_mbv2_int,
        _classifier_int=jax_int_engine._classifier_int,
    )
    relu = jax_int_engine._Walker.relu_i32
    try:
        jax_int_engine._block_resnet_int = wrap("block", saved["_block_resnet_int"])
        jax_int_engine._block_mbv2_int = wrap("block", saved["_block_mbv2_int"])
        jax_int_engine._block_mbv1_int = wrap("block", saved["_block_mbv1_int"])
        jax_int_engine._classifier_int = wrap("classifier", saved["_classifier_int"])
        jax_int_engine._Walker.relu_i32 = wrap("relu", relu)
        yield
    finally:
        for name, fn in saved.items():
            setattr(jax_int_engine, name, fn)
        jax_int_engine._Walker.relu_i32 = relu


def _bake(name, hw, normalize, bake, cfg, seed):
    """(jax model, jax plan, records, numpy arrays, jax int params, images):
    the JAX bake (init -> one train-mode apply -> bake_plan), chip_smoke.py's
    synthetic one, or that with every shortcut's input grid moved by one
    fraclen ("synthetic_regrid")."""
    x = images(hw, normalize, seed)
    model = jax_get_model(name, JaxQuantConfig(normalize=normalize, **cfg), CLASSES, hw)
    if bake == "jax":
        params, state = model.init(jax.random.PRNGKey(0))
        _, state = model.apply(params, state, jnp.asarray(x), mode="train")
        plan, ip = bake_plan(model, params, state)
        records = [(p.name, p.input_fl, p.weight_fl, p.input_symmetric) for p in plan.layers]
        arrays = {k: {kk: np.asarray(v) for kk, v in d.items()} for k, d in ip.items()}
    else:
        port_model = get_model(name, QuantConfig(normalize=normalize, **cfg), CLASSES, hw)
        records, arrays, _ = chip_smoke.synthetic_bundle(port_model, seed, torch.from_numpy(x))
        if bake == "synthetic_regrid":
            # each shortcut reads its block's input on another grid than
            # body.0 does: the int8 rung repacks the carry for it
            shortcuts = {m.shortcut for m in port_model.blocks if m.shortcut}
            records = [(n, fl + (-1 if fl else 1) if n in shortcuts else fl, wfl, sym)
                       for n, fl, wfl, sym in records]
        plan = JaxQuantPlan(tuple(JaxLayerPlan(*r) for r in records))
        ip = {k: {kk: jnp.asarray(v) for kk, v in d.items()} for k, d in arrays.items()}
    return model, plan, records, arrays, ip, x


def jax_runs(cases, tmp_path_factory, seed0=0):
    """{case: (records, arrays, images, bundle path, {rung: (jax logits, jax
    taps)})} for cases {case: (model, image size, normalize, JAX engine's
    fuse_ir, bake, cfg)}; a case whose bake is another case's name reuses
    that case's bake."""
    out = {}
    for seed, (case, (name, hw, normalize, fuse_ir, bake, cfg)) in enumerate(cases.items(), seed0):
        if bake in out:
            records, arrays, x, path, _ = out[bake]
            model = jax_get_model(name, JaxQuantConfig(normalize=normalize, **cfg), CLASSES, hw)
            plan = JaxQuantPlan(tuple(JaxLayerPlan(*r) for r in records))
            ip = {k: {kk: jnp.asarray(v) for kk, v in d.items()} for k, d in arrays.items()}
        else:
            model, plan, records, arrays, ip, x = _bake(name, hw, normalize, bake, cfg, seed)
            path = jax_save_bundle(str(tmp_path_factory.mktemp("bundle") / case), model, plan, ip)
        results = {}
        for rung in RUNGS:
            taps = {}
            with jax_taps(taps):
                eng = JaxIntEngine(model, plan, ip, int_only=True, fuse_ir=fuse_ir, **{rung: True})
                xc = eng.condition_input(jnp.asarray(x))
                fwd = eng
                if rung == "bf16_boundary":  # the engine's jitted forward, bf16 rounded as written
                    fwd = functools.partial(eng._jit.lower(eng.int_params, xc).compile(
                        compiler_options={"xla_allow_excess_precision": False}), eng.int_params)
                logits = np.asarray(fwd(xc))
                jax.effects_barrier()
            results[rung] = (logits, taps)
        out[case] = (records, arrays, x, path, results)
    return out


def port_model(spec):
    name, hw, normalize, _, _, cfg = spec
    return get_model(name, QuantConfig(normalize=normalize, **cfg), CLASSES, hw)


def port_run(eng, x):
    """(logits, each block's output, the pool's input, the pool's output)
    of one forward of the port's engine."""
    attr = {"mobilenet_v2": "block_mbv2", "mobilenet_v1": "block_mbv1"}.get(eng.model.name, "block")
    blocks, pool = [], []
    block, avgpool = getattr(eng, attr), eng.avgpool

    def hooked_block(*args, **kw):
        blocks.append(block(*args, **kw))
        return blocks[-1]

    def hooked_pool(a):
        pool.extend((a, avgpool(a)))
        return pool[-1]

    setattr(eng, attr, hooked_block)
    eng.avgpool = hooked_pool
    logits = eng(eng.condition_input(x)).numpy()
    return logits, blocks, pool[0], pool[1]


def _same(port_act, jax_tap, what):
    arr, fl, packed_for, scaled = jax_tap
    got = port_act.x
    got = (got.float() if got.dtype == torch.bfloat16 else got).numpy()
    assert (port_act.fl, port_act.packed_for, port_act.scaled) == (fl, packed_for, scaled), what
    assert got.dtype == arr.dtype and got.shape == arr.shape, (what, got.dtype, arr.dtype)
    return np.array_equal(got, arr)


def check(spec, rung, port, want, taps, plan):
    """The port's forward `port` (port_run) against the JAX engine's logits
    `want` and `taps`: every block output and the pool's input bitwise; the
    pool's output and the logits bitwise, but for the bf16 rung's pool
    tolerance (module docstring)."""
    logits, blocks, pool_in, pool_out = port
    what = f"{spec[0]} {spec[1]} px {rung}"
    assert len(blocks) == sum(k == "block" for k, _ in taps)
    for i, act in enumerate(blocks):
        assert _same(act, taps[("block", i)], f"{what} block {i}"), (what, i)
    if spec[0] == "mobilenet_v2":  # the tail, its only ReLU
        jax_pool_in = taps[("relu", 0)]
    else:
        jax_pool_in = taps[("block", len(blocks) - 1)]
    assert _same(pool_in, jax_pool_in, f"{what} pool input"), what
    if _same(pool_out, taps[("classifier", 0)], f"{what} pool output"):
        np.testing.assert_array_equal(logits, want)
        return
    # the pool's float32 sums took their terms in another order: only the
    # bf16 rung sums floats, and only where the pool has more than one term
    assert rung == "bf16_boundary" and spec[1] > 32, what
    pl = plan["classifier"]
    jax_out = torch.from_numpy(taps[("classifier", 0)][0])
    if pool_out.scaled:
        q_port = pack_real(pool_out.x, pl.input_fl, pl.input_symmetric).to(torch.int32)
        q_jax = pack_real(jax_out.to(torch.bfloat16), pl.input_fl, pl.input_symmetric)
        q_jax = q_jax.to(torch.int32)
    else:
        q_port, q_jax = pool_out.x, jax_out
    assert int((q_port - q_jax).abs().max()) <= 1, what
    same_rows = (q_port == q_jax).all(1).numpy()
    np.testing.assert_array_equal(logits[same_rows], want[same_rows])
    agree = (logits.argmax(1) == want.argmax(1)).mean()
    print(f"{what}: pool outputs one step apart; top-1 agreement {agree:.3f}")
