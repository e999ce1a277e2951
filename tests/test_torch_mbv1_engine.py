"""The port's MobileNetV1 -- graph and integer engine in its three rungs --
against the JAX package's.

The graph must equal `f8net_tpu.models.get_model("mobilenet_v1")`'s field
for field.  The engine runs at 32 px, batch 2, 10 classes, normalized and
not, on chip_smoke.py's synthetic bake (as tests/test_torch_mbv2_engine.py
does; tests/test_torch_bake.py drives the strict rung on a JAX bake):
through `f8net_tpu.engine.IntEngine(int_only=True)` with and without the
rung's flag and through the port's `IntEngine` on the CPU, where the port
runs its kernels' plain versions, with params through `params_from_numpy`
and through a JAX deploy bundle.  Tolerance 0: the strict and int8 rungs
are integer throughout, and the bf16 rung's pool has one term at 32 px
(tests/_rung_reference.py: every block output, the pool's input and output
and the logits bitwise; the bf16 reference compiled without XLA's excess
precision).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

import _rung_reference as ref
from test_torch_gemm_dw_hopper import _dw_tiles_ok
from f8net_tpu.engine import IntEngine as JaxIntEngine
from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.quant.plan import LayerPlan as JaxLayerPlan
from f8net_tpu.quant.plan import QuantPlan as JaxQuantPlan
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu_torch.engine import IntEngine
from f8net_tpu_torch.export import load_deploy_bundle, model_from_topology, params_from_numpy
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.ops import dw as dw_ops
from f8net_tpu_torch.ops import gemm_v2 as gemm_v2_ops
from f8net_tpu_torch.utils import QuantConfig

CASES = {
    "mbv1_32": ("mobilenet_v1", 32, False, False, "synthetic", ref.CFG),
    "mbv1_32_norm": ("mobilenet_v1", 32, True, False, "synthetic", ref.CFG),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The relaxed rungs' JAX results (_rung_reference.jax_runs) and, per
    case, the strict JAX engine's logits."""
    out = ref.jax_runs(CASES, tmp_path_factory, seed0=20)
    strict = {}
    for case, (records, arrays, x, _, _) in out.items():
        name, hw, normalize, _, _, cfg = CASES[case]
        model = jax_get_model(name, JaxQuantConfig(normalize=normalize, **cfg), ref.CLASSES, hw)
        plan = JaxQuantPlan(tuple(JaxLayerPlan(*r) for r in records))
        ip = {k: {kk: jnp.asarray(v) for kk, v in d.items()} for k, d in arrays.items()}
        eng = JaxIntEngine(model, plan, ip, int_only=True)
        strict[case] = np.asarray(eng(eng.condition_input(jnp.asarray(x))))
    return out, strict


def _specs(graph):
    return [(type(s).__name__, dataclasses.asdict(s)) for s in graph]


@pytest.mark.parametrize("normalize,pool_fusing", [(False, True), (True, False)])
def test_mobilenet_v1_graph_equals_reference(normalize, pool_fusing):
    kw = dict(quant_avgpool=True, pool_fusing=pool_fusing, normalize=normalize)
    want = jax_get_model("mobilenet_v1", JaxQuantConfig(**kw), num_classes=10, image_size=224)
    got = get_model("mobilenet_v1", QuantConfig(**kw), num_classes=10, image_size=224)
    assert _specs(got.graph) == _specs(want.graph)
    assert got.graph.names() == want.graph.names()
    assert [tuple(m) for m in got.blocks] == [tuple(m) for m in want.blocks]
    assert got.conv_order == want.conv_order
    assert (got.name, got.block_setting, got.num_classes) == (
        want.name, want.block_setting, want.num_classes
    )
    assert (got.pool_kernel, got.pool_fuse_layer) == (want.pool_kernel, want.pool_fuse_layer)


@pytest.mark.parametrize("case", list(CASES))
def test_strict_logits_bitwise(runs, case):
    (records, arrays, x, path, _), want = runs[0][case], runs[1][case]
    assert not np.array_equal(want[0], want[1])  # non-degenerate: the images' logits differ
    eng = IntEngine(ref.port_model(CASES[case]), *params_from_numpy(records, arrays, "cpu"),
                    device="cpu")
    got = eng(eng.condition_input(x))
    assert got.dtype == torch.float32 and got.shape == (2, ref.CLASSES)
    np.testing.assert_array_equal(got.numpy(), want)
    topo, plan, params = load_deploy_bundle(path, device="cpu")
    eng = IntEngine(model_from_topology(topo, image_size=CASES[case][1]), plan, params,
                    device="cpu")
    np.testing.assert_array_equal(eng(eng.condition_input(x)).numpy(), want)


@pytest.mark.parametrize("rung", ref.RUNGS)
@pytest.mark.parametrize("case", list(CASES))
def test_rung_matches_jax(runs, case, rung):
    records, arrays, x, path, results = runs[0][case]
    want, taps = results[rung]
    plan, params = params_from_numpy(records, arrays, "cpu")
    eng = IntEngine(ref.port_model(CASES[case]), plan, params, device="cpu", **{rung: True})
    ref.check(CASES[case], rung, ref.port_run(eng, x), want, taps, plan)
    topo, plan, params = load_deploy_bundle(path, device="cpu")
    eng = IntEngine(model_from_topology(topo, image_size=CASES[case][1]), plan, params,
                    device="cpu", **{rung: True})
    ref.check(CASES[case], rung, ref.port_run(eng, x), want, taps, plan)


def test_int8_rung_is_the_strict_forward(runs):
    """The reference's MobileNetV1 branch has no pack target: every output
    but the last block's is packed for its unique consumer in every rung,
    so the int8 rung's logits are the strict rung's."""
    out, strict = runs
    for case in CASES:
        np.testing.assert_array_equal(out[case][4]["int8_boundary"][0], strict[case])


def test_routes_every_product_to_its_kernel(runs):
    """1 K2 (the head, input channels padded to 16), 13 K4 (4 at stride
    2), 13 pointwise convs in K7 (every one: K >= 32 and N >= 64) and the
    classifier in K1; every conv but the last packs its output for the
    next conv, and the last keeps int32 with its ReLU fused."""
    records, arrays, x, _, _ = runs[0]["mbv1_32"]
    eng = IntEngine(ref.port_model(CASES["mbv1_32"]), *params_from_numpy(records, arrays, "cpu"),
                    device="cpu")
    calls = []
    for attr in ("_convk", "_dwk", "_gemm2", "_gemm"):
        fn = getattr(eng, attr)
        setattr(eng, attr, lambda *a, _f=fn, _n=attr, **kw: calls.append((_n, a, kw)) or _f(*a, **kw))
    eng(eng.condition_input(x))
    kinds = [c[0] for c in calls]
    assert kinds.count("_convk") == 1 and kinds.count("_dwk") == 13
    assert kinds.count("_gemm2") == 13 and kinds.count("_gemm") == 1
    assert calls[0][1][0].shape[3] == 16  # the head's padded input
    assert sum(kw["stride"] == 2 for n, _, kw in calls if n == "_dwk") == 4
    epilogues = [kw["epilogue"] for n, _, kw in calls if n != "_gemm"]
    assert epilogues == ["requant8"] * 26 + ["int32"]
    assert [kw.get("relu", False) for n, _, kw in calls if n != "_gemm"] == [False] * 26 + [True]


def mbv1_calls(batch, size=224):
    """MobileNetV1's K4 calls (n, h, w, c, stride) and K7 calls (M, K, N) at
    `size` px, from its graph."""
    model = get_model("mobilenet_v1", QuantConfig(quant_avgpool=True), image_size=size)
    dws, pws, cur = [], [], size // 2
    for meta in model.blocks:
        dw, pw = (model.graph[n] for n in meta.body)
        dws.append((batch, cur, cur, dw.in_ch, dw.stride[0]))
        cur = (cur + 2 - 3) // dw.stride[0] + 1
        pws.append((batch * cur * cur, pw.in_ch, pw.out_ch))
    return dws, pws


@pytest.mark.parametrize("batch", [8, 64])
def test_planners_cover_mobilenet_v1_calls_once(batch):
    """plan_dw at MobileNetV1's 13 depthwise calls (9 at stride 1, up to
    C = 1024 on 7x7; channel blocks of at most 128) and plan_gemm at its 13
    pointwise GEMMs (K from 32 -- one ring stage, half of it zero padding --
    to 1024; M = 392 at N = 1024 split across clusters): every output, K
    step and tile once."""
    dws, pws = mbv1_calls(batch)
    assert sum(s == 2 for *_, s in dws) == 4 and len(dws) == 13
    assert (8 * 112 * 112, 32, 64) in mbv1_calls(8)[1] and (392, 1024, 1024) in mbv1_calls(8)[1]
    for n, h, w, c, stride in dws:
        plan = dw_ops.plan_dw(n, h, w, c, 3, stride, 1)
        assert plan.cb <= dw_ops.MAX_CB and dw_ops.plan_fits(plan, n, h, w, c, 3, stride, 1)
        assert _dw_tiles_ok(plan, n, h, w, c, 3, stride, 1), (n, h, w, c, stride, plan)
    for m, k, n in pws:
        assert gemm_v2_ops.takes(k, n)
        plan = gemm_v2_ops.plan_gemm(m, k, n)
        assert plan.ksteps * gemm_v2_ops.BK >= k > (plan.ksteps - 1) * gemm_v2_ops.BK
        assert plan.mtiles * gemm_v2_ops.BM >= m and plan.ntiles * plan.bn == plan.n_pad >= n
        steps = np.zeros(plan.ksteps, np.int64)
        for lo, hi in gemm_v2_ops.split_ranges(plan):
            steps[lo:hi] += 1
        assert (steps == 1).all(), (m, k, n, plan)
        if plan.splits == 1:
            walked = sorted(t for b in range(plan.grid) for t in range(b, plan.tiles, plan.grid))
            assert walked == list(range(plan.tiles)), (m, k, n, plan)
        else:
            assert plan.grid == plan.tiles * plan.splits
