"""K5's and K7's packed weights, planners and split arithmetic, on the CPU.

- the plain versions that compute from the packed layouts (`fused_ir_block`
  and `int8_gemm_v2` on packed 1x1 weights, `pack_gemm_weight`), bitwise
  against the Pallas kernels they replace in interpret mode, as
  tests/test_torch_mbv2_kernels.py and tests/test_torch_r50_kernels.py run
  them: carry and none, both outputs, signed and unsigned packs, biases and
  carries that wrap;
- pack and unpack round trips;
- `plan_ir` at MobileNetV2's twelve K5 calls and `plan_gemm` at ResNet-50's
  33 K7 calls (batch 1, 8 and 64): every output row, every expanded channel
  and every reduction step taken exactly once, layouts inside one block's
  shared memory, clusters of at most 8 blocks;
- the split arithmetic (bands with halos, Ce slices, K splits; int32
  partials added with wraparound, one epilogue) bitwise against the unsplit
  plain versions;
- the engine hands K5 and K7 the weights it packed at construction.
Tolerance 0 throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from f8net_tpu.ops.pallas_gemm_v2 import int8_gemm_v2 as pallas_int8_gemm_v2
from f8net_tpu.ops.pallas_ir_block import fused_ir_block as pallas_fused_ir_block
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.ops import gemm_v2 as gemm_v2_ops
from f8net_tpu_torch.ops import ir_block as ir_ops
from f8net_tpu_torch.ops.conv import H100_SMS, MAX_SPLITS, PackedConvWeight
from f8net_tpu_torch.ops.gemm_v2 import (
    BK, int8_gemm_v2, int8_gemm_v2_plain, int8_gemm_v2_split_plain, pack_gemm_weight,
    plan_gemm, split_ranges, unpack_gemm_weight,
)
from f8net_tpu_torch.ops.ir_block import (
    fused_ir_block, fused_ir_block_plain, fused_ir_block_split_plain, ir_bands, ir_slices,
    plan_ir,
)
from f8net_tpu_torch.utils import QuantConfig

IMAX = (1 << 31) - 1


def _t(a):
    return torch.from_numpy(np.array(a))


def _wrap_bias(rng, n):
    b = rng.randint(-(1 << 14), 1 << 14, n).astype(np.int64)
    b[::2] = IMAX - rng.randint(0, 1 << 10, b[::2].shape)  # acc + bias wraps for some outputs
    b[1::2] = -IMAX + rng.randint(0, 1 << 10, b[1::2].shape)
    return b.astype(np.int32)


@pytest.mark.parametrize("k,n", [(64, 64), (24, 144), (960, 160), (100, 36)])
def test_pack_gemm_weight_layout_and_round_trip(k, n):
    rng = np.random.RandomState(k + n)
    w = _t(rng.randint(-127, 128, (k, n)).astype(np.int8))
    p = pack_gemm_weight(w)
    assert isinstance(p, PackedConvWeight) and p.shape == (1, 1, k, n)
    kp, np_ = -(-k // 64) * 64, -(-n // 64) * 64
    assert tuple(p.data.shape) == (kp // 16, np_, 16)
    for q, c, b in [(0, 0, 0), ((k - 1) // 16, n - 1, (k - 1) % 16), (0, n // 2, 5 % k)]:
        assert p.data[q, c, b] == w[16 * q + b, c]
    m = p.data.permute(0, 2, 1).reshape(kp, np_)
    assert not m[k:].any() and not m[:, n:].any()  # zero past K and past N
    assert torch.equal(unpack_gemm_weight(p), w)


# (carry, out, net_out, out_signed, dw_in_signed, proj_in_signed, shift_res,
#  shift_carry, wrap)
IR_CASES = [
    (False, "int32", 0, False, False, False, 0, 0, False),
    (False, "requant8", 9, True, True, False, 0, 0, True),
    (True, "int32", 0, False, False, True, 2, 0, False),
    (True, "int32", 0, False, True, True, 0, 3, True),
    (True, "requant8", 11, False, False, False, 1, 2, True),
    (False, "requant8", 10, False, True, True, 0, 0, False),
]


@pytest.mark.parametrize(
    "carry,out,net_out,out_signed,dw_in_signed,proj_in_signed,shift_res,shift_carry,wrap",
    IR_CASES,
)
def test_fused_ir_block_packed_vs_pallas(
    carry, out, net_out, out_signed, dw_in_signed, proj_in_signed, shift_res, shift_carry, wrap
):
    rng = np.random.RandomState(3 * net_out + 5 * shift_res + shift_carry + 17 * wrap)
    n, h, w, cin, ce, cout = 2, 4, 4, 24, 80, 40
    x = rng.randint(-128, 128, (n, h, w, cin)).astype(np.int8)
    w1 = rng.randint(-40, 41, (cin, ce)).astype(np.int8)
    wd = rng.randint(-127, 128, (3, 3, ce)).astype(np.int8)
    w2 = rng.randint(-40, 41, (ce, cout)).astype(np.int8)
    b1 = rng.randint(-(1 << 14), 1 << 14, (ce,)).astype(np.int32)
    bd = rng.randint(-(1 << 14), 1 << 14, (ce,)).astype(np.int32)
    b2 = _wrap_bias(rng, cout) if wrap else rng.randint(-(1 << 14), 1 << 14, (cout,)).astype(np.int32)
    c = None
    if carry:
        c = rng.randint(-(1 << 20), 1 << 20, (n, h, w, cout)).astype(np.int32)
        if wrap:  # carry << shift_carry leaves the int32 range: the add wraps
            c[..., ::3] = IMAX - 7
    kw = dict(net1=8, dw_in_signed=dw_in_signed, net2=12, proj_in_signed=proj_in_signed,
              out=out, net_out=net_out, out_signed=out_signed, shift_res=shift_res,
              shift_carry=shift_carry)
    args = (x, w1, b1, wd, bd, w2, b2)
    want = pallas_fused_ir_block(
        *(jnp.asarray(a) for a in args), None if c is None else jnp.asarray(c),
        h=h, w=w, bn_tile=2, interpret=True, **kw,
    )
    xt, w1t, b1t, wdt, bdt, w2t, b2t = (_t(a) for a in args)
    ct = None if c is None else _t(c)
    got = fused_ir_block(xt, pack_gemm_weight(w1t), b1t, wdt, bdt, pack_gemm_weight(w2t), b2t,
                         ct, **kw)
    assert got.dtype == (torch.int32 if out == "int32" else torch.int8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (M, K, N, epilogue kwargs, wrap)
GEMM_CASES = [
    (200, 64, 96, dict(epilogue="int32"), True),
    (200, 64, 96, dict(epilogue="requant8", net=9, out_signed=True), False),
    (130, 256, 100, dict(epilogue="int32", relu=True), True),
    (130, 256, 100, dict(epilogue="requant8", net=11, out_signed=False, relu=True), True),
    (64, 2048, 64, dict(epilogue="requant8", net=12, out_signed=False), False),
]


@pytest.mark.parametrize("M,K,N,kw,wrap", GEMM_CASES)
def test_int8_gemm_v2_packed_vs_pallas(M, K, N, kw, wrap):
    rng = np.random.RandomState(M + K + N + kw.get("net", 0) + wrap)
    x = rng.randint(-128, 128, (M, K)).astype(np.int8)
    w = rng.randint(-127, 128, (K, N)).astype(np.int8)
    b = _wrap_bias(rng, N) if wrap else rng.randint(-(1 << 16), 1 << 16, (N,)).astype(np.int32)
    want = pallas_int8_gemm_v2(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw)
    got = int8_gemm_v2(_t(x), pack_gemm_weight(_t(w)), _t(b), **kw)
    assert got.dtype == (torch.int32 if kw["epilogue"] == "int32" else torch.int8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _mbv2_ir_shapes(batch, image_size=224):
    """(n, h, w, cin, ce, cout, k) of each K5 call of a MobileNetV2 forward."""
    from f8net_tpu_torch.engine.int_engine import fuses_ir

    model = get_model("mobilenet_v2", QuantConfig(), num_classes=1000, image_size=image_size)
    g, size, shapes = model.graph, image_size // 2, []
    for meta in model.blocks:
        sd = g[meta.body[-2]]
        if fuses_ir(g, meta):
            en, _, pn = meta.body
            shapes.append((batch, size, size, g[en].in_ch, g[en].out_ch, g[pn].out_ch,
                           sd.kernel[0]))
        size = (size + 2 * sd.padding[0] - sd.kernel[0]) // sd.stride[0] + 1
    return shapes


@pytest.mark.parametrize("batch", [1, 8, 64])
def test_plan_ir_covers_rows_and_channels_once(batch):
    shapes = _mbv2_ir_shapes(batch)
    assert len(shapes) == 12
    for n, h, w, cin, ce, cout, k in shapes:
        plan = plan_ir(n, h, w, cin, ce, cout, k)
        assert plan.total <= ir_ops.SMEM_LIMIT and 1 <= plan.splits <= MAX_SPLITS
        rows = np.zeros(h, np.int64)
        for r0, r1 in ir_bands(plan, h):
            assert 0 < r1 - r0 <= plan.th
            rows[r0:r1] += 1
            pad = (k - 1) // 2
            assert (min(r1 + pad, h) - max(r0 - pad, 0)) * w < plan.ld_x  # halo included
            assert (r1 - r0) * w < plan.ld_d
        assert (rows == 1).all(), (h, plan)
        chans = np.zeros(plan.ce_pad, np.int64)
        for c0, c1 in ir_slices(plan, ce):
            assert c1 > c0 and (c1 - c0) % 32 == 0 and c1 - c0 <= plan.cs
            chans[c0:c1] += 1
        assert (chans[:ce] == 1).all() and (chans[ce:] <= 1).all(), (ce, plan)
    if batch == 8:  # at 7x7 x 960 the slices fill the card without tripling the expand
        plan = plan_ir(8, 7, 7, 160, 960, 160, 3)
        assert 8 * plan.bands * plan.splits >= H100_SMS // 2
        assert plan.th >= 2


@pytest.mark.parametrize(
    "n,h,w,cin,ce,cout,k,th,s",
    [(2, 7, 7, 24, 144, 24, 3, 1, 3), (1, 9, 5, 32, 200, 40, 5, 2, 7), (2, 6, 6, 16, 96, 20, 3, 6, 2),
     (1, 8, 8, 24, 100, 12, 3, 3, 4)],
)
def test_ir_split_plain_equals_unsplit(n, h, w, cin, ce, cout, k, th, s):
    rng = np.random.RandomState(n + h + cin + ce + th + s)
    x = _t(rng.randint(-128, 128, (n, h, w, cin)).astype(np.int8))
    w1 = _t(rng.randint(-40, 41, (cin, ce)).astype(np.int8))
    wd = _t(rng.randint(-127, 128, (k, k, ce)).astype(np.int8))
    w2 = _t(rng.randint(-40, 41, (ce, cout)).astype(np.int8))
    b1 = _t(rng.randint(-(1 << 14), 1 << 14, ce).astype(np.int32))
    bd = _t(rng.randint(-(1 << 14), 1 << 14, ce).astype(np.int32))
    b2 = _t(_wrap_bias(rng, cout))
    c = _t(rng.randint(-(1 << 20), 1 << 20, (n, h, w, cout)).astype(np.int32))
    units = -(-ce // 32)
    su = -(-units // s)
    plan = ir_ops._layout(h, w, cin, ce, cout, k, th, -(-units // su), 32 * su)
    p1, p2 = pack_gemm_weight(w1), pack_gemm_weight(w2)
    for carry, kw in ((c, dict(out="int32", shift_res=1, shift_carry=2)),
                      (None, dict(out="requant8", net_out=9, out_signed=True))):
        kw.update(net1=8, net2=12)
        want = fused_ir_block_plain(x, w1, b1, wd, bd, w2, b2, carry, **kw)
        assert torch.equal(fused_ir_block_split_plain(x, p1, b1, wd, bd, p2, b2, carry, plan, **kw),
                           want), (plan, kw)
        assert torch.equal(fused_ir_block(x, p1, b1, wd, bd, p2, b2, carry, plan=plan, **kw), want)


def _r50_gemm_shapes(batch, image_size=224):
    """(M, K, N) of each K7 call of a ResNet-50 forward: the 1x1/s1 convs of
    its Bottleneck blocks, at the block's spatial size."""
    from f8net_tpu_torch.engine.int_engine import is_bottleneck, is_pointwise

    model = get_model("resnet50", QuantConfig(), num_classes=1000, image_size=image_size)
    g, size, shapes = model.graph, image_size // 4, []
    for meta in model.blocks:
        cur = size
        for name in (*meta.body, meta.shortcut):
            if name is None:
                continue
            spec = g[name]
            hw = size if name == meta.shortcut or name == meta.body[0] else cur
            if is_bottleneck(g, meta) and is_pointwise(spec):
                shapes.append((batch * hw * hw, spec.in_ch, spec.out_ch))
            if name in meta.body:
                cur = (cur + 2 * spec.padding[0] - spec.kernel[0]) // spec.stride[0] + 1
        size = cur
    return shapes


@pytest.mark.parametrize("batch", [1, 8, 64])
def test_plan_gemm_covers_steps_and_tiles_once(batch):
    shapes = _r50_gemm_shapes(batch)
    assert len(shapes) == 33
    assert (8 * 56 * 56, 64, 64) in _r50_gemm_shapes(8) and (392, 2048, 512) in _r50_gemm_shapes(8)
    for m, k, n in shapes:
        plan = plan_gemm(m, k, n)
        assert plan.ksteps * BK >= k > (plan.ksteps - 1) * BK
        assert plan.mtiles * gemm_v2_ops.BM >= m and plan.ntiles * plan.bn == plan.n_pad >= n
        assert 1 <= plan.splits <= MAX_SPLITS
        steps = np.zeros(plan.ksteps, np.int64)
        for lo, hi in split_ranges(plan):
            assert hi - lo >= 1
            steps[lo:hi] += 1
        assert (steps == 1).all(), (m, k, n, plan)
        if plan.splits > 1:  # one tile per cluster, every block on its own SM
            assert plan.grid == plan.tiles * plan.splits <= H100_SMS
        else:  # persistent: each block walks tiles grid apart, every tile once
            assert 1 <= plan.grid <= min(plan.tiles, H100_SMS)
            walked = sorted(t for b in range(plan.grid) for t in range(b, plan.tiles, plan.grid))
            assert walked == list(range(plan.tiles))
    # stage 3 at batch 8: 4 x 4 tiles of 128 x 128, K split 8 ways in clusters
    assert plan_gemm(392, 2048, 512) == gemm_v2_ops.GemmPlan(128, 512, 32, 4, 4, 8, 128)


@pytest.mark.parametrize(
    "M,K,N,plan",
    [(300, 256, 96, gemm_v2_ops.GemmPlan(64, 128, 4, 3, 2, 2, 12)),
     (129, 2048, 64, gemm_v2_ops.GemmPlan(64, 64, 32, 2, 1, 8, 16)),
     (200, 192, 136, gemm_v2_ops.GemmPlan(64, 192, 3, 2, 3, 3, 18))],
)
def test_gemm_split_plain_equals_unsplit(M, K, N, plan):
    rng = np.random.RandomState(M + K + N)
    x = _t(rng.randint(-128, 128, (M, K)).astype(np.int8))
    w = _t(rng.randint(-127, 128, (K, N)).astype(np.int8))
    b = _t(_wrap_bias(rng, N))
    wp = pack_gemm_weight(w)
    for kw in (dict(epilogue="int32"), dict(epilogue="int32", relu=True),
               dict(epilogue="requant8", net=9, out_signed=False)):
        want = int8_gemm_v2_plain(x, w, b, **kw)
        assert torch.equal(int8_gemm_v2_split_plain(x, wp, b, plan, **kw), want), (plan, kw)
        assert torch.equal(int8_gemm_v2(x, wp, b, plan=plan, **kw), want)


def test_engine_passes_packed_k5_and_k7_weights():
    """A MobileNetV2 engine on the CPU hands K5 the expand and project
    weights it packed at construction, for each of its 12 fused blocks; a
    ResNet-50 engine hands K7 its packed weights at each of the 33 calls."""
    import chip_smoke
    from f8net_tpu_torch.engine import IntEngine

    images = torch.from_numpy(np.random.RandomState(3).rand(1, 32, 32, 3).astype(np.float32))
    model, plan, params, _ = chip_smoke.load_synthetic_model(
        3, 32, 10, "cpu", images, model_name="mobilenet_v2"
    )
    eng = IntEngine(model, plan, params, device="cpu")
    seen = []
    irk = eng._irk
    eng._irk = lambda *a, **kw: seen.append(a) or irk(*a, **kw)
    eng(eng.condition_input(images))
    assert len(seen) == 12
    for a in seen:
        w1, w2 = a[1], a[5]
        assert isinstance(w1, PackedConvWeight) and isinstance(w2, PackedConvWeight)
        assert any(w1 is ops[0] and w2 is ops[4] for ops in eng._fused.values())
    model, plan, params, _ = chip_smoke.load_synthetic_model(
        3, 32, 10, "cpu", images, model_name="resnet50"
    )
    eng = IntEngine(model, plan, params, device="cpu")
    seen = []
    gemm2 = eng._gemm2
    eng._gemm2 = lambda x, w, *a, **kw: seen.append(w) or gemm2(x, w, *a, **kw)
    eng(eng.condition_input(images))
    assert len(seen) == 33
    assert all(isinstance(w, PackedConvWeight) and any(w is p for p in eng._packed.values())
               for w in seen)


def test_k7_route_predicate():
    """K7 takes a pointwise conv's GEMM inside its domain and at least
    MIN_N columns wide: ResNet-50's 33, MobileNetV2's tail and six of its
    per-layer 1x1 convs; K1 keeps MobileNetV2's K = 24 expand and its
    16- and 24-column projects, and every classifier."""
    import chip_smoke
    from f8net_tpu_torch.engine import IntEngine

    assert gemm_v2_ops.takes(64, 32) and gemm_v2_ops.takes(3328, 2048)
    assert not gemm_v2_ops.takes(24, 144) and not gemm_v2_ops.takes(3344, 64)
    assert not gemm_v2_ops.takes(96, 24) and not gemm_v2_ops.takes(32, 16)
    assert not gemm_v2_ops.takes(64, 34)
    images = torch.from_numpy(np.random.RandomState(4).rand(1, 32, 32, 3).astype(np.float32))
    model, plan, params, _ = chip_smoke.load_synthetic_model(
        4, 32, 10, "cpu", images, model_name="mobilenet_v2"
    )
    eng = IntEngine(model, plan, params, device="cpu")
    g = model.graph
    on = {n for n in g.names() if eng.on_k7(n)}
    assert len(on) == 7 and "tail" in on and "classifier" not in on
    assert {(g[n].in_ch, g[n].out_ch) for n in on} == {
        (16, 96), (144, 32), (32, 192), (192, 64), (96, 576), (576, 160), (320, 1280)}
    assert all(isinstance(eng._packed[n], PackedConvWeight) for n in on)


def test_chip_smoke_work_counts_logical_shapes():
    """chip_smoke.work bounds a K5 or K7 call by the function's logical
    shapes: the same bytes and operations for packed and plain weights."""
    import chip_smoke

    rng = np.random.RandomState(5)
    x = _t(rng.randint(-128, 128, (300, 96)).astype(np.int8))
    w = _t(rng.randint(-127, 128, (96, 40)).astype(np.int8))
    b = _t(rng.randint(-100, 100, 40).astype(np.int32))
    out = int8_gemm_v2(x, w, b)
    plain = chip_smoke.work("int8_gemm_v2", (x, w, b), {}, out)
    assert plain == chip_smoke.work("int8_gemm_v2", (x, pack_gemm_weight(w), b), {}, out)
    assert plain == (300 * 96 + 96 * 40 + 40 * 4 + 300 * 40 * 4, 2 * 300 * 96 * 40)
    n, h, cin, ce, cout = 2, 5, 24, 72, 32
    xi = _t(rng.randint(-128, 128, (n, h, h, cin)).astype(np.int8))
    w1 = _t(rng.randint(-40, 41, (cin, ce)).astype(np.int8))
    wd = _t(rng.randint(-127, 128, (3, 3, ce)).astype(np.int8))
    w2 = _t(rng.randint(-40, 41, (ce, cout)).astype(np.int8))
    b1, bd = (_t(rng.randint(-100, 100, ce).astype(np.int32)) for _ in range(2))
    b2 = _t(rng.randint(-100, 100, cout).astype(np.int32))
    args = (xi, w1, b1, wd, bd, w2, b2, None)
    y = fused_ir_block(*args, net1=8, net2=12)
    plain = chip_smoke.work("ir_block", args, {}, y)
    packed = (xi, pack_gemm_weight(w1), b1, wd, bd, pack_gemm_weight(w2), b2, None)
    assert plain == chip_smoke.work("ir_block", packed, {}, y)
    assert plain[1] == 2 * n * h * h * (cin * ce + 9 * ce + ce * cout)
