"""K2's and K3's packed weights, K2's split-K planner and split arithmetic,
on the CPU.

- `pack_conv_weight` / `pack_stem_weight` with the plain versions that
  compute from the packed layouts (the implicit GEMM in the kernels'
  reduction order), bitwise against the Pallas kernels they replace in
  interpret mode, as tests/test_torch_kernels_ref.py runs them;
- `plan_conv` at the K2 shapes of ResNet-18 and ResNet-50 at 224 px, batch
  8: every reduction byte covered exactly once, and at least one block per SM
  wherever it splits;
- the split arithmetic (int32 partials over the planner's reduction ranges,
  one epilogue on the wrapped sum) bitwise against the unsplit plain
  version, biases that wrap included;
- the engine hands K2 and K3 the weights it packed at construction.
Tolerance 0 throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from f8net_tpu.ops.pallas_conv import pallas_conv_int8
from f8net_tpu.ops.pallas_stem import build_stem_inputs_v2, stem_pool_int8_v2
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.ops import conv as conv_ops
from f8net_tpu_torch.ops.conv import (
    BK, PackedConvWeight, conv_int8_plain, conv_int8_split_plain, pack_conv_weight, plan_conv,
    split_ranges, unpack_conv_weight,
)
from f8net_tpu_torch.ops.stem import STEM_K, pack_stem_weight, stem_pool_plain
from f8net_tpu_torch.utils import QuantConfig

IMAX = (1 << 31) - 1


def _t(a):
    return torch.from_numpy(np.array(a))


def _wrap_bias(rng, o):
    b = rng.randint(-(1 << 14), 1 << 14, o).astype(np.int64)
    b[::2] = IMAX - rng.randint(0, 1 << 12, b[::2].shape)  # acc + bias wraps for some outputs
    b[1::2] = -IMAX + rng.randint(0, 1 << 12, b[1::2].shape)
    return b.astype(np.int32)


def test_pack_conv_weight_layout_and_round_trip():
    rng = np.random.RandomState(0)
    w = _t(rng.randint(-127, 128, (3, 3, 48, 20)).astype(np.int8))
    p = pack_conv_weight(w)
    k = 3 * 3 * 48
    assert isinstance(p, PackedConvWeight) and p.shape == (3, 3, 48, 20)
    assert tuple(p.data.shape) == (-(-k // BK) * BK // 16, 64, 16) and p.data.dtype == torch.int8
    flat = w.reshape(k, 20)
    for q, n, b in [(0, 0, 0), (5, 7, 3), (26, 19, 15), (3, 11, 9)]:
        assert p.data[q, n, b] == flat[16 * q + b, n]
    m = p.data.permute(0, 2, 1).reshape(-1, 64)
    assert not m[k:].any() and not m[:, 20:].any()  # zero past K and past O
    assert torch.equal(unpack_conv_weight(p), w)


# (h, c, o, k, stride, padding, pad_value, epilogue, net, out_signed, relu)
PACKED_CASES = [
    (9, 32, 64, 3, 1, 1, 0, "int32", 0, True, False),
    (9, 16, 48, 3, 2, 1, -128, "requant8", 6, False, False),  # C = 16: 4 taps per step
    (8, 16, 32, 1, 2, 0, -128, "int32", 0, True, False),  # 1x1/s2 shortcut
    (8, 32, 20, 1, 1, 0, 0, "requant8", 5, True, True),
    (10, 16, 32, 5, 1, 2, -128, "int32", 0, True, True),
    (11, 48, 24, 5, 2, 2, 0, "requant8", 7, True, False),
    (7, 80, 64, 3, 1, 1, -128, "requant8", -1, False, False),  # 5 chunks per tap
    (6, 16, 32, 3, 2, 1, 0, "int32", 0, True, False),
]


@pytest.mark.parametrize(
    "h,c,o,k,stride,padding,pad_value,epilogue,net,out_signed,relu", PACKED_CASES
)
def test_conv_packed_plain_vs_pallas(h, c, o, k, stride, padding, pad_value, epilogue, net,
                                     out_signed, relu):
    rng = np.random.RandomState(h * 31 + c + o + k * 7 + stride)
    x = rng.randint(-128, 128, (2, h, h, c)).astype(np.int8)
    w = rng.randint(-20, 21, (k, k, c, o)).astype(np.int8)
    b = rng.randint(-(1 << 14), 1 << 14, (o,)).astype(np.int32)
    kw = dict(stride=stride, padding=padding, pad_value=pad_value, epilogue=epilogue,
              net=net, out_signed=out_signed, relu=relu)
    want = pallas_conv_int8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), boh=4, **kw)
    got = conv_int8_plain(_t(x), pack_conv_weight(_t(w)), _t(b), **kw)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pack_stem_weight_layout():
    rng = np.random.RandomState(1)
    w = _t(rng.randint(-127, 128, (7, 7, 3, 64)).astype(np.int8))
    p = pack_stem_weight(w).reshape(64, 7, 8, 4)
    assert STEM_K == 224
    assert torch.equal(p[:, :, :7, :3], w.permute(3, 0, 1, 2))
    assert not p[:, :, 7].any() and not p[:, :, :, 3].any()


@pytest.mark.parametrize("unsigned", [True, False])
def test_stem_packed_plain_vs_pallas_v2(unsigned):
    size = 32
    rng = np.random.RandomState(size + unsigned + 7)
    zp = 128 if unsigned else 0
    v8 = rng.randint(-128 if unsigned else -127, 128, (2, size, size, 3)).astype(np.int8)
    w = rng.randint(-20, 21, (7, 7, 3, 64)).astype(np.int8)
    b = rng.randint(-(1 << 14), 1 << 14, (64,)).astype(np.int32)
    be, bo, w256, comp = build_stem_inputs_v2(
        jnp.asarray(v8), jnp.asarray(w), conv_h=size // 2, zero_point=zp
    )
    want = stem_pool_int8_v2(
        be, bo, w256, jnp.asarray(b) + comp, conv_h=size // 2, valid_w=size // 4
    )
    b_zp = (b.astype(np.int64) + zp * w.astype(np.int64).sum((0, 1, 2))).astype(np.int32)
    got = stem_pool_plain(_t(v8), pack_stem_weight(_t(w)), _t(b_zp), pad_value=-zp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("h,w,pad_value", [(33, 35, -128), (18, 21, 0), (36, 44, 0)])
def test_stem_packed_plain_vs_hwio_plain(h, w, pad_value):
    """Odd and ragged sizes, where the packed layout's 8th tap runs past the
    padded input: the same output as the conv2d from HWIO, biases that wrap
    included."""
    rng = np.random.RandomState(h * w)
    x = _t(rng.randint(-128, 128, (2, h, w, 3)).astype(np.int8))
    wt = _t(rng.randint(-127, 128, (7, 7, 3, 64)).astype(np.int8))
    b = _t(_wrap_bias(rng, 64))
    want = stem_pool_plain(x, wt, b, pad_value=pad_value)
    assert torch.equal(stem_pool_plain(x, pack_stem_weight(wt), b, pad_value=pad_value), want)


def _k2_shapes(depth, image_size=224, batch=8):
    """(M, K, O) of every K2 call of a ResNet forward: each 3x3 conv and each
    1x1/s2 shortcut, at the block input's spatial size."""
    model = get_model(f"resnet{depth}", QuantConfig(), num_classes=1000, image_size=image_size)
    g, shapes, size = model.graph, [], image_size // 4

    def out_size(name, inp):
        spec = g[name]
        o_size = (inp + 2 * spec.padding[0] - spec.kernel[0]) // spec.stride[0] + 1
        if spec.kernel != (1, 1) or spec.stride != (1, 1):  # else K1 / K7
            shapes.append((batch * o_size * o_size, spec.kernel[0] ** 2 * spec.in_ch, spec.out_ch))
        return o_size

    for meta in model.blocks:
        cur = size
        for name in meta.body:
            cur = out_size(name, cur)
        if meta.shortcut is not None:
            out_size(meta.shortcut, size)
        size = cur
    return shapes


@pytest.mark.parametrize("depth", [18, 50])
def test_plan_conv_covers_the_reduction_once(depth):
    shapes = _k2_shapes(depth)
    assert len(shapes) == 19
    split_any = False
    for m, k, o in shapes:
        plan = plan_conv(m, k, o)
        assert plan.ksteps * BK >= k > (plan.ksteps - 1) * BK
        assert plan.mtiles * conv_ops.BM >= m and plan.ntiles * plan.bn == plan.o_pad >= o
        covered = np.zeros(plan.ksteps * BK, np.int64)
        ranges = split_ranges(plan)
        assert len(ranges) == plan.splits
        for lo, hi in ranges:
            assert hi - lo >= conv_ops.SPLIT_MIN_STEPS or plan.splits == 1
            covered[lo * BK: hi * BK] += 1
        assert (covered == 1).all(), (m, k, o, plan)
        assert 1 <= plan.splits <= conv_ops.MAX_SPLITS
        if plan.splits > 1:  # too few tiles: split until they fill the SMs or a cluster
            split_any = True
            assert plan.mtiles * plan.o_pad // 64 * 2 < conv_ops.H100_SMS
            assert plan.blocks >= conv_ops.H100_SMS or plan.splits == conv_ops.MAX_SPLITS
    assert split_any
    # stage 3's 3x3 convs: M = 392 is 4 x 4 tiles of 128 x 128, split 8 ways (128 blocks)
    assert plan_conv(392, 4608, 512) == conv_ops.ConvPlan(128, 512, 72, 4, 4, 8)
    # stage 2's: 13 x 2 tiles, split 8 ways; its 1x1/s2 shortcut has too few steps to split
    assert plan_conv(1568, 2304, 256) == conv_ops.ConvPlan(128, 256, 36, 13, 2, 8)
    assert plan_conv(1568, 128, 256) == conv_ops.ConvPlan(64, 256, 2, 13, 4, 1)
    # stage 0's: 196 tiles of 128 x 64 fill the SMs
    assert plan_conv(25088, 576, 64) == conv_ops.ConvPlan(64, 64, 9, 196, 1, 1)


@pytest.mark.parametrize(
    "n,h,c,o,k,stride,pad_value,sms",
    [(2, 7, 64, 64, 3, 1, -128, 4), (1, 9, 64, 132, 3, 2, 0, 8), (2, 5, 80, 8, 5, 1, 0, 3),
     (1, 8, 512, 64, 1, 2, -128, 4)],
)
def test_split_k_plain_equals_unsplit(n, h, c, o, k, stride, pad_value, sms):
    rng = np.random.RandomState(n + h + c + o + k)
    x = _t(rng.randint(-128, 128, (n, h, h, c)).astype(np.int8))
    w = _t(rng.randint(-127, 128, (k, k, c, o)).astype(np.int8))
    b = _t(_wrap_bias(rng, o))
    wp = pack_conv_weight(w)
    p = (k - 1) // 2
    oh = (h + 2 * p - k) // stride + 1
    plan = plan_conv(n * oh * oh, k * k * c, o, sms)
    assert plan.splits > 1
    for epi in (dict(epilogue="int32"), dict(epilogue="int32", relu=True),
                dict(epilogue="requant8", net=9, out_signed=False)):
        kw = dict(stride=stride, padding=p, pad_value=pad_value, **epi)
        want = conv_int8_plain(x, w, b, **kw)
        assert torch.equal(conv_int8_split_plain(x, wp, b, plan, **kw), want), (plan, epi)


def test_engine_passes_packed_weights():
    """A ResNet-18 engine on the CPU hands K2 the PackedConvWeight it made
    for each of the 19 layers and K3 the packed stem weights; MobileNetV2's
    head goes to K2 packed with its channels padded to 16."""
    import chip_smoke
    from f8net_tpu_torch.engine import IntEngine

    images = torch.from_numpy(np.random.RandomState(2).rand(1, 32, 32, 3).astype(np.float32))
    for path, n_k2 in (("resnet18", 19), ("mobilenet_v2", 1)):
        model, plan, params, _ = chip_smoke.load_synthetic_model(
            2, 32, 10, "cpu", images, model_name=path
        )
        eng = IntEngine(model, plan, params, device="cpu")
        seen = []
        conv, stem = eng._convk, eng._stemk
        eng._convk = lambda x, w, *a, **kw: seen.append(w) or conv(x, w, *a, **kw)
        eng._stemk = lambda x, w, *a, **kw: seen.append(w) or stem(x, w, *a, **kw)
        eng(eng.condition_input(images))
        packed = [w for w in seen if isinstance(w, PackedConvWeight)]
        assert len(packed) == n_k2 and all(any(w is p for p in eng._packed.values()) for w in packed)
        if path == "resnet18":
            assert len(seen) == 20 and seen[0] is eng._stem_w
            assert tuple(eng._stem_w.shape) == (64, STEM_K)
        else:
            assert len(seen) == 1 and seen[0].c == 16
