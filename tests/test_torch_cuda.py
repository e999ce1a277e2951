"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: every test skips where torch.cuda.is_available() is false.
The machine with the card has no JAX, so run this file there without the
suite's conftest (which configures JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Shapes cover the ragged edges the main path does not: M, N and C that are
not multiples of the 64-wide tiles, a GEMM N (class count) not a multiple of
4, GEMM K not a multiple of 16 (MobileNetV2's K = 24) or of 4, odd spatial
sizes at stride 2, 5x5 kernels, K2 with packed and HWIO weights at shapes
that split the reduction across a cluster (ResNet's stage 3), at
ResNet-50's last 1x1/s2 shortcut and at
MobileNetV2's C = 16 head, K3 on pooled maps that do not fill a tile and on
more tiles than its persistent grid holds, depthwise channel counts that
split unevenly across blocks, K5 at MobileNetV2's twelve block shapes at batch 1-2 and at ragged
channel counts, under forced plans (band heights with halos, Ce split
across clusters of 2-8), with plain and packed weights, K7 at K = 64 and
K = 2048 with M tails, at M = 25088, under forced plans (both tile widths,
clusters of 2 and 8, persistent grids smaller than the tile count), with
plain and packed weights, K6 on every row of 7x7, 14x14 and 56x56 rasters
with the ring masked and not, at C = 16, 48 and 80 (a channel slice that
reaches into the next tap's weights), halos of more than 256 rows, on HWIO
and packed weights under every plan its planner weighs (split across
clusters or not, both tile widths), negative shifts, ReLU, and biases that make the int32 epilogue and the
K5 carry add wrap; K5's boundary-rung forms (1-byte carry with offsets 0
and 128, bf16 output) under every plan its planner weighs at MobileNetV2's
shapes, at couts whose 1-byte carry rows are 4- and 8-byte aligned, at
2^24 + 2^16 + 1 (rounded twice to bf16), the forms its wrapper refuses,
and every Ce slice of a tensor-parallel rank at tp = 2 and 4;
K1 in each of its forms (skinny at M = 1-64 under every column group and
split of the reduction its planner weighs, narrow at K = 24, 32 and 96 with
persistent grids of 1 block to 4 per SM, general at K % 16 != 0 and N % 4
!= 0) on packed and plain weights; K4 at k = 3, 5, 7 and 9 under every
tile its planner weighs on small maps and under a single persistent block;
and the engine's three rungs at 64 px.  Every comparison is bitwise.
"""

import numpy as np
import pytest
import torch

from f8net_tpu_torch.ops import conv_flat_int8, conv_int8, dw_int8, fused_ir_block, int8_gemm
from f8net_tpu_torch.ops import int8_gemm_v2, pack_flat, stem_pool, unpack_flat
from f8net_tpu_torch.ops import PackedConvWeight, pack_conv_weight, pack_stem_weight
from f8net_tpu_torch.ops.conv import conv_int8_plain
from f8net_tpu_torch.ops import dw as dw_ops
from f8net_tpu_torch.ops import gemm as gemm_ops
from f8net_tpu_torch.ops.gemm_v2 import GemmPlan, pack_gemm_weight
from f8net_tpu_torch.ops.ir_block import _layout as ir_layout
from f8net_tpu_torch.ops.conv_flat import conv_flat_int8_plain, flat_candidates, plan_flat
from f8net_tpu_torch.ops.dw import dw_int8_plain
from f8net_tpu_torch.ops.gemm import int8_gemm_plain
from f8net_tpu_torch.ops.ir_block import fused_ir_block_plain
from f8net_tpu_torch.ops.stem import stem_pool_plain

pytestmark = pytest.mark.cuda

IMAX = (1 << 31) - 1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _int8(rng, shape, lo=-128, hi=128):
    return torch.from_numpy(rng.randint(lo, hi, shape).astype(np.int8))


def _bias(rng, n, wrap):
    b = rng.randint(-(1 << 16), 1 << 16, n)
    if wrap:  # acc + bias leaves the int32 range for some outputs
        b[::2] = IMAX - rng.randint(0, 1 << 12, b[::2].shape)
        b[1::2] = -IMAX + rng.randint(0, 1 << 12, b[1::2].shape)
    return torch.from_numpy(b.astype(np.int32))


GEMM_EPILOGUES = [
    dict(epilogue="int32"),
    dict(epilogue="int32", relu=True),
    dict(epilogue="requant8", net=7, out_signed=True),
    dict(epilogue="requant8", net=20, out_signed=False),
    dict(epilogue="requant8", net=-2, out_signed=True, relu=True),
]


@pytest.mark.parametrize(
    "M,K,N",
    [(8, 512, 1000), (1, 16, 4), (130, 48, 72), (65, 64, 68), (5, 32, 10),
     (25088, 24, 144), (130, 24, 72), (33, 16, 40), (17, 28, 12)],
)
@pytest.mark.parametrize("wrap", [False, True])
def test_int8_gemm_kernel_vs_plain(dev, M, K, N, wrap):
    rng = np.random.RandomState(M + K + N + wrap)
    x, w, b = _int8(rng, (M, K)), _int8(rng, (K, N), -127), _bias(rng, N, wrap)
    for kw in GEMM_EPILOGUES:
        got = int8_gemm(x.to(dev), w.to(dev), b.to(dev), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), int8_gemm_plain(x, w, b, **kw)), kw


# (M, K, N): every K1 form -- skinny at M = 1, 8, 33, 64 (a 10-class head
# and the 1000-class classifier at K = 512 and 2048), narrow at MobileNetV2's
# three shapes (batch 1) and a ragged M tail, general at K % 16 != 0 and
# N % 4 != 0
K1_PLAN_SHAPES = [(1, 512, 1000), (8, 2048, 1000), (64, 1280, 1000), (33, 64, 40), (8, 512, 10),
                  (12544, 32, 16), (3136, 96, 24), (3136, 24, 144), (1000, 24, 72),
                  (77, 20, 10), (300, 44, 36)]


@pytest.mark.parametrize("M,K,N", K1_PLAN_SHAPES)
def test_int8_gemm_every_plan_vs_plain(dev, M, K, N):
    """K1 under every plan its planner weighs for the call (skinny: its one
    plan, 1-4 m16 tiles of rows; narrow: persistent grids, 8 or 16 warps),
    on packed and plain weights, both epilogues, biases near INT32_MAX."""
    rng = np.random.RandomState(M + K + N + 7)
    x, w, b = _int8(rng, (M, K)), _int8(rng, (K, N), -127), _bias(rng, N, True)
    xd, wd, bd = x.to(dev), w.to(dev), b.to(dev)
    wp = gemm_ops.pack_k1_weight(wd)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = gemm_ops.k1_candidates(M, K, N, sms)
    if plans[0].form == "narrow":
        plans.append(gemm_ops.narrow_plan(M, K, N, 1))
    for kw in GEMM_EPILOGUES:
        want = int8_gemm_plain(x, w, b, **kw)
        assert torch.equal(int8_gemm(xd, wd, bd, **kw).cpu(), want), kw
        for plan in plans:
            got = int8_gemm(xd, wp, bd, plan=plan, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (plan, kw)


@pytest.mark.parametrize(
    "M,K,N",
    [(392, 2048, 512), (25088, 64, 256), (25088, 64, 64), (1568, 1024, 512), (130, 48, 72),
     (65, 16, 4), (1, 3328, 8), (200, 96, 132), (300, 64, 256), (1000, 2048, 512),
     (1568, 1024, 256), (6272, 512, 128), (777, 64, 68)],
)
@pytest.mark.parametrize("wrap", [False, True])
def test_int8_gemm_v2_kernel_vs_k1_and_plain(dev, M, K, N, wrap):
    rng = np.random.RandomState(M + K + N + wrap + 1)
    x, w, b = _int8(rng, (M, K)), _int8(rng, (K, N), -127), _bias(rng, N, wrap)
    xd, wd, bd = x.to(dev), w.to(dev), b.to(dev)
    for kw in GEMM_EPILOGUES:
        got = int8_gemm_v2(xd, wd, bd, **kw)
        k1 = int8_gemm(xd, wd, bd, **kw)
        packed = int8_gemm_v2(xd, pack_gemm_weight(wd), bd, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, k1), kw
        assert torch.equal(packed, got), kw
        assert torch.equal(got.cpu(), int8_gemm_plain(x, w, b, **kw)), kw


# (M, K, N, plan): tile widths, splits of 2 and 8 across a cluster, and
# persistent grids smaller than the tile count (several tiles per block)
GEMM_PLANS = [
    (1000, 256, 256, GemmPlan(64, 256, 4, 8, 4, 1, 3)),
    (1000, 256, 256, GemmPlan(128, 256, 4, 8, 2, 1, 5)),
    (1000, 256, 256, GemmPlan(128, 256, 4, 8, 2, 2, 32)),
    (392, 2048, 200, GemmPlan(64, 256, 32, 4, 4, 8, 128)),
    (129, 64, 64, GemmPlan(64, 64, 1, 2, 1, 1, 1)),
]


@pytest.mark.parametrize("M,K,N,plan", GEMM_PLANS)
def test_int8_gemm_v2_plans_vs_plain(dev, M, K, N, plan):
    rng = np.random.RandomState(M + K + N + plan.grid)
    x, w, b = _int8(rng, (M, K)), _int8(rng, (K, N), -127), _bias(rng, N, True)
    wp = pack_gemm_weight(w.to(dev))
    for kw in GEMM_EPILOGUES:
        got = int8_gemm_v2(x.to(dev), wp, b.to(dev), plan=plan, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), int8_gemm_plain(x, w, b, **kw)), (plan, kw)


# (n, h, w, c, o, k, pad_value)
FLAT_SHAPES = [
    (8, 7, 7, 512, 512, 3, -128),  # ResNet's 7x7 stage at batch 8: split across clusters
    (8, 14, 14, 256, 256, 3, -128),  # its 14x14 stage
    (2, 56, 56, 64, 64, 3, -128),
    (1, 56, 56, 512, 64, 3, 0),
    (2, 7, 7, 64, 68, 3, 0),
    (2, 9, 11, 48, 20, 5, -128),
    (3, 1, 2, 16, 8, 3, 0),
    (2, 5, 6, 16, 20, 3, -128),  # channel tails: C = 16, 48, 80 reach into the next tap
    (1, 9, 13, 80, 68, 5, 0),
    (1, 3, 200, 16, 8, 3, -128),  # a halo of R = 534 > 256 rows
    (1, 5, 120, 48, 64, 5, 0),  # 5x5 on a wide raster: R = 628
]


@pytest.mark.parametrize("n,h,w,c,o,k,pad_value", FLAT_SHAPES)
@pytest.mark.parametrize("mask_pad", [True, False])
def test_conv_flat_kernel_vs_plain(dev, n, h, w, c, o, k, pad_value, mask_pad):
    """K6 on HWIO and packed weights, under its planner's plan and under
    every plan flat_candidates lists (both tile widths, split and not),
    every row bitwise equal to the plain version."""
    rng = np.random.RandomState(h * w + c + o + k + mask_pad)
    p = (k - 1) // 2
    x, wt = _int8(rng, (n, h, w, c)), _int8(rng, (k, k, c, o), -127)
    b = _bias(rng, o, wrap=not mask_pad)
    xf, geom = pack_flat(x, p, pad_value)
    xd, wd, bd = xf.to(dev), wt.to(dev), b.to(dev)
    wp = pack_conv_weight(wd)
    plans = flat_candidates(c, o, k, geom[2])
    assert plans
    for kw in GEMM_EPILOGUES:
        if kw["epilogue"] == "int32":
            mask_value = 3
        else:  # the consumer's packed zero
            mask_value = 0 if kw["out_signed"] else -128
        kw = dict(kw, geom=geom, kernel=(k, k), mask_pad=mask_pad, mask_value=mask_value)
        want = conv_flat_int8_plain(xf, wt, b, **kw)
        got = conv_flat_int8(xd, wd, bd, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), kw  # every row
        for plan in plans:
            got = conv_flat_int8(xd, wp, bd, plan=plan, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (plan, kw)
        if kw["epilogue"] == "int32" and not kw.get("relu"):  # the interior is K2's conv
            want = conv_int8_plain(x, wt, b, padding=p, pad_value=pad_value)
            assert torch.equal(unpack_flat(got.cpu(), geom, p), want)


# (n, h, w, c, o, k, stride, padding, pad_value)
CONV_SHAPES = [
    (2, 7, 7, 64, 64, 3, 2, 1, -128),
    (1, 9, 11, 48, 20, 3, 2, 1, 0),
    (3, 8, 8, 16, 68, 3, 1, 1, -128),
    (1, 13, 13, 32, 8, 5, 2, 2, -128),
    (2, 10, 10, 128, 132, 1, 2, 0, 0),
    (1, 5, 6, 80, 64, 3, 1, 1, 0),
    (1, 9, 9, 32, 12, 3, 1, 1, -128),
    (2, 7, 7, 512, 512, 3, 1, 1, -128),  # stage 3: M = 98 in one tile row, split 8 ways
    (2, 14, 14, 256, 256, 3, 1, 1, 0),  # 392 rows: 4 x 4 tiles, split 8 ways
    (3, 14, 14, 256, 512, 3, 2, 1, -128),  # stride 2, 147 rows: 2 x 8 tiles, split 8 ways
    (1, 15, 13, 64, 128, 3, 1, 1, 0),  # ragged M tail: 195 rows in two tiles of 128
    (1, 224, 224, 16, 32, 3, 2, 1, -128),  # MobileNetV2's head: C = 16, 4 taps per step
    (8, 14, 14, 1024, 2048, 1, 2, 0, 0),  # ResNet-50's last 1x1/s2 shortcut
    (1, 10, 10, 128, 64, 3, 1, 0, 0),  # no padding
]


@pytest.mark.parametrize("n,h,w,c,o,k,stride,padding,pad_value", CONV_SHAPES)
@pytest.mark.parametrize("wrap", [False, True])
def test_conv_int8_kernel_vs_plain(dev, n, h, w, c, o, k, stride, padding, pad_value, wrap):
    rng = np.random.RandomState(h * w + c + o + k + wrap)
    x, wt, b = _int8(rng, (n, h, w, c)), _int8(rng, (k, k, c, o), -127), _bias(rng, o, wrap)
    xd, wd, bd = x.to(dev), wt.to(dev), b.to(dev)
    wp = pack_conv_weight(wd)
    for kw in GEMM_EPILOGUES:
        kw = dict(kw, stride=stride, padding=padding, pad_value=pad_value)
        got = conv_int8(xd, wp, bd, **kw)  # weights packed once, as the engine passes them
        got_hwio = conv_int8(xd, wd, bd, **kw)
        torch.cuda.synchronize()
        want = conv_int8_plain(x, wt, b, **kw)
        assert torch.equal(got.cpu(), want), kw
        assert torch.equal(got_hwio.cpu(), want), kw


@pytest.mark.parametrize(
    "n,h,w",
    # (2, 40, 52) and (3, 21, 100): pooled maps of 10 x 13 and 6 x 25, which
    # leave 8 x 8 tiles part-filled on both axes
    [(1, 224, 224), (2, 32, 32), (2, 36, 44), (1, 33, 35), (2, 40, 52), (3, 21, 100),
     (3, 1, 2)],
)
@pytest.mark.parametrize("pad_value", [-128, 0])
def test_stem_pool_kernel_vs_plain(dev, n, h, w, pad_value):
    rng = np.random.RandomState(h * w + (pad_value == 0))
    x, wt = _int8(rng, (n, h, w, 3)), _int8(rng, (7, 7, 3, 64), -127)
    b = torch.from_numpy(rng.randint(-(1 << 16), 1 << 16, 64).astype(np.int32))
    want = stem_pool_plain(x, wt, b, pad_value=pad_value)
    for wk in (wt.to(dev), pack_stem_weight(wt.to(dev))):  # HWIO, and packed as by the engine
        got = stem_pool(x.to(dev), wk, b.to(dev), pad_value=pad_value)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


def test_stem_pool_kernel_persistent_grid(dev):
    """More pooled tiles than resident blocks (batch 64 at 224 px: 3136
    tiles), so every block walks several tiles with the next one's rows in
    flight."""
    rng = np.random.RandomState(5)
    x, wt = _int8(rng, (64, 224, 224, 3)), _int8(rng, (7, 7, 3, 64), -127)
    b = torch.from_numpy(rng.randint(-(1 << 16), 1 << 16, 64).astype(np.int32))
    xd, wd, bd = x.to(dev), wt.to(dev), b.to(dev)
    got = stem_pool(xd, pack_stem_weight(wd), bd, pad_value=-128)
    torch.cuda.synchronize()
    assert torch.equal(got, stem_pool_plain(xd, wd, bd, pad_value=-128))


# (n, h, w, c, k, stride, padding, pad_value): MobileNetV2's shapes and
# ragged ones, k = 1 to 9
DW_SHAPES = [
    (2, 112, 112, 32, 3, 1, 1, -128),
    (1, 9, 11, 48, 3, 2, 1, 0),
    (2, 7, 7, 960, 3, 1, 1, -128),
    (1, 15, 15, 144, 3, 2, 1, -128),
    (3, 8, 8, 16, 5, 2, 2, 0),
    (1, 13, 13, 1024, 3, 1, 1, 0),
    (1, 6, 5, 80, 1, 1, 0, 0),
    (2, 14, 14, 576, 3, 2, 1, -128),
    (1, 19, 17, 64, 7, 1, 3, -128),
    (2, 21, 23, 32, 9, 2, 4, 0),
    (1, 10, 10, 96, 9, 1, 4, -128),
]


@pytest.mark.parametrize("n,h,w,c,k,stride,padding,pad_value", DW_SHAPES)
@pytest.mark.parametrize("wrap", [False, True])
def test_dw_int8_kernel_vs_plain(dev, n, h, w, c, k, stride, padding, pad_value, wrap):
    rng = np.random.RandomState(h * w + c + k + stride + wrap)
    x, wt, b = _int8(rng, (n, h, w, c)), _int8(rng, (k, k, 1, c), -127), _bias(rng, c, wrap)
    for kw in GEMM_EPILOGUES:
        kw = dict(kw, stride=stride, padding=padding, pad_value=pad_value)
        got = dw_int8(x.to(dev), wt.to(dev), b.to(dev), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), dw_int8_plain(x, wt, b, **kw)), kw


# MobileNetV1's depthwise calls at 224 px, batch 8, (h, w, c, stride): the 13
# calls take 9 shapes (five 14x14 x 512 at stride 1)
MBV1_DW_CALLS = [(112, 112, 32, 1), (112, 112, 64, 2), (56, 56, 128, 1), (56, 56, 128, 2),
                 (28, 28, 256, 1), (28, 28, 256, 2), (14, 14, 512, 1), (14, 14, 512, 2),
                 (7, 7, 1024, 1)]


@pytest.mark.parametrize("h,w,c,stride", MBV1_DW_CALLS)
def test_dw_int8_mobilenet_v1_calls_vs_plain(dev, h, w, c, stride):
    """K4 at MobileNetV1's depthwise shapes under plan_dw's plan, both
    epilogues, the unsigned and the signed pad."""
    rng = np.random.RandomState(h + c + stride)
    x, wt, b = _int8(rng, (8, h, w, c)), _int8(rng, (3, 3, 1, c), -127), _bias(rng, c, False)
    for kw in (GEMM_EPILOGUES[0], GEMM_EPILOGUES[3]):
        for pad_value in (-128, 0):
            kw = dict(kw, stride=stride, padding=1, pad_value=pad_value)
            got = dw_int8(x.to(dev), wt.to(dev), b.to(dev), **kw)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), dw_int8_plain(x, wt, b, **kw)), kw


# MobileNetV1's pointwise GEMMs at 224 px, batch 8, (M, K, N): the 13 calls
# take 9 shapes (five 1568 x 512 x 512)
MBV1_PW_CALLS = [(100352, 32, 64), (25088, 64, 128), (25088, 128, 128), (6272, 128, 256),
                 (6272, 256, 256), (1568, 256, 512), (1568, 512, 512), (392, 512, 1024),
                 (392, 1024, 1024)]


@pytest.mark.parametrize("M,K,N", MBV1_PW_CALLS)
def test_int8_gemm_v2_mobilenet_v1_calls_vs_plain(dev, M, K, N):
    """K7 at MobileNetV1's pointwise shapes on weights packed as the engine
    packs them: requant8 (every call but the last) and int32 with ReLU."""
    rng = np.random.RandomState(M + K + N)
    x, w, b = _int8(rng, (M, K)), _int8(rng, (K, N), -127), _bias(rng, N, False)
    wp = pack_gemm_weight(w.to(dev))
    for kw in (GEMM_EPILOGUES[1], GEMM_EPILOGUES[3]):
        got = int8_gemm_v2(x.to(dev), wp, b.to(dev), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), int8_gemm_plain(x, w, b, **kw)), kw


# (n, h, w, c, k, stride, padding): small maps on which K4 runs under every
# tile its planner weighs, and under one persistent block
DW_PLAN_SHAPES = [(1, 13, 11, 48, 3, 1, 1), (2, 9, 9, 32, 3, 2, 1), (1, 12, 12, 64, 5, 1, 2),
                  (1, 11, 13, 32, 7, 2, 3), (1, 10, 9, 16, 9, 1, 4)]


@pytest.mark.parametrize("n,h,w,c,k,stride,padding", DW_PLAN_SHAPES)
def test_dw_int8_every_plan_vs_plain(dev, n, h, w, c, k, stride, padding):
    rng = np.random.RandomState(h * w + c + k)
    x, wt, b = _int8(rng, (n, h, w, c)), _int8(rng, (k, k, 1, c), -127), _bias(rng, c, True)
    xd, wd, bd = x.to(dev), wt.to(dev), b.to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = dw_ops.dw_candidates(n, h, w, c, k, stride, padding, sms)
    plans.append(plans[0]._replace(grid=1))  # one block walks every tile
    for kw in (GEMM_EPILOGUES[1], GEMM_EPILOGUES[3]):
        for pad_value in (-128, 0):
            kw = dict(kw, stride=stride, padding=padding, pad_value=pad_value)
            want = dw_int8_plain(x, wt, b, **kw)
            for plan in plans:
                got = dw_int8(xd, wd, bd, plan=plan, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got.cpu(), want), (plan, kw)


# (n, h, w, cin, ce, cout, k, carry)
IR_SHAPES = [
    (2, 56, 56, 24, 144, 24, 3, True),
    (8, 7, 7, 160, 960, 160, 3, True),
    (8, 7, 7, 160, 960, 320, 3, False),
    (1, 13, 11, 32, 192, 32, 3, True),
    (3, 5, 9, 24, 48, 24, 3, False),
    (1, 9, 9, 64, 384, 96, 5, False),
    (2, 14, 14, 96, 576, 96, 3, True),
    # MobileNetV2's other K5 shapes at batch 1-2
    (1, 56, 56, 24, 144, 24, 3, True),
    (2, 28, 28, 32, 192, 32, 3, True),
    (2, 14, 14, 64, 384, 64, 3, True),
    (1, 14, 14, 64, 384, 96, 3, False),
    (1, 7, 7, 160, 960, 160, 3, True),
    (2, 7, 7, 160, 960, 320, 3, False),
    # ragged: Ce, Cin and Cout not multiples of 32 or 16, 4-byte input rows
    (2, 9, 13, 20, 100, 36, 3, True),
    (1, 6, 17, 40, 68, 12, 5, False),
]
# junction formats: (dw_in_signed, proj_in_signed, out, net_out, out_signed)
IR_FORMATS = [
    (False, False, "int32", 0, False),
    (True, False, "requant8", 9, False),
    (False, True, "requant8", 7, True),
]


@pytest.mark.parametrize("n,h,w,cin,ce,cout,k,carry", IR_SHAPES)
@pytest.mark.parametrize("wrap", [False, True])
def test_fused_ir_block_kernel_vs_plain(dev, n, h, w, cin, ce, cout, k, carry, wrap):
    rng = np.random.RandomState(h * w + cin + ce + cout + k + wrap)
    x = _int8(rng, (n, h, w, cin))
    w1, wd = _int8(rng, (cin, ce), -40, 41), _int8(rng, (k, k, ce), -127)
    w2 = _int8(rng, (ce, cout), -40, 41)
    b1, bd = _bias(rng, ce, False), _bias(rng, ce, False)
    b2 = _bias(rng, cout, wrap)
    c = None
    if carry:
        c = torch.from_numpy(rng.randint(-(1 << 20), 1 << 20, (n, h, w, cout)).astype(np.int32))
        if wrap:  # carry << shift_carry leaves the int32 range for some outputs
            c[..., ::3] = IMAX - 5
    args = (x, w1, b1, wd, bd, w2, b2, c)
    for dw_s, proj_s, out, net_out, out_s in IR_FORMATS:
        kw = dict(
            net1=8, dw_in_signed=dw_s, net2=10 + k, proj_in_signed=proj_s, out=out,
            net_out=net_out, out_signed=out_s,
            shift_res=2 if carry else 0, shift_carry=1 if carry else 0,
        )
        got = fused_ir_block(*(None if a is None else a.to(dev) for a in args), **kw)
        torch.cuda.synchronize()
        want = fused_ir_block_plain(*args, **kw)
        assert torch.equal(got.cpu(), want), kw


# MobileNetV2's blocks that run whole in K5, each rank's Ce slice under
# tensor parallelism at tp = 2 and 4 (engine/tp_engine.py): int32 out, no
# carry, the rank's share of the project's bias (h, w, cin, ce/tp, cout)
TP_IR_SHARDS = [
    (h, w, cin, ce // tp, cout)
    for h, w, cin, ce, cout in [(56, 56, 24, 144, 24), (28, 28, 32, 192, 32), (14, 14, 64, 384, 64),
                                (14, 14, 64, 384, 96), (14, 14, 96, 576, 96),
                                (7, 7, 160, 960, 160), (7, 7, 160, 960, 320)]
    for tp in (2, 4)
]


@pytest.mark.parametrize("h,w,cin,ce,cout", TP_IR_SHARDS)
def test_fused_ir_block_at_tensor_parallel_shards(dev, h, w, cin, ce, cout):
    """K5 at every Ce/tp a tensor-parallel rank gives it (72, 36, 96, 48,
    192, 96, 288, 144, 480, 240), batch 8, in the form the TP engine calls:
    the int32 partial with no carry, against its plain version."""
    rng = np.random.RandomState(h + cin + ce + cout)
    x = _int8(rng, (8, h, w, cin))
    w1, wd, w2 = _int8(rng, (cin, ce), -40, 41), _int8(rng, (3, 3, ce), -127), _int8(rng, (ce, cout), -40, 41)
    b1, bd, b2 = _bias(rng, ce, False), _bias(rng, ce, False), _bias(rng, cout, True)
    args = (x, w1, b1, wd, bd, w2, b2)
    kw = dict(net1=8, dw_in_signed=False, net2=13, proj_in_signed=False, out="int32")
    got = fused_ir_block(*(a.to(dev) for a in args), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), fused_ir_block_plain(*args, **kw))


def test_kernel_checks_are_the_wrappers(dev):
    """A call a kernel refuses raises the same error from its wrapper on the
    card and from its check function (ops.*_check, which
    tests/test_torch_tp.py runs on every tensor-parallel shard shape)."""
    x = torch.zeros((2, 8, 8, 8), dtype=torch.int8, device=dev)  # C = 8: K4 takes C % 16 == 0
    w = torch.zeros((3, 3, 1, 8), dtype=torch.int8, device=dev)
    b = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="needs C % 16 == 0, got 8"):
        dw_int8(x, w, b, padding=1)
    with pytest.raises(ValueError, match="needs C % 16 == 0, got 8"):
        dw_ops.dw_int8_check(x, w, b, padding=1)
    xg = torch.zeros((4, 24), dtype=torch.int8, device=dev)  # K7 takes K % 16 == 0
    wg = torch.zeros((24, 64), dtype=torch.int8, device=dev)
    bg = torch.zeros(64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="needs K % 16 == 0, got 24"):
        int8_gemm_v2(xg, wg, bg)
    from f8net_tpu_torch.ops.gemm_v2 import int8_gemm_v2_check

    with pytest.raises(ValueError, match="needs K % 16 == 0, got 24"):
        int8_gemm_v2_check(xg, wg, bg)


# (n, h, w, cin, ce, cout, k, th, splits): bands with halos, Ce split
# across clusters of 2-8, a whole image per block
IR_PLANS = [
    (2, 14, 14, 64, 384, 96, 3, 14, 8),
    (2, 14, 14, 64, 384, 96, 3, 3, 3),
    (1, 28, 28, 32, 192, 32, 3, 1, 1),
    (2, 7, 7, 160, 960, 320, 3, 7, 4),
    (1, 9, 13, 20, 100, 36, 5, 2, 2),
]


@pytest.mark.parametrize("n,h,w,cin,ce,cout,k,th,splits", IR_PLANS)
def test_fused_ir_block_plans_vs_plain(dev, n, h, w, cin, ce, cout, k, th, splits):
    rng = np.random.RandomState(n + h + cin + ce + th + splits)
    x = _int8(rng, (n, h, w, cin))
    w1, wd = _int8(rng, (cin, ce), -40, 41), _int8(rng, (k, k, ce), -127)
    w2 = _int8(rng, (ce, cout), -40, 41)
    b1, bd, b2 = _bias(rng, ce, False), _bias(rng, ce, False), _bias(rng, cout, True)
    c = torch.from_numpy(rng.randint(-(1 << 20), 1 << 20, (n, h, w, cout)).astype(np.int32))
    units = -(-ce // 32)
    su = -(-units // splits)  # 32-channel units per slice
    plan = ir_layout(h, w, cin, ce, cout, k, th, -(-units // su), 32 * su)
    kw = dict(net1=8, dw_in_signed=False, net2=10 + k, proj_in_signed=False, out="int32",
              shift_res=1, shift_carry=2)
    got = fused_ir_block(
        x.to(dev), pack_gemm_weight(w1.to(dev)), b1.to(dev), wd.to(dev), bd.to(dev),
        pack_gemm_weight(w2.to(dev)), b2.to(dev), c.to(dev), plan=plan, **kw,
    )
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), fused_ir_block_plain(x, w1, b1, wd, bd, w2, b2, c, **kw))


# MobileNetV2's seven distinct K5 shapes (its twelve calls), (h, w, cin, ce, cout)
MBV2_IR_SHAPES = [
    (56, 56, 24, 144, 24), (28, 28, 32, 192, 32), (14, 14, 64, 384, 64),
    (14, 14, 64, 384, 96), (14, 14, 96, 576, 96), (7, 7, 160, 960, 160),
    (7, 7, 160, 960, 320),
]
# the boundary rungs' forms: (carry, carry_add_offset, out, net_out, out_signed, out_fl)
IR_RUNG_FORMS = [
    ("int8", 128, "requant8", 11, False, 0),  # int8 rung, residual block
    ("int8", 0, "int32", 0, False, 0),
    (None, 0, "bf16", 0, False, 14),  # bf16 rung
    ("int32", 0, "bf16", 0, False, 12),
]


def _ir_rung_args(rng, n, h, w, cin, ce, cout, carry, wrap=True):
    x = _int8(rng, (n, h, w, cin))
    w1, wd = _int8(rng, (cin, ce), -40, 41), _int8(rng, (3, 3, ce), -127)
    w2 = _int8(rng, (ce, cout), -40, 41)
    b1, bd, b2 = _bias(rng, ce, False), _bias(rng, ce, False), _bias(rng, cout, wrap)
    c = None
    if carry == "int8":
        c = _int8(rng, (n, h, w, cout))
        c[..., ::5] = 127  # (127 + 128) << shift_carry near the int32 range
    elif carry == "int32":
        c = torch.from_numpy(rng.randint(-(1 << 20), 1 << 20, (n, h, w, cout)).astype(np.int32))
    return (x, w1, b1, wd, bd, w2, b2, c)


@pytest.mark.parametrize("h,w,cin,ce,cout", MBV2_IR_SHAPES)
def test_fused_ir_block_rung_forms_every_plan(dev, h, w, cin, ce, cout):
    """K5's 1-byte carry and bf16 output under every plan plan_ir weighs
    (ops.ir_block.ir_candidates) at MobileNetV2's K5 shapes, batch 2, each
    against the plain version; the planner's own pick among them."""
    from f8net_tpu_torch.ops.ir_block import call_bytes, ir_candidates, plan_ir

    rng = np.random.RandomState(h + cin + cout)
    for carry, offset, out, net_out, out_signed, out_fl in IR_RUNG_FORMS:
        args = _ir_rung_args(rng, 2, h, w, cin, ce, cout, carry)
        kw = dict(net1=8, dw_in_signed=False, net2=13, proj_in_signed=False, out=out,
                  net_out=net_out, out_signed=out_signed, out_fl=out_fl, shift_res=1,
                  shift_carry=21 if carry == "int8" else 0, carry_add_offset=offset)
        want = fused_ir_block_plain(*args, **kw)
        da = [None if a is None else a.to(dev) for a in args]
        da[1], da[5] = pack_gemm_weight(da[1]), pack_gemm_weight(da[5])
        cb, ob = call_bytes(args[7], out)
        plans = list(ir_candidates(h, w, cin, ce, cout, 3, cb))
        assert plan_ir(2, h, w, cin, ce, cout, 3, torch.cuda.get_device_properties(dev)
                       .multi_processor_count, cb, ob) in plans
        for plan in plans:
            got = fused_ir_block(*da, plan=plan, **kw)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and torch.equal(got.cpu(), want), (carry, out, plan)
        assert torch.equal(fused_ir_block(*da, **kw).cpu(), want)


@pytest.mark.parametrize("cout", [24, 12, 40, 32])
def test_fused_ir_block_byte_carry_alignment(dev, cout):
    """A block's 1-byte carry rows start at element (pix0 + rlo) * cout:
    8-byte aligned at best for cout = 24 and 40, 4-byte for cout = 12,
    16-byte for 32; under plans that split the band's pixels across 1-8
    blocks at odd offsets, every form is the plain version's."""
    from f8net_tpu_torch.ops.ir_block import ir_candidates

    rng = np.random.RandomState(cout)
    n, h, w, cin, ce = 3, 9, 7, 24, 200
    for carry, offset, out, net_out, out_signed, out_fl in IR_RUNG_FORMS[:3]:
        args = _ir_rung_args(rng, n, h, w, cin, ce, cout, carry)
        kw = dict(net1=8, net2=13, out=out, net_out=net_out, out_signed=out_signed,
                  out_fl=out_fl, shift_res=2, shift_carry=20 if carry else 0,
                  carry_add_offset=offset)
        want = fused_ir_block_plain(*args, **kw)
        da = [None if a is None else a.to(dev) for a in args]
        for plan in ir_candidates(h, w, cin, ce, cout, 3, 1 if carry == "int8" else 0):
            got = fused_ir_block(*da, plan=plan, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (cout, carry, plan)


def test_fused_ir_block_bf16_rounds_twice(dev):
    """y = +-(2^24 + 2^16 + 1) (zero project weights, the bias alone): the
    kernel's bf16 output is +-2^24, int32 -> float32 -> bf16, as the plain
    version and the reference round; one rounding would give 2^24 + 2^17."""
    rng = np.random.RandomState(5)
    args = list(_ir_rung_args(rng, 2, 6, 6, 32, 64, 16, None, wrap=False))
    args[5] = torch.zeros_like(args[5])
    v = 16842753
    args[6] = torch.tensor([v, -v] * 8, dtype=torch.int32)
    kw = dict(net1=8, net2=13, out="bf16", out_fl=0)
    got = fused_ir_block(*(None if a is None else a.to(dev) for a in args), **kw)
    torch.cuda.synchronize()
    want = fused_ir_block_plain(*args, **kw)
    assert torch.equal(got.cpu(), want)
    assert got[0, 0, 0, :2].float().tolist() == [2.0**24, -(2.0**24)]


def test_fused_ir_block_raises_on_forms_it_does_not_take(dev):
    rng = np.random.RandomState(6)
    args = [a.to(dev) for a in _ir_rung_args(rng, 1, 8, 8, 24, 48, 24, "int8")]
    base, c = args[:7], args[7]
    with pytest.raises(ValueError, match="carry: int32 or int8"):
        fused_ir_block(*base, c.to(torch.int16))
    with pytest.raises(ValueError, match="carry_add_offset"):
        fused_ir_block(*base, c, carry_add_offset=64)
    with pytest.raises(ValueError, match="carry_add_offset"):
        fused_ir_block(*base, carry_add_offset=128)
    with pytest.raises(ValueError, match="unknown output"):
        fused_ir_block(*base, c, out="fp16")
    with pytest.raises(ValueError, match="alignment"):
        buf = torch.zeros(c.numel() + 8, dtype=torch.int8, device=dev)
        fused_ir_block(*base, buf[8:].view(c.shape))


def test_wrappers_raise_instead_of_falling_back(dev):
    """On CUDA tensors a wrapper launches its kernel or raises: a shape the
    kernel does not take is refused, never handed to the plain version."""
    x = torch.zeros((1, 8, 8, 3), dtype=torch.int8, device=dev)
    w = torch.zeros((3, 3, 3, 64), dtype=torch.int8, device=dev)
    b = torch.zeros(64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="C % 16"):
        conv_int8(x, w, b, padding=1)
    x16 = torch.zeros((1, 8, 8, 16), dtype=torch.int8, device=dev)
    w10 = torch.zeros((3, 3, 16, 10), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="O % 4"):
        conv_int8(x16, w10, torch.zeros(10, dtype=torch.int32, device=dev), padding=1)
    with pytest.raises(ValueError, match="int8"):
        int8_gemm(
            torch.zeros((4, 16), device=dev), torch.zeros((16, 4), dtype=torch.int8, device=dev),
            torch.zeros(4, dtype=torch.int32, device=dev),
        )
    with pytest.raises(ValueError, match="7, 7, 3, 64"):
        stem_pool(x, w, b)
    with pytest.raises(ValueError, match="7, 7, 3, 64"):  # a packed stem weight of the wrong size
        stem_pool(x, torch.zeros((64, 200), dtype=torch.int8, device=dev), b)
    # packed K2 weights that do not fit the call: wrong layout, wrong C
    w16 = pack_conv_weight(torch.zeros((3, 3, 16, 64), dtype=torch.int8, device=dev))
    bad = PackedConvWeight(w16.data[:, :32].contiguous(), 3, 3, 16, 64)
    with pytest.raises(ValueError, match="packed weight data"):
        conv_int8(torch.zeros((1, 8, 8, 16), dtype=torch.int8, device=dev), bad, b, padding=1)
    with pytest.raises(ValueError, match="groups 1"):
        conv_int8(torch.zeros((1, 8, 8, 32), dtype=torch.int8, device=dev), w16, b, padding=1)
    with pytest.raises(ValueError, match="K % 4"):
        int8_gemm(
            torch.zeros((4, 6), dtype=torch.int8, device=dev),
            torch.zeros((6, 4), dtype=torch.int8, device=dev),
            torch.zeros(4, dtype=torch.int32, device=dev),
        )
    with pytest.raises(ValueError, match="alignment"):  # K % 16 == 0 takes 16-byte rows
        buf = torch.zeros(4 * 16 + 4, dtype=torch.int8, device=dev)
        int8_gemm(
            buf[4:].view(4, 16), torch.zeros((16, 4), dtype=torch.int8, device=dev),
            torch.zeros(4, dtype=torch.int32, device=dev),
        )
    # K1 plans and packed weights that do not fit the call
    x8k = torch.zeros((8, 64), dtype=torch.int8, device=dev)
    w8k = torch.zeros((64, 16), dtype=torch.int8, device=dev)
    b16 = torch.zeros(16, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="plan does not fit"):
        int8_gemm(x8k, w8k, b16, plan=gemm_ops.general_plan(8, 64, 16))
    with pytest.raises(ValueError, match="plan does not fit"):
        int8_gemm(x8k, w8k, b16, plan=gemm_ops.skinny_plan(8, 64, 8))
    p16 = gemm_ops.pack_k1_weight(w8k)
    with pytest.raises(ValueError, match="packed weight data"):
        int8_gemm(x8k, p16._replace(data=p16.data[:8].contiguous()), b16)
    x24 = torch.zeros((1, 8, 8, 24), dtype=torch.int8, device=dev)
    b24 = torch.zeros(24, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="plan does not fit"):  # tile columns not a whole run
        dw_int8(x16, torch.zeros((3, 3, 1, 16), dtype=torch.int8, device=dev),
                torch.zeros(16, dtype=torch.int32, device=dev), padding=1,
                plan=dw_ops.DwPlan(2, 6, 16, 256, 1))
    x992 = torch.zeros((1, 4, 16, 992), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="plan does not fit"):  # cb past the loader's division
        dw_int8(x992, torch.zeros((3, 3, 1, 992), dtype=torch.int8, device=dev),
                torch.zeros(992, dtype=torch.int32, device=dev), padding=1,
                plan=dw_ops.DwPlan(1, 16, 992, 19840, 1))
    with pytest.raises(ValueError, match="C % 16"):
        dw_int8(x24, torch.zeros((3, 3, 1, 24), dtype=torch.int8, device=dev), b24, padding=1)
    w16 = torch.zeros((2, 2, 1, 16), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="square odd"):
        dw_int8(x16, w16, torch.zeros(16, dtype=torch.int32, device=dev))
    w1 = torch.zeros((6, 48), dtype=torch.int8, device=dev)
    wd = torch.zeros((3, 3, 48), dtype=torch.int8, device=dev)
    w2 = torch.zeros((48, 24), dtype=torch.int8, device=dev)
    b48 = torch.zeros(48, dtype=torch.int32, device=dev)
    x6 = torch.zeros((1, 8, 8, 6), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="% 4"):
        fused_ir_block(x6, w1, b48, wd, b48, w2, b24)
    with pytest.raises(ValueError, match="mixed devices"):
        w24 = torch.zeros((24, 48), dtype=torch.int8, device=dev)
        fused_ir_block(x24, w24, b48, wd.cpu(), b48, w2, b24)
    # packed K5 and K7 weights that do not fit the call
    with pytest.raises(ValueError, match="w1 must be"):
        fused_ir_block(x24, pack_gemm_weight(w1), b48, wd, b48, w2, b24)
    p24 = pack_gemm_weight(torch.zeros((24, 48), dtype=torch.int8, device=dev))
    bad24 = PackedConvWeight(p24.data[:, :32].contiguous(), 1, 1, 24, 48)
    with pytest.raises(ValueError, match="packed weight data"):
        fused_ir_block(x24, bad24, b48, wd, b48, w2, b24)
    pg = pack_gemm_weight(torch.zeros((64, 8), dtype=torch.int8, device=dev))
    x64 = torch.zeros((4, 64), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="packed weight data"):
        int8_gemm_v2(x64, PackedConvWeight(pg.data[:2].contiguous(), 1, 1, 64, 8), b24[:8])
    with pytest.raises(ValueError, match="1x1 conv"):
        int8_gemm_v2(x64, pack_conv_weight(torch.zeros((2, 2, 16, 8), dtype=torch.int8,
                                                       device=dev)), b24[:8])
    with pytest.raises(ValueError, match="shapes"):
        int8_gemm_v2(torch.zeros((4, 32), dtype=torch.int8, device=dev), pg, b24[:8])
    with pytest.raises(ValueError, match="plan does not fit"):
        int8_gemm_v2(x64, pg, b24[:8], plan=GemmPlan(64, 64, 1, 1, 1, 2, 2))
    x24m = torch.zeros((4, 24), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="K % 16"):
        int8_gemm_v2(x24m, torch.zeros((24, 8), dtype=torch.int8, device=dev), b24[:8])
    with pytest.raises(ValueError, match="K <= 3328"):
        int8_gemm_v2(
            torch.zeros((4, 3344), dtype=torch.int8, device=dev),
            torch.zeros((3344, 8), dtype=torch.int8, device=dev), b24[:8],
        )
    with pytest.raises(ValueError, match="N % 4"):
        int8_gemm_v2(
            torch.zeros((4, 16), dtype=torch.int8, device=dev),
            torch.zeros((16, 10), dtype=torch.int8, device=dev),
            torch.zeros(10, dtype=torch.int32, device=dev),
        )
    xf, geom = pack_flat(x24, 1, 0)
    w3 = torch.zeros((3, 3, 24, 16), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="C % 16"):
        conv_flat_int8(xf, w3, b24[:16], geom=geom)
    xf16, geom16 = pack_flat(x16, 1, 0)
    w33 = torch.zeros((3, 3, 16, 16), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="odd square"):
        conv_flat_int8(xf16, w33, b24[:16], geom=geom16, kernel=(2, 2))
    with pytest.raises(ValueError, match="mask_value"):
        conv_flat_int8(xf16, w33, b24[:16], geom=geom16, epilogue="requant8", mask_value=200)
    # K6 plans and packed weights that do not fit the call: another call's
    # plan, a PackedConvWeight of other channels
    with pytest.raises(ValueError, match="plan does not fit"):
        conv_flat_int8(xf16, w33, b24[:16], geom=geom16,
                       plan=plan_flat(8 * 9 * 9, 512, 512, 3, 9))
    with pytest.raises(ValueError, match="w shape"):
        conv_flat_int8(xf16, pack_conv_weight(torch.zeros((3, 3, 32, 16), dtype=torch.int8,
                                                          device=dev)), b24[:16], geom=geom16)
    p33 = pack_conv_weight(w33)
    with pytest.raises(ValueError, match="packed weight data"):
        conv_flat_int8(xf16, p33._replace(data=p33.data[:4].contiguous()), b24[:16],
                       geom=geom16)
    # a halo of 128 + 2 * 1601 rows of 64 bytes, with the weight ring,
    # exceeds one block's shared memory
    xw, geomw = pack_flat(torch.zeros((1, 1, 1598, 16), dtype=torch.int8, device=dev), 1, 0)
    with pytest.raises(RuntimeError, match="rows of width 1600 at pad 1"):
        conv_flat_int8(xw, w33, b24[:16], geom=geomw)


def test_launch_counters_count_kernel_launches(dev):
    x = torch.zeros((4, 16), dtype=torch.int8, device=dev)
    w = torch.zeros((16, 8), dtype=torch.int8, device=dev)
    b = torch.zeros(8, dtype=torch.int32, device=dev)
    before = int8_gemm.launches
    int8_gemm(x, w, b)
    int8_gemm(x.cpu(), w.cpu(), b.cpu())  # the plain version: no launch
    assert int8_gemm.launches == before + 1


@pytest.mark.parametrize("path", ["resnet18", "mobilenet_v2", "resnet50", "mobilenet_v1"])
def test_engine_kernels_bitwise_equal_plain(dev, path):
    """Each main path at 64 px through the kernels and through the plain
    versions, on the card: launches per forward as chip_smoke.py checks them
    at 224 px, equal logits."""
    import chip_smoke
    from f8net_tpu_torch.engine import IntEngine

    images = torch.from_numpy(np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32))
    model, plan, params, _ = chip_smoke.load_synthetic_model(
        1, 64, 10, dev, images.to(dev), model_name=path
    )
    eng = IntEngine(model, plan, params, device=dev)
    logits, ref, counts, _, _ = chip_smoke.engine_phase(eng, eng.condition_input(images))
    chip_smoke.check_logits(logits, ref, 2, 10)
    assert counts == chip_smoke.expected_launches(path)


@pytest.mark.parametrize("rung", ["int8_boundary", "bf16_boundary"])
@pytest.mark.parametrize("path", ["resnet18", "mobilenet_v2", "resnet50", "mobilenet_v1"])
def test_engine_rungs_bitwise_equal_plain(dev, path, rung):
    """Each main path's relaxed rungs at 64 px through the kernels and
    through the plain versions, on the card: the strict rung's launches per
    forward, equal logits; MobileNetV2's K5 runs its 1-byte-carry (int8
    rung) or bf16 (bf16 rung) form."""
    import chip_smoke
    from f8net_tpu_torch.engine import IntEngine

    images = torch.from_numpy(np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32))
    model, plan, params, _ = chip_smoke.load_synthetic_model(
        2, 64, 10, dev, images.to(dev), model_name=path
    )
    eng = IntEngine(model, plan, params, device=dev, **{rung: True})
    logits, ref, counts, calls, _ = chip_smoke.engine_phase(eng, eng.condition_input(images))
    chip_smoke.check_logits(logits, ref, 2, 10)
    assert counts == chip_smoke.expected_launches(path)
    outs = {kw["out"] for name, _, kw in calls if name == "ir_block"}
    carries = {chip_smoke.k5_carry(a) for name, a, _ in calls if name == "ir_block"}
    if path == "mobilenet_v2":
        assert ("bf16" in outs) == (rung == "bf16_boundary")
        assert ("int8" in carries) == (rung == "int8_boundary")


@pytest.mark.parametrize("name", ["resnet18", "mobilenet_v1"])
def test_qat_train_forward_on_the_card_vs_cpu(dev, name):
    """Each layer of the QAT train-mode forward (32 px, batch 2) on the
    card against the same layer on the CPU, on the CPU forward's input and
    state (the forward amplifies any float32 difference end to end:
    tests/test_torch_qat.py), with the global TF32 switches on, which the
    layers must not follow: fraclens and EMA updates equal, BN statistics
    within 1e-5 relative, outputs within 1e-5 of their largest value but in
    at most 5% of the output channels (a folded weight across a rounding
    boundary), and every switch as the caller left it."""
    from f8net_tpu_torch.models import get_model
    from f8net_tpu_torch.nn import quant_layers as ql
    from f8net_tpu_torch.nn import runner as port_runner
    from f8net_tpu_torch.utils import QuantConfig

    cfg = QuantConfig(format_from_metric=True, metric="std", quant_bias=True,
                      quant_avgpool=True, pool_fusing=True)
    model = get_model(name, cfg, num_classes=10, image_size=32)
    params, state = model.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32))
    calls, conv, linear = [], port_runner.Runner.conv, port_runner.Runner.linear

    def record(method):
        def call(self, lname, act):
            before = {k: dict(v) for k, v in self.state.items()}
            out = method(self, lname, act)
            calls.append((lname, ql.as_act(act).x, before, out.x))
            return out
        return call

    port_runner.Runner.conv, port_runner.Runner.linear = record(conv), record(linear)
    try:
        _, cpu_state = model.apply(params, state, x, mode="train")
    finally:
        port_runner.Runner.conv, port_runner.Runner.linear = conv, linear
    dp = {k: {kk: v.to(dev) for kk, v in d.items()} for k, d in params.items()}
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        for lname, xin, before, want in calls:
            fn = ql.linear_apply if lname == "classifier" else ql.conv_bn_apply
            ds = {k: {kk: v.to(dev) for kk, v in d.items()} for k, d in before.items()}
            y, upd = fn(model.graph, cfg, lname, dp, ds, ql.Act(xin.to(dev)), "train")
            assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
            got = y.x.cpu()
            far = ((got - want).abs() > 1e-5 * want.abs().max()).reshape(-1, got.shape[-1])
            assert int(far.any(0).sum()) <= max(1, 0.05 * got.shape[-1]), lname
            for k, v in upd[lname].items():
                w = cpu_state[lname][k]
                if k == "input_fl_ema":
                    assert torch.equal(v.cpu(), w), lname
                else:
                    torch.testing.assert_close(v.cpu(), w, rtol=1e-5, atol=1e-6)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("o", [128, 192])
def test_stem_pool_kernel_wide(dev, o):
    """K3 at more than 64 output channels (IntEngine(pad_channels_to=128)
    pads ResNet's stem to 128): one 64-channel group per grid row, on
    part-filled tiles and at batch 64, HWIO and packed weights."""
    for n, h, w in ((2, 40, 52), (64, 224, 224)):
        rng = np.random.RandomState(n + o)
        x, wt = _int8(rng, (n, h, w, 3)), _int8(rng, (7, 7, 3, o), -127)
        b = torch.from_numpy(rng.randint(-(1 << 16), 1 << 16, o).astype(np.int32))
        want = stem_pool_plain(x.to(dev), wt.to(dev), b.to(dev), pad_value=-128)
        for wk in (wt.to(dev), pack_stem_weight(wt.to(dev))):
            got = stem_pool(x.to(dev), wk, b.to(dev), pad_value=-128)
            torch.cuda.synchronize()
            assert got.shape == (n, (h + 3) // 4, (w + 3) // 4, o) and torch.equal(got, want)


def test_bf16_training_conv_vs_cpu(dev):
    """The flagged training conv (cfg.train_conv_bf16) at ResNet-18's 3x3
    stage-1 shape (K = 1152), batch 8 at 28x28, on the card against its
    plain version on the CPU: on small-grid operands (every partial sum
    exact in float32) both bitwise the float64 conv; on arbitrary operands
    the card's forward (TF32 tensor cores) within 2^-14 of each output's
    sqrt(sum of squared products) of the float64 conv of the rounded
    operands, and its backward (full float32, TF32 off) within 1e-5
    relative L2 of the CPU's; the caller's TF32 switch as it was."""
    from f8net_tpu_torch.nn import quant_layers as ql
    from f8net_tpu_torch.nn.spec import ConvBNSpec

    spec = ConvBNSpec(name="t", in_ch=128, out_ch=128, kernel=(3, 3), stride=(1, 1),
                      padding=(1, 1))
    conv64 = lambda a, b: torch.nn.functional.conv2d(
        a.permute(0, 3, 1, 2), b.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    rng = np.random.RandomState(11)
    xg = torch.from_numpy(rng.randint(0, 8, (8, 28, 28, 128)).astype(np.float32) / 8)
    wg = torch.from_numpy(rng.randint(-3, 4, (3, 3, 128, 128)).astype(np.float32) / 4)
    for d in ("cpu", dev):
        with ql.float32_exact():
            y = ql.conv2d_bf16(xg.to(d), wg.to(d), spec).cpu()
        assert torch.equal(y.double(), conv64(xg.double(), wg.double())), d
    x = torch.from_numpy(np.abs(rng.standard_normal((8, 28, 28, 128))).astype(np.float32) * 3)
    w = torch.from_numpy(rng.standard_normal((3, 3, 128, 128)).astype(np.float32) * 0.05)
    g = torch.from_numpy(rng.standard_normal((8, 28, 28, 128)).astype(np.float32))
    grads = {}
    for d in ("cpu", dev):
        tx = x.to(d, copy=True).requires_grad_(True)
        tw = w.to(d, copy=True).requires_grad_(True)
        with ql.float32_exact():
            y = ql.conv2d_bf16(tx, tw, spec)
            (y * g.to(d)).sum().backward()
            assert not torch.backends.cudnn.allow_tf32
        grads[d] = (y.detach().cpu(), tx.grad.cpu(), tw.grad.cpu())
    xb, wb = ql.bf16_round(x).double(), ql.bf16_round(w).double()
    err = (grads[dev][0].double() - conv64(xb, wb)).abs() / conv64(xb * xb, wb * wb).sqrt()
    assert float(err.max()) <= 2.0**-14
    for a, b in zip(grads[dev][1:], grads["cpu"][1:]):
        assert float((a - b).norm() / b.norm()) <= 1e-5


def test_padded_mobilenet_v2_forward(dev):
    """One MobileNetV2 forward at 64 px through IntEngine(pad_channels_to=
    64) on the card: every kernel call equal to its plain version, the
    logits bitwise the unpadded engine's, launches as the padded routing's
    table (K7 takes the widened 1x1 GEMMs)."""
    import chip_smoke
    from f8net_tpu_torch.engine import IntEngine

    images = torch.from_numpy(np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32))
    model, plan, params, _ = chip_smoke.load_synthetic_model(
        3, 64, 10, dev, images.to(dev), model_name="mobilenet_v2"
    )
    base = IntEngine(model, plan, params, device=dev)
    eng = IntEngine(model, plan, params, device=dev, pad_channels_to=64)
    x = eng.condition_input(images)
    logits, ref, counts, calls, _ = chip_smoke.engine_phase(eng, x)
    chip_smoke.check_logits(logits, ref, 2, 10)
    for name, args, kw in calls:
        chip_smoke.compare(name, args, kw)
    assert torch.equal(logits, base(x))
    assert {k: v for k, v in counts.items() if v} == eng.launch_table()
