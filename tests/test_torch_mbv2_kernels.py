"""The plain PyTorch versions of K4 (depthwise), K5 (fused inverted
residual) and K1 at a reduction K that is not a multiple of 16, against the
Pallas kernels they replace, run in interpret mode on the CPU as
tests/test_pallas_{dw,ir,gemm}.py run them.  Bitwise (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from f8net_tpu.ops.pallas_dw import pallas_depthwise_int8
from f8net_tpu.ops.pallas_gemm import int8_gemm as pallas_int8_gemm
from f8net_tpu.ops.pallas_ir_block import fused_ir_block as pallas_fused_ir_block
from f8net_tpu_torch.ops import dw_int8, fused_ir_block, int8_gemm

IMAX = (1 << 31) - 1


def _t(a):
    return torch.from_numpy(np.array(a))


# (h, stride, pad_value, epilogue, net, out_signed, relu)
DW_CASES = [
    (9, 1, -128, "int32", 0, True, False),
    (9, 2, -128, "int32", 0, True, False),
    (8, 1, 0, "requant8", 6, True, False),
    (7, 2, 0, "requant8", 5, False, False),
    (8, 2, -128, "requant8", 7, False, True),
    (9, 1, 0, "int32", 0, True, True),
]


@pytest.mark.parametrize("h,stride,pad_value,epilogue,net,out_signed,relu", DW_CASES)
def test_dw_int8_plain_vs_pallas(h, stride, pad_value, epilogue, net, out_signed, relu):
    rng = np.random.RandomState(h * 10 + stride + net)
    c = 32
    x = rng.randint(-128, 128, (2, h, h, c)).astype(np.int8)
    w = rng.randint(-127, 128, (3, 3, 1, c)).astype(np.int8)
    b = rng.randint(-(1 << 12), 1 << 12, (c,)).astype(np.int32)
    kw = dict(stride=stride, padding=1, pad_value=pad_value, epilogue=epilogue, net=net,
              out_signed=out_signed, relu=relu)
    want = pallas_depthwise_int8(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), boh=4, interpret=True, **kw
    )
    got = dw_int8(_t(x), _t(w), _t(b), **kw)
    assert got.dtype == (torch.int32 if epilogue == "int32" else torch.int8)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (carry, out, net_out, out_signed, dw_in_signed, proj_in_signed, shift_res,
#  shift_carry, wrap)
IR_CASES = [
    (False, "int32", 0, False, False, False, 0, 0, False),
    (False, "requant8", 9, True, True, False, 0, 0, False),
    (True, "int32", 0, False, False, False, 2, 0, False),
    (True, "int32", 0, False, True, True, 0, 3, True),
    (True, "requant8", 11, False, False, False, 1, 2, True),
]


@pytest.mark.parametrize(
    "carry,out,net_out,out_signed,dw_in_signed,proj_in_signed,shift_res,shift_carry,wrap",
    IR_CASES,
)
def test_fused_ir_block_plain_vs_pallas(
    carry, out, net_out, out_signed, dw_in_signed, proj_in_signed, shift_res, shift_carry, wrap
):
    rng = np.random.RandomState(net_out + 4 * shift_res + shift_carry + 16 * wrap)
    n, h, w, cin, ce, cout = 2, 4, 4, 24, 48, 24
    x = rng.randint(-128, 128, (n, h, w, cin)).astype(np.int8)
    w1 = rng.randint(-40, 41, (cin, ce)).astype(np.int8)
    wd = rng.randint(-127, 128, (3, 3, ce)).astype(np.int8)
    w2 = rng.randint(-40, 41, (ce, cout)).astype(np.int8)
    b1 = rng.randint(-(1 << 14), 1 << 14, (ce,)).astype(np.int32)
    bd = rng.randint(-(1 << 14), 1 << 14, (ce,)).astype(np.int32)
    b2 = rng.randint(-(1 << 14), 1 << 14, (cout,)).astype(np.int32)
    c = None
    if carry:
        c = rng.randint(-(1 << 20), 1 << 20, (n, h, w, cout)).astype(np.int32)
    if wrap:  # the shifted bias and carry leave the int32 range: the add wraps
        b2[::2] = IMAX - rng.randint(0, 1 << 10, b2[::2].shape)
        b2[1::2] = -IMAX + rng.randint(0, 1 << 10, b2[1::2].shape)
        c[..., ::3] = IMAX - 7
    kw = dict(net1=8, dw_in_signed=dw_in_signed, net2=12, proj_in_signed=proj_in_signed,
              out=out, net_out=net_out, out_signed=out_signed, shift_res=shift_res,
              shift_carry=shift_carry)
    args = (x, w1, b1, wd, bd, w2, b2)
    want = pallas_fused_ir_block(
        *(jnp.asarray(a) for a in args), None if c is None else jnp.asarray(c),
        h=h, w=w, bn_tile=2, interpret=True, **kw,
    )
    got = fused_ir_block(*(_t(a) for a in args), None if c is None else _t(c), **kw)
    assert got.dtype == (torch.int32 if out == "int32" else torch.int8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("epilogue,net,out_signed", [("int32", 0, True), ("requant8", 6, False)])
def test_int8_gemm_k24_plain_vs_pallas(epilogue, net, out_signed):
    rng = np.random.RandomState(24 + net)
    M, K, N = 50, 24, 144
    x = rng.randint(-128, 128, (M, K)).astype(np.int8)
    w = rng.randint(-127, 128, (K, N)).astype(np.int8)
    b = rng.randint(-(1 << 16), 1 << 16, (N,)).astype(np.int32)
    want = pallas_int8_gemm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), epilogue=epilogue, net=net,
        out_signed=out_signed,
    )
    got = int8_gemm(_t(x), _t(w), _t(b), epilogue=epilogue, net=net, out_signed=out_signed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
