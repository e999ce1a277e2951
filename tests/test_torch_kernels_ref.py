"""The plain PyTorch versions of the port's kernels K1-K3 against the Pallas
kernels they replace, run in interpret mode on the CPU as
tests/test_pallas_{gemm,conv,stem}.py run them.  Bitwise (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from f8net_tpu.ops.pallas_conv import pallas_conv_int8
from f8net_tpu.ops.pallas_gemm import int8_gemm as pallas_int8_gemm
from f8net_tpu.ops.pallas_stem import build_stem_inputs_v2, stem_pool_int8_v2
from f8net_tpu_torch.ops import conv_int8, int8_gemm, stem_pool
from f8net_tpu_torch.ops.stem import stem_out_hw


def _t(a):
    return torch.from_numpy(np.array(a))


# (epilogue, net, out_signed, relu)
GEMM_CASES = [
    ("int32", 0, True, False),
    ("int32", 0, True, True),
    ("requant8", 7, True, False),
    ("requant8", 5, False, False),
    ("requant8", 0, False, True),
    ("requant8", -2, True, False),
]


@pytest.mark.parametrize("epilogue,net,out_signed,relu", GEMM_CASES)
def test_int8_gemm_plain_vs_pallas(epilogue, net, out_signed, relu):
    rng = np.random.RandomState(abs(net) * 4 + out_signed * 2 + relu)
    M, K, N = 24, 96, 40
    x = rng.randint(-128, 128, (M, K)).astype(np.int8)
    w = rng.randint(-127, 128, (K, N)).astype(np.int8)
    b = rng.randint(-(1 << 16), 1 << 16, (N,)).astype(np.int32)
    want = pallas_int8_gemm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), epilogue=epilogue, net=net,
        out_signed=out_signed, relu=relu,
    )
    got = int8_gemm(_t(x), _t(w), _t(b), epilogue=epilogue, net=net, out_signed=out_signed,
                    relu=relu)
    assert got.dtype == (torch.int32 if epilogue == "int32" else torch.int8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (h, c, o, k, stride, padding, pad_value, epilogue, net, out_signed, relu)
CONV_CASES = [
    (9, 32, 64, 3, 1, 1, 0, "int32", 0, True, False),
    (9, 32, 64, 3, 2, 1, -128, "int32", 0, True, False),
    (7, 32, 48, 3, 2, 1, -128, "requant8", 6, False, False),  # ragged stride-2 edge
    (8, 16, 32, 1, 2, 0, -128, "int32", 0, True, False),  # 1x1/s2 shortcut
    (8, 32, 32, 3, 1, 1, -128, "requant8", 5, False, False),
    (8, 32, 32, 3, 1, 1, 0, "requant8", 4, True, True),
    (6, 16, 32, 3, 1, 1, 0, "requant8", -1, True, False),
    (8, 16, 32, 3, 1, 1, -128, "int32", 0, True, True),
]


@pytest.mark.parametrize(
    "h,c,o,k,stride,padding,pad_value,epilogue,net,out_signed,relu", CONV_CASES
)
def test_conv_int8_plain_vs_pallas(h, c, o, k, stride, padding, pad_value, epilogue, net,
                                   out_signed, relu):
    rng = np.random.RandomState(h * 100 + c + o + k * 7 + stride + abs(net))
    x = rng.randint(-128, 128, (2, h, h, c)).astype(np.int8)
    w = rng.randint(-20, 21, (k, k, c, o)).astype(np.int8)
    b = rng.randint(-(1 << 14), 1 << 14, (o,)).astype(np.int32)
    kw = dict(stride=stride, padding=padding, pad_value=pad_value, epilogue=epilogue,
              net=net, out_signed=out_signed, relu=relu)
    want = pallas_conv_int8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), boh=4, **kw)
    got = conv_int8(_t(x), _t(w), _t(b), **kw)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size,unsigned", [(32, True), (32, False), (64, True), (64, False)])
def test_stem_pool_plain_vs_pallas_v2(size, unsigned):
    rng = np.random.RandomState(size + unsigned)
    zp = 128 if unsigned else 0
    lo = -128 if unsigned else -127
    v8 = rng.randint(lo, 128, (2, size, size, 3)).astype(np.int8)
    w = rng.randint(-20, 21, (7, 7, 3, 64)).astype(np.int8)
    b = rng.randint(-(1 << 14), 1 << 14, (64,)).astype(np.int32)
    be, bo, w256, comp = build_stem_inputs_v2(
        jnp.asarray(v8), jnp.asarray(w), conv_h=size // 2, zero_point=zp
    )
    want = stem_pool_int8_v2(
        be, bo, w256, jnp.asarray(b) + comp, conv_h=size // 2, valid_w=size // 4
    )
    b_zp = b.astype(np.int64) + zp * w.astype(np.int64).sum((0, 1, 2))
    got = stem_pool(_t(v8), _t(w), _t(b_zp.astype(np.int32)), pad_value=-zp)
    assert got.shape == (2, *stem_out_hw(size, size)[2:], 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
