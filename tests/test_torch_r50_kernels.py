"""The CPU paths of K7 (persistent GEMM) and K6 (flat-raster stride-1 conv)
against the Pallas kernels they replace, run in interpret mode on the CPU as
tests/test_pallas_gemm_v2.py and tests/test_pallas_conv_flat.py run them.
Bitwise (tolerance 0), on every row of K6's flat raster, pad ring included,
with the ring masked and not."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from f8net_tpu.ops.pallas_conv_flat import conv_flat_int8 as pallas_conv_flat
from f8net_tpu.ops.pallas_conv_flat import pack_flat as pallas_pack_flat
from f8net_tpu.ops.pallas_conv_flat import unpack_flat as pallas_unpack_flat
from f8net_tpu.ops.pallas_gemm_v2 import int8_gemm_v2 as pallas_int8_gemm_v2
from f8net_tpu_torch.ops import conv_flat_int8, int8_gemm_v2, pack_flat, unpack_flat


def _t(a):
    return torch.from_numpy(np.array(a))


# (M, K, N, epilogue kwargs); K % 16 == 0 and N % 4 == 0, K7's domain
GEMM_CASES = [
    (300, 64, 96, dict(epilogue="int32")),
    (300, 64, 96, dict(epilogue="requant8", net=9, out_signed=True)),
    (1030, 256, 100, dict(epilogue="int32", relu=True)),
    (1030, 256, 100, dict(epilogue="requant8", net=11, out_signed=False, relu=True)),
    (392, 512, 64, dict(epilogue="requant8", net=-2, out_signed=False)),
]


@pytest.mark.parametrize("M,K,N,kw", GEMM_CASES)
def test_int8_gemm_v2_cpu_vs_pallas(M, K, N, kw):
    rng = np.random.RandomState(M + K + N + kw.get("net", 0))
    x = rng.randint(-128, 128, (M, K)).astype(np.int8)
    w = rng.randint(-127, 128, (K, N)).astype(np.int8)
    b = rng.randint(-(1 << 16), 1 << 16, (N,)).astype(np.int32)
    want = pallas_int8_gemm_v2(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw)
    got = int8_gemm_v2(_t(x), _t(w), _t(b), **kw)
    assert got.dtype == (torch.int32 if kw["epilogue"] == "int32" else torch.int8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (n, hw, c, o, k, pad_value, epilogue kwargs, mask_pad, mask_value)
FLAT_CASES = [
    (2, 9, 64, 96, 3, -128, dict(epilogue="int32"), True, 0),
    (2, 9, 64, 96, 3, -128, dict(epilogue="int32"), False, 0),
    (1, 7, 32, 64, 3, 0, dict(epilogue="int32", relu=True), True, 5),
    (2, 11, 64, 128, 5, 0, dict(epilogue="int32"), True, 0),
    (2, 11, 64, 128, 5, -128, dict(epilogue="int32"), False, 0),
    (2, 9, 128, 96, 3, 0, dict(epilogue="requant8", net=3, out_signed=True, relu=True), True, 0),
    (2, 9, 128, 96, 3, -128,
     dict(epilogue="requant8", net=11, out_signed=False, relu=True), True, -128),
    (1, 6, 48, 32, 3, -128, dict(epilogue="requant8", net=12, out_signed=False), False, 0),
    (3, 4, 64, 64, 5, 0, dict(epilogue="requant8", net=10, out_signed=True), False, 0),
]


@pytest.mark.parametrize("n,hw,c,o,k,pad_value,kw,mask_pad,mask_value", FLAT_CASES)
def test_conv_flat_plain_vs_pallas(n, hw, c, o, k, pad_value, kw, mask_pad, mask_value):
    rng = np.random.RandomState(n * hw + c + o + k + mask_pad)
    p = (k - 1) // 2
    x = rng.randint(-128, 128, (n, hw, hw, c)).astype(np.int8)
    w = rng.randint(-127, 128, (k, k, c, o)).astype(np.int8)
    b = rng.randint(-(1 << 12), 1 << 12, (o,)).astype(np.int32)
    xf, geom = pallas_pack_flat(jnp.asarray(x), p, pad_value)
    kw = dict(kw, kernel=(k, k), mask_pad=mask_pad, mask_value=mask_value)
    want = pallas_conv_flat(xf, jnp.asarray(w), jnp.asarray(b), geom=geom, **kw)
    xt, geom_t = pack_flat(_t(x), p, pad_value)
    assert geom_t == geom
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xf))
    got = conv_flat_int8(xt, _t(w), _t(b), geom=geom_t, **kw)
    assert got.dtype == (torch.int32 if kw["epilogue"] == "int32" else torch.int8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # all M rows
    np.testing.assert_array_equal(
        unpack_flat(got, geom_t, p).numpy(), np.asarray(pallas_unpack_flat(want, geom, p))
    )


def test_conv_flat_chain_plain_vs_pallas():
    """conv1 (requant8, ring masked to conv2's packed zero) feeds conv2 on
    the flat raster with nothing between them, as in
    tests/test_pallas_conv_flat.py::test_chained_convs_zero_glue."""
    rng = np.random.RandomState(12)
    n, hw, c, m, o = 2, 12, 64, 128, 96
    x = rng.randint(-128, 128, (n, hw, hw, c)).astype(np.int8)
    w1 = rng.randint(-127, 128, (3, 3, c, m)).astype(np.int8)
    b1 = rng.randint(-(1 << 12), 1 << 12, (m,)).astype(np.int32)
    w2 = rng.randint(-127, 128, (3, 3, m, o)).astype(np.int8)
    b2 = rng.randint(-(1 << 12), 1 << 12, (o,)).astype(np.int32)
    b2 = (b2 + 128 * w2.astype(np.int32).sum((0, 1, 2))).astype(np.int32)
    k1 = dict(epilogue="requant8", net=4, out_signed=False, relu=True, mask_value=-128)
    xf, geom = pallas_pack_flat(jnp.asarray(x), 1, 0)
    y1 = pallas_conv_flat(xf, jnp.asarray(w1), jnp.asarray(b1), geom=geom, **k1)
    want = pallas_conv_flat(y1, jnp.asarray(w2), jnp.asarray(b2), geom=geom, epilogue="int32")
    xt, geom_t = pack_flat(_t(x), 1, 0)
    g1 = conv_flat_int8(xt, _t(w1), _t(b1), geom=geom_t, **k1)
    np.testing.assert_array_equal(g1.numpy(), np.asarray(y1))
    got = conv_flat_int8(g1, _t(w2), _t(b2), geom=geom_t, epilogue="int32")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
