"""K5's forms for the boundary rungs -- the bf16 real-value output and the
packed 1-byte carry widened by `carry_add_offset` -- through its plain
PyTorch versions, against the Pallas `fused_ir_block` run in interpret mode
on the CPU as tests/test_pallas_ir.py runs it; and the two conversions of
the rungs (`ops.fxp.to_real_bf16`, `pack_real`) against the JAX engine's
arithmetic (`_emit`, `pack_for`'s scaled branch).  Bitwise (tolerance 0),
including at 2^24 + 2^16 + 1, where rounding int32 -> float32 -> bf16 (the
contract) and rounding once straight to bf16 part, and at residuals near
INT32_MAX, where the shifted carry add wraps before the clip."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from f8net_tpu.ops.pallas_ir_block import fused_ir_block as pallas_fused_ir_block
from f8net_tpu_torch.ops import fused_ir_block, pack_real, to_real_bf16
from f8net_tpu_torch.ops.gemm_v2 import pack_gemm_weight
from f8net_tpu_torch.ops.ir_block import _layout, fused_ir_block_split_plain

IMAX = (1 << 31) - 1
DOUBLE_ROUNDING = 16842753  # 2^24 + 2^16 + 1: float32 2^24 + 2^16, then bf16 2^24


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp_np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _block(seed, n=2, h=4, w=4, cin=24, ce=48, cout=24, carry=None, wrap=False, zero_w2_cols=0):
    """Random K5 operands; `carry` None, "int32" or "int8"; `wrap` puts the
    biases and carries near +-INT32_MAX; the first `zero_w2_cols` output
    channels get zero project weights, so that y there is b2 alone."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-128, 128, (n, h, w, cin)).astype(np.int8)
    w1 = rng.randint(-40, 41, (cin, ce)).astype(np.int8)
    wd = rng.randint(-127, 128, (3, 3, ce)).astype(np.int8)
    w2 = rng.randint(-40, 41, (ce, cout)).astype(np.int8)
    w2[:, :zero_w2_cols] = 0
    b1 = rng.randint(-(1 << 14), 1 << 14, (ce,)).astype(np.int32)
    bd = rng.randint(-(1 << 14), 1 << 14, (ce,)).astype(np.int32)
    b2 = rng.randint(-(1 << 14), 1 << 14, (cout,)).astype(np.int32)
    c = None
    if carry == "int32":
        c = rng.randint(-(1 << 20), 1 << 20, (n, h, w, cout)).astype(np.int32)
    elif carry == "int8":
        c = rng.randint(-128, 128, (n, h, w, cout)).astype(np.int8)
    if wrap:  # the shifted bias and carry leave the int32 range: the add wraps
        b2[::2] = IMAX - rng.randint(0, 1 << 10, b2[::2].shape)
        b2[1::2] = -IMAX + rng.randint(0, 1 << 10, b2[1::2].shape)
        if carry == "int32":
            c[..., ::3] = IMAX - 7
        elif carry == "int8":
            c[..., ::3] = 127
    return (x, w1, b1, wd, bd, w2, b2), c


def _pallas(args, c, **kw):
    h, w = args[0].shape[1:3]
    y = pallas_fused_ir_block(
        *(jnp.asarray(a) for a in args), None if c is None else jnp.asarray(c),
        h=h, w=w, bn_tile=2, interpret=True, **kw,
    )
    return _jnp_np(y)


JUNCTION = dict(net1=8, dw_in_signed=False, net2=12, proj_in_signed=False)

# (carry, carry_add_offset, out, net_out, out_signed, out_fl, shift_res, shift_carry, wrap)
CASES = [
    # bf16 output: no carry, an int32 carry, a 1-byte carry
    (None, 0, "bf16", 0, False, 14, 0, 0, False),
    (None, 0, "bf16", 0, False, 0, 0, 0, False),
    ("int32", 0, "bf16", 0, False, 13, 1, 0, False),
    ("int8", 128, "bf16", 0, False, 9, 0, 5, False),
    # 1-byte carry, offsets 0 and 128, int32 and requant8 outputs
    ("int8", 0, "int32", 0, False, 0, 0, 9, False),
    ("int8", 128, "int32", 0, False, 0, 2, 0, False),
    ("int8", 0, "requant8", 10, True, 0, 0, 7, False),
    ("int8", 128, "requant8", 11, False, 0, 1, 4, False),
    # near INT32_MAX: (y << shift_res) + ((c + offset) << shift_carry) wraps
    # in int32 before the clip
    ("int8", 128, "int32", 0, False, 0, 1, 23, True),
    ("int8", 128, "requant8", 20, False, 0, 0, 24, True),
    ("int8", 0, "bf16", 0, False, 3, 1, 24, True),
    ("int32", 0, "bf16", 0, False, 0, 0, 1, True),
]


@pytest.mark.parametrize(
    "carry,offset,out,net_out,out_signed,out_fl,shift_res,shift_carry,wrap", CASES
)
def test_fused_ir_block_forms_plain_vs_pallas(
    carry, offset, out, net_out, out_signed, out_fl, shift_res, shift_carry, wrap
):
    seed = 7 * CASES.index(
        (carry, offset, out, net_out, out_signed, out_fl, shift_res, shift_carry, wrap)
    )
    args, c = _block(seed, carry=carry, wrap=wrap)
    kw = dict(JUNCTION, out=out, net_out=net_out, out_signed=out_signed, out_fl=out_fl,
              shift_res=shift_res, shift_carry=shift_carry, carry_add_offset=offset)
    want = _pallas(args, c, **kw)
    got = fused_ir_block(*(_t(a) for a in args), None if c is None else _t(c), **kw)
    assert got.dtype == {"int32": torch.int32, "requant8": torch.int8,
                         "bf16": torch.bfloat16}[out]
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("carry", [None, "int8"])
def test_bf16_output_rounds_twice(carry):
    """y = +-(2^24 + 2^16 + 1) in the output channels whose project weights
    are zero: the bf16 output is +-2^24 (float32 first, then bf16), where a
    single rounding would give +-(2^24 + 2^17); the Pallas kernel agrees."""
    args, c = _block(3, carry=carry, zero_w2_cols=4)
    b2 = args[6]
    b2[:4] = [DOUBLE_ROUNDING, -DOUBLE_ROUNDING, DOUBLE_ROUNDING, -DOUBLE_ROUNDING]
    if c is not None:
        c[..., :4] = 0
    kw = dict(JUNCTION, out="bf16", out_fl=0, carry_add_offset=0)
    got = _np(fused_ir_block(*(_t(a) for a in args), None if c is None else _t(c), **kw))
    np.testing.assert_array_equal(got[..., :4], np.broadcast_to(
        np.array([1, -1, 1, -1], np.float32) * 2.0**24, got[..., :4].shape))
    np.testing.assert_array_equal(got, _pallas(args, c, **kw))


@pytest.mark.parametrize("out,offset", [("bf16", 128), ("requant8", 128), ("int32", 0)])
def test_split_plain_with_byte_carry_equals_unsplit(out, offset):
    """The plan's arithmetic (bands with halos, Ce split 2 ways, partials
    summed with int32 wraparound), plain, on the new forms: equal to the
    unsplit plain version, which equals the Pallas kernel."""
    args, c = _block(11, h=8, w=4, ce=64, carry="int8", wrap=True)
    x, w1, b1, wd, bd, w2, b2 = (_t(a) for a in args)
    plan = _layout(8, 4, 24, 64, 24, 3, 3, 2, 32, carry_bytes=1)
    assert plan.splits == 2 and plan.bands == 3
    kw = dict(JUNCTION, out=out, net_out=16, out_fl=15, shift_res=1, shift_carry=22,
              carry_add_offset=offset)
    want = fused_ir_block(x, w1, b1, wd, bd, w2, b2, _t(c), **kw)
    got = fused_ir_block_split_plain(
        x, pack_gemm_weight(w1), b1, wd, bd, pack_gemm_weight(w2), b2, _t(c), plan, **kw
    )
    assert torch.equal(got, want)
    np.testing.assert_array_equal(_np(want), _pallas(args, c, **kw))


def test_to_real_bf16_matches_emit():
    """`_emit`'s bf16 boundary: (y.astype(float32) * 2^-fl).astype(bfloat16)."""
    rng = np.random.RandomState(0)
    y = rng.randint(-IMAX, IMAX, 20000, dtype=np.int64).astype(np.int32)
    y[:6] = [DOUBLE_ROUNDING, -DOUBLE_ROUNDING, IMAX, -IMAX, 0, (1 << 24) + 1]
    for fl in (0, 7, 14, 21):
        want = _jnp_np((jnp.asarray(y).astype(jnp.float32) * float(2.0**-fl)).astype(jnp.bfloat16))
        got = to_real_bf16(_t(y), fl)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got), want)
    assert to_real_bf16(_t(np.int32([DOUBLE_ROUNDING])), 0).item() == 2.0**24


@pytest.mark.parametrize("signed", [True, False])
def test_pack_real_matches_pack_for(signed):
    """`pack_for`'s scaled branch: round(x.astype(float32) * 2^fl), clip to
    +-127 or to 0..255 then - 128, int8 -- on bf16 values around the grid's
    range, ties included."""
    rng = np.random.RandomState(1 + signed)
    v = (rng.standard_normal(20000) * 3).astype(np.float32)
    v[:4] = [0.5, 1.5, -2.5, 300.0]
    xb = jnp.asarray(v).astype(jnp.bfloat16)
    for fl in (0, 4, 7):
        r = jnp.round(xb.astype(jnp.float32) * float(2.0**fl))
        if signed:
            want = jnp.clip(r, -127, 127).astype(jnp.int8)
        else:
            want = (jnp.clip(r, 0, 255) - 128).astype(jnp.int8)
        got = pack_real(torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16),
                        fl, signed)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_refuses_what_k5_does_not_take_on_cpu_too():
    """Forms the wrapper checks before it picks a device."""
    args, c = _block(5, carry="int8")
    ts = [_t(a) for a in args]
    with pytest.raises(ValueError, match="unknown output"):
        fused_ir_block(*ts, out="fp16")
