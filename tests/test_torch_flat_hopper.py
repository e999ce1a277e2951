"""K6's Hopper design on the CPU: its planner (`ops.conv_flat.plan_flat`)
and its packed weights, which the plain version reads through the kernel's
chunk offsets.

Bitwise (tolerance 0) on every row of the flat raster, pad ring included:
`conv_flat_int8` on K2's packed weights against the HWIO call and against
the Pallas kernel it replaces, run in interpret mode on the CPU as
tests/test_pallas_conv_flat.py runs it, at k = 3 and 5 and C = 16, 48 and 80
(a 64-channel slice that reaches into the next tap's packed weights), ring
masked and not, int32 and requant8, biases that wrap, M not a multiple of
the 128-row tile; and the plain version on packed weights against the one
on HWIO weights, with every plan the planner can give in the kernel's
domain."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from f8net_tpu.ops.pallas_conv_flat import conv_flat_int8 as pallas_conv_flat
from f8net_tpu.ops.pallas_conv_flat import pack_flat as pallas_pack_flat
from f8net_tpu_torch.ops import conv_flat as flat_ops
from f8net_tpu_torch.ops import conv_flat_int8, pack_conv_weight, pack_flat

IMAX = (1 << 31) - 1


def _t(a):
    return torch.from_numpy(np.array(a))


# (M raster rows, C, O, k, w2) of ResNet's stride-1 3x3 convs on the flat
# raster at 224 px, batch 1, 8 and 64, and of the small shapes below
PLAN_CALLS = [
    (b * (hw + 2) ** 2, c, c, 3, hw + 2)
    for b in (1, 8, 64) for hw, c in ((56, 64), (28, 128), (14, 256), (7, 512))
] + [(50, 16, 20, 3, 5), (81, 48, 64, 3, 9), (200, 80, 68, 5, 10), (1200, 320, 64, 3, 20)]


@pytest.mark.parametrize("m,c,o,k,w2", PLAN_CALLS)
def test_plan_flat_covers_the_call(m, c, o, k, w2):
    """Every output row and column in one tile, every channel slice in one
    split (block z of s runs slices [z * S / s, (z + 1) * S / s), as the
    kernel computes them), within one block's shared memory, at 1, 16, 132
    (an H100) and 1024 SMs; every candidate plan in the kernel's domain."""
    o_pad, slices = -(-o // 64) * 64, -(-c // flat_ops.SLICE)
    for sms in (1, 16, 132, 1024):
        plan = flat_ops.plan_flat(m, c, o, k, w2, sms)
        assert flat_ops.plan_fits(plan, c, o, k, w2)
        mtiles, ntiles = plan.blocks(m, o) // (o_pad // plan.bn * plan.splits), o_pad // plan.bn
        assert (mtiles - 1) * flat_ops.BM < m <= mtiles * flat_ops.BM
        assert ntiles * plan.bn == o_pad >= o
        ranges = [(z * slices // plan.splits, (z + 1) * slices // plan.splits)
                  for z in range(plan.splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == slices
        assert all(lo < hi for lo, hi in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert flat_ops.flat_smem(k, w2, plan.bn, plan.splits) <= flat_ops.SMEM_LIMIT
    cands = flat_ops.flat_candidates(c, o, k, w2)
    assert flat_ops.plan_flat(m, c, o, k, w2) in cands
    assert all(flat_ops.plan_fits(p, c, o, k, w2) for p in cands)
    for bad in (flat_ops.FlatPlan(64, 2 * slices), flat_ops.FlatPlan(96, 1)):
        assert not flat_ops.plan_fits(bad, c, o, k, w2)


def test_plan_flat_refuses_a_raster_too_wide_for_one_block():
    """A halo of 128 + 2 * 1601 rows of 64 bytes and the weight ring exceed
    one block's shared memory; 1500-wide rows still fit, and so do ResNet's
    widest 5x5 rasters."""
    with pytest.raises(RuntimeError, match="rows of width 1600 at pad 1"):
        flat_ops.plan_flat(1600, 16, 16, 3, 1600)
    plan = flat_ops.plan_flat(1500, 16, 16, 3, 1500)
    assert flat_ops.flat_smem(3, 1500, plan.bn, plan.splits) <= flat_ops.SMEM_LIMIT
    plan = flat_ops.plan_flat(8 * 228 * 228, 64, 64, 5, 228)
    assert flat_ops.flat_smem(5, 228, plan.bn, plan.splits) <= flat_ops.SMEM_LIMIT


def test_conv_flat_check_refuses_what_the_kernel_does_not_take():
    """What the wrapper checks before a launch, on CPU tensors: another
    call's plan, packed weights of other channels or of a cut layout, a
    channel count off the 16-byte chunks; the call's own plan passes."""
    xf, geom = pack_flat(torch.zeros((1, 8, 8, 16), dtype=torch.int8), 1, 0)
    w = torch.zeros((3, 3, 16, 16), dtype=torch.int8)
    b = torch.zeros(16, dtype=torch.int32)
    wp, plan = flat_ops.conv_flat_int8_check(xf, w, b, geom=geom)
    assert plan == flat_ops.plan_flat(100, 16, 16, 3, 10) and wp.shape == w.shape
    with pytest.raises(ValueError, match="plan does not fit"):
        flat_ops.conv_flat_int8_check(xf, wp, b, geom=geom,
                                      plan=flat_ops.plan_flat(8 * 9 * 9, 512, 512, 3, 9))
    with pytest.raises(ValueError, match="w shape"):
        flat_ops.conv_flat_int8_check(
            xf, pack_conv_weight(torch.zeros((3, 3, 32, 16), dtype=torch.int8)), b, geom=geom)
    with pytest.raises(ValueError, match="packed weight data"):
        flat_ops.conv_flat_int8_check(xf, wp._replace(data=wp.data[:4].contiguous()), b,
                                      geom=geom)
    x24, g24 = pack_flat(torch.zeros((1, 8, 8, 24), dtype=torch.int8), 1, 0)
    with pytest.raises(ValueError, match="C % 16"):
        flat_ops.conv_flat_int8_check(x24, torch.zeros((3, 3, 24, 16), dtype=torch.int8), b,
                                      geom=g24)


def _bias(rng, o, wrap):
    b = rng.randint(-(1 << 12), 1 << 12, (o,))
    if wrap:  # acc + bias leaves the int32 range for some outputs
        b[::2] = IMAX - rng.randint(0, 1 << 12, b[::2].shape)
        b[1::2] = -IMAX + rng.randint(0, 1 << 12, b[1::2].shape)
    return b.astype(np.int32)


# (n, hw, c, o, k, pad_value, epilogue kwargs, mask_pad, mask_value); M =
# n * (hw + 2p)^2 is never a multiple of 128, int32 biases wrap
FLAT_CASES = [
    (2, 5, 16, 20, 3, -128, dict(epilogue="int32"), True, 0),
    (1, 7, 48, 64, 3, 0, dict(epilogue="requant8", net=9, out_signed=False, relu=True), True,
     -128),
    (2, 7, 80, 68, 3, -128, dict(epilogue="int32", relu=True), False, 0),
    (1, 6, 16, 32, 5, 0, dict(epilogue="requant8", net=11, out_signed=True), False, 0),
    (2, 5, 48, 20, 5, -128, dict(epilogue="int32"), True, 3),
    (1, 7, 80, 64, 5, 0, dict(epilogue="requant8", net=10, out_signed=False), True, -128),
]


def _case(n, hw, c, o, k, pad_value, kw, mask_pad, mask_value):
    rng = np.random.RandomState(n * hw + c + o + k + mask_pad)
    p = (k - 1) // 2
    x = rng.randint(-128, 128, (n, hw, hw, c)).astype(np.int8)
    w = rng.randint(-127, 128, (k, k, c, o)).astype(np.int8)
    b = _bias(rng, o, wrap=kw["epilogue"] == "int32")
    xt, geom = pack_flat(_t(x), p, pad_value)
    assert xt.shape[0] % flat_ops.BM != 0
    kw = dict(kw, geom=geom, kernel=(k, k), mask_pad=mask_pad, mask_value=mask_value)
    return x, w, b, xt, kw


@pytest.mark.parametrize("n,hw,c,o,k,pad_value,kw,mask_pad,mask_value", FLAT_CASES)
def test_conv_flat_packed_vs_hwio_vs_pallas(n, hw, c, o, k, pad_value, kw, mask_pad, mask_value):
    x, w, b, xt, fkw = _case(n, hw, c, o, k, pad_value, kw, mask_pad, mask_value)
    p = (k - 1) // 2
    xf, geom = pallas_pack_flat(jnp.asarray(x), p, pad_value)
    pkw = {key: v for key, v in fkw.items() if key != "geom"}
    want = np.asarray(pallas_conv_flat(xf, jnp.asarray(w), jnp.asarray(b), geom=geom, **pkw))
    got_hwio = conv_flat_int8(xt, _t(w), _t(b), **fkw)
    got_packed = conv_flat_int8(xt, pack_conv_weight(_t(w)), _t(b), **fkw)
    np.testing.assert_array_equal(got_hwio.numpy(), want)  # all M rows
    assert torch.equal(got_packed, got_hwio)


@pytest.mark.parametrize("case", FLAT_CASES + [
    (1, 5, 320, 64, 3, -128, dict(epilogue="int32"), True, 0),  # 5 slices: uneven splits
])
def test_packed_plain_under_every_plan(case):
    """The plain version on packed weights -- each slice's taps through the
    kernel's chunk offsets, reaching into the next tap where C % 64 != 0 --
    equals the one on HWIO weights; the CPU call takes every plan
    flat_candidates lists and plan_flat gives at 1-1024 SMs, and refuses one
    of more splits than the call has slices."""
    _, w, b, xt, kw = _case(*case)
    m, c = xt.shape
    k, o, w2 = w.shape[0], w.shape[3], kw["geom"][2]
    want = flat_ops.conv_flat_int8_plain(xt, _t(w), _t(b), **kw)
    wp = pack_conv_weight(_t(w))
    assert torch.equal(flat_ops.conv_flat_int8_plain(xt, wp, _t(b), **kw), want)
    plans = set(flat_ops.flat_candidates(c, o, k, w2))
    plans |= {flat_ops.plan_flat(m, c, o, k, w2, sms) for sms in (1, 16, 132, 1024)}
    assert max(p.splits for p in plans) == 1 << (min(8, -(-c // 64)).bit_length() - 1)
    for plan in plans:
        assert torch.equal(conv_flat_int8(xt, wp, _t(b), plan=plan, **kw), want), plan
    with pytest.raises(ValueError, match="plan does not fit"):
        conv_flat_int8(xt, wp, _t(b), plan=flat_ops.FlatPlan(64, 2 * -(-c // 64)), **kw)
