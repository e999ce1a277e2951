"""The port's integer shift requant against `f8net_tpu.ops.fxp`, bitwise,
on random, tie and near-INT32_MAX inputs (where `x + 2^(net-1)` wraps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from f8net_tpu.ops import fix_quant as jax_fix_quant
from f8net_tpu.ops import shift_requant as jax_shift_requant
from f8net_tpu_torch.ops.fxp import fix_quant, shift_requant, wrap_i32

IMAX = (1 << 31) - 1


def test_torch_shift_and_remainder_semantics():
    """The identities the requant relies on: >> on signed ints is
    arithmetic, and remainder by a positive divisor is non-negative (as
    jnp.mod), for int32 and int64."""
    for dt in (torch.int32, torch.int64):
        x = torch.tensor([-7, -8, -1, 0, 5, -(1 << 30)], dtype=dt)
        assert (x >> 2).tolist() == [v >> 2 for v in x.tolist()]
        r = torch.remainder(x, 8)
        assert r.tolist() == [v % 8 for v in x.tolist()]
        assert bool((r >= 0).all())
    np.testing.assert_array_equal(
        np.asarray(jnp.mod(jnp.asarray([-7, -8, -1], jnp.int32), 8)), [1, 0, 7]
    )


def test_wrap_i32_matches_int32_overflow():
    v = np.array([IMAX, IMAX - 3, -IMAX - 1, 5], np.int64)
    add = np.array([1, 7, -1, -9], np.int64)
    want = np.asarray(jnp.asarray(v, jnp.int32) + jnp.asarray(add, jnp.int32))
    np.testing.assert_array_equal(wrap_i32(torch.from_numpy(v + add)).numpy(), want)


def _inputs(net, rng):
    rand = rng.randint(-(1 << 24), 1 << 24, 4096)
    pieces = [rand]
    if net > 0:
        k = rng.randint(-(1 << 20), 1 << 20, 1024)
        tie = (k << net) + (1 << (net - 1))  # exact ties and their neighbours
        pieces += [tie - 1, tie, tie + 1]
    top = np.arange(IMAX - 4096, IMAX + 1, dtype=np.int64)  # x + half wraps here
    bot = np.arange(-IMAX - 1, -IMAX - 1 + 4096, dtype=np.int64)
    pieces += [top, bot]
    return np.concatenate(pieces).astype(np.int32)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("net", [-3, 0, 1, 6, 17, 30])
def test_shift_requant_bitwise(net, signed):
    rng = np.random.RandomState(net + 40 + signed)
    x = _inputs(net, rng)
    fl = 4 if net < 0 else 0
    input_fl = fl + net
    want = np.asarray(jax_shift_requant(jnp.asarray(x), 8, fl, input_fl, signed))
    got = shift_requant(torch.from_numpy(x), 8, fl, input_fl, signed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("signed", [True, False])
def test_fix_quant_forward_bitwise(signed):
    rng = np.random.RandomState(3 + signed)
    x = rng.standard_normal((2, 5, 5, 3)).astype(np.float32) * 3
    x[0, 0, 0] = [0.5 / 64, 1.5 / 64, -2.5 / 64]  # ties at fl 6
    for fl in (0, 6, 8 - signed):
        q, m = fix_quant(torch.from_numpy(x), 8, float(fl), 3, signed)
        wq, wm = jax_fix_quant(jnp.asarray(x), 8, float(fl), 3, signed)
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(m.numpy(), np.asarray(wm))
