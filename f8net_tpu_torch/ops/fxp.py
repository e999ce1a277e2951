"""Fixed-point primitives of the integer engine (the port of
`f8net_tpu/ops/fxp.py`: `fix_quant` forward at `:52-85`, `shift_requant`
integer form at `:112-155`), and the two conversions of the relaxed
boundary rungs between an int32 accumulator or an 8-bit operand and a bf16
real value (`f8net_tpu/engine/int_engine.py`: `_emit` `:817-821`,
`pack_for`'s scaled branch `:469-479`).

Numerical contract, bit for bit with the JAX package:
  * rounding is round-half-to-even everywhere (torch.round and jnp.round are
    both IEEE roundTiesToEven);
  * the signed clamp is symmetric, -(2^(wl-1)-1)..2^(wl-1)-1 -- never -128;
  * int32 arithmetic wraps as JAX's does.  `x + 2^(net-1)` in the shift
    requant and a left shift can leave the int32 range; JAX wraps them, so
    they are computed here in int64 and wrapped back (`wrap_i32`) instead of
    relying on what a backend does with signed overflow.

`shift_requant_f32` and `requant_f32_eligible` were TPU workarounds for the
cost of integer epilogues on the VPU; the port uses the integer form
everywhere.
"""

from __future__ import annotations

import torch

INT32_MAX = (1 << 31) - 1


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int32 with two's-complement wraparound, as JAX's
    int32 arithmetic wraps."""
    x = x.to(torch.int64)
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def requant_net(x: torch.Tensor, net: int, wl: int = 8, signed: bool = True) -> torch.Tensor:
    """Shift an int32 tensor right by `net` (round-half-to-even) or left by
    -net, then clamp to the wl-bit range.  Returns int32.

    Round-half-to-even on an arithmetic right shift by n:
        res = x + 2^(n-1)                 (wraps in int32)
        ties (x mod 2^n == 2^(n-1)) get   (res >> (n+1)) << 1
        everything else gets              res >> n
    """
    if not -31 < net < 31:
        raise ValueError(f"shift {net} outside the int32 range")
    x = x.to(torch.int64)
    if net > 0:
        half = 1 << (net - 1)
        res = wrap_i32(x + half).to(torch.int64)
        tie = torch.remainder(x, 1 << net) == half
        res = torch.where(tie, (res >> (net + 1)) << 1, res >> net)
    else:
        res = wrap_i32(x << (-net)).to(torch.int64)
    if signed:
        bound = (1 << (wl - 1)) - 1
        res = res.clamp(-bound, bound)
    else:
        res = res.clamp(0, (1 << wl) - 1)
    return res.to(torch.int32)


def shift_requant(
    x: torch.Tensor, wl: int = 8, fl: int = 0, input_fl: int = 0, signed: bool = True
) -> torch.Tensor:
    """Pure-integer requantization of an int32 accumulator at fraclen
    `input_fl` to a wl-bit operand at fraclen `fl`: one shift by
    net = input_fl - fl with round-half-to-even, then the symmetric clamp.
    No multiplies, no floating point."""
    if not (isinstance(fl, int) and isinstance(input_fl, int)):
        raise TypeError("fraclens are static Python ints")
    if not 0 <= fl <= (wl - 1 if signed else wl):
        raise ValueError(f"fraclen {fl} outside the {wl}-bit format")
    return requant_net(x, input_fl - fl, wl, signed)


def _broadcast_fl(fl, x: torch.Tensor, axis: int) -> torch.Tensor:
    fl = torch.as_tensor(fl, dtype=torch.float32, device=x.device)
    if fl.ndim == 0:
        return fl
    return fl.reshape(fl.shape + (1,) * (x.ndim - axis - 1))


def fix_quant(x: torch.Tensor, wl: int = 8, fl=0, axis: int = 0, signed: bool = True):
    """Simulated fixed-point quantization (forward only).

    Scales by 2^fl, rounds half-to-even, clamps to the symmetric signed range
    or the unsigned range [0, 2^wl-1], and scales back.  Returns
    (quantized, mask); mask is True where the value was not clipped (and,
    unsigned, strictly positive)."""
    scale = torch.exp2(_broadcast_fl(fl, x, axis))
    res = torch.round(x * scale)
    if signed:
        bound = float(2 ** (wl - 1) - 1)
        mask = res.abs() < bound
        res = res.clamp(-bound, bound)
    else:
        bound = float(2**wl - 1)
        mask = (res > 0) & (res < bound)
        res = res.clamp(0.0, bound)
    return res / scale, mask


def to_real_bf16(y: torch.Tensor, fl: int) -> torch.Tensor:
    """int32 accumulator at fraclen `fl` -> its real value in bfloat16:
    int32 -> float32 (round to nearest even), times 2^-fl (exact), then
    float32 -> bfloat16 (round to nearest even).  Rounding twice is the
    contract (the reference's astype(float32) ... astype(bfloat16)): for
    |y| >= 2^24 it can differ from one rounding straight to bfloat16, as at
    y = 2^24 + 2^16 + 1."""
    return (y.to(torch.float32) * float(2.0**-fl)).to(torch.bfloat16)


def pack_real(x: torch.Tensor, fl: int, signed: bool) -> torch.Tensor:
    """A bf16 real value -> the packed 8-bit operand of a conv whose input
    grid has fraclen `fl`: float32, times 2^fl, round half to even, clamp to
    -127..127 (signed) or 0..255 then store u - 128 (unsigned; the clamp
    absorbs a ReLU), int8."""
    v = torch.round(x.to(torch.float32) * float(2.0**fl))
    if signed:
        return v.clamp(-127, 127).to(torch.int8)
    return (v.clamp(0, 255) - 128).to(torch.int8)
