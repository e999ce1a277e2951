"""Fixed-point primitives (the port of `f8net_tpu/ops/fxp.py`: `fix_quant`
at `:52-85`, `ste_quant` at `:88-110`, `shift_requant` integer form at
`:112-155`, `metric2fraclen` at `:248`, `fraclen_gridsearch` at `:265` and
`metric_fn` at `:281`), and the two conversions of the relaxed boundary
rungs between an int32 accumulator or an 8-bit operand and a bf16
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

`metric_fn` and `fraclen_gridsearch` take a process group: with one, the
statistic spans the global batch that the group's processes hold in
shards, as the JAX package's jitted step over Mesh('data') computes it
(sums in float64, all-reduced; the variance in two passes, about the
global mean).
"""

from __future__ import annotations

import math

import torch

from ..parallel.dist import all_reduce_sum

INT32_MAX = (1 << 31) - 1
# Coefficient tables of F8Net's semi-empirical sigma -> fraclen rule (copy of
# f8net_tpu/ops/fxp.py:34-35): the optimal fraclen of a (rectified) Gaussian
# tensor is about log2(coeff / metric)
SIGNED_COEFF = {"std": 40.0, "mae": 30.0, "rms": 40.0}
UNSIGNED_COEFF = {"std": 70.0, "mae": 30.0, "rms": 50.0}


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


def fix_quant(x: torch.Tensor, wl: int = 8, fl=0, axis: int = 0, signed: bool = True,
              floating: bool = False):
    """Simulated fixed-point quantization (forward only).

    Scales by 2^fl, rounds half-to-even (skipped when `floating`: the
    clip-only baseline), clamps to the symmetric signed range or the
    unsigned range [0, 2^wl-1], and scales back.  Returns (quantized, mask);
    mask is True where the value was not clipped (and, unsigned, strictly
    positive): where the straight-through gradient passes."""
    scale = torch.exp2(_broadcast_fl(fl, x, axis))
    res = x * scale
    if not floating:
        res = torch.round(res)
    if signed:
        bound = float(2 ** (wl - 1) - 1)
        mask = res.abs() < bound
        res = res.clamp(-bound, bound)
    else:
        bound = float(2**wl - 1)
        mask = (res > 0) & (res < bound)
        res = res.clamp(0.0, bound)
    return res / scale, mask


class _SteQuant(torch.autograd.Function):
    """fix_quant forward; backward the cotangent times the clip mask, no
    gradient to the fraclen (f8net_tpu/ops/fxp.py:_ste_bwd)."""

    @staticmethod
    def forward(ctx, x, fl, wl, axis, signed, floating):
        res, mask = fix_quant(x, wl, fl, axis, signed, floating)
        ctx.save_for_backward(mask)
        return res

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return g * mask.to(g.dtype), None, None, None, None, None


def ste_quant(x: torch.Tensor, fl, wl: int = 8, axis: int = 0, signed: bool = True,
              floating: bool = False) -> torch.Tensor:
    """fix_quant with a straight-through-estimator gradient: it flows only
    through elements that were not clipped (and, unsigned, were > 0)."""
    return _SteQuant.apply(x, fl, wl, axis, signed, floating)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Square root rounded to nearest in x's float32, as IEEE (and XLA's)
    sqrt is: taken in float64 and rounded once to float32, which is exact
    rounding for float32 inputs.  torch's vectorized CPU sqrt is not
    correctly rounded (off by one ulp at about 0.7% of random inputs), and
    a BN scale or a std one ulp off moves a folded weight across a
    rounding boundary."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def metric2fraclen(metric, metric_name: str = "std", n: float = 1.0,
                   signed: bool = True) -> torch.Tensor:
    """F8Net's statistics -> fraclen rule: floor(log2(coeff * n / metric)),
    clipped to [0, 8 - signed]; coeff from SIGNED_COEFF / UNSIGNED_COEFF.
    The quotient is float32, as the reference's; its log2 is taken in
    float64, so the floor is exact: float32 log2s (torch's and XLA's alike)
    can round a quotient one ulp below a power of two up to it, or one
    above down to it."""
    coeff = (SIGNED_COEFF if signed else UNSIGNED_COEFF)[metric_name]
    q = coeff * n / metric
    fl = torch.floor(torch.log2(q.to(torch.float64))).to(q.dtype)
    return fl.clamp(0.0, float(8 - int(signed)))


def fraclen_gridsearch(x: torch.Tensor, wl: int = 8, axis: int = 0,
                       signed: bool = True, group=None) -> torch.Tensor:
    """The first fraclen in [0, wl - signed] with the least RMS error of
    quantizing x, as a float32 scalar; with a process group, the error of
    the global tensor whose shards the processes hold (each candidate's
    squared-error sum all-reduced)."""
    if group is not None:
        with torch.no_grad():
            sums = [torch.sum((x - fix_quant(x, wl, float(fl), axis, signed)[0]) ** 2,
                              dtype=torch.float64)
                    for fl in range(wl + 1 - int(signed))]
            tot = all_reduce_sum(torch.stack(sums + [sums[0].new_tensor(float(x.numel()))]),
                                 group)
            errs = sqrt_rn((tot[:-1] / tot[-1]).to(x.dtype))
        return torch.argmin(errs).to(torch.float32)
    errs = [
        sqrt_rn(torch.mean((x - fix_quant(x, wl, float(fl), axis, signed)[0]) ** 2))
        for fl in range(wl + 1 - int(signed))
    ]
    return torch.argmin(torch.stack(errs)).to(torch.float32)


def metric_fn(name: str, axes, group=None):
    """The statistic metric2fraclen reads, reduced over `axes`; std is the
    sample standard deviation (ddof 1), as torch.std and the reference's.
    With a process group, the statistic of the global tensor whose shards
    (along the batch axis) the processes hold."""
    axes = tuple(axes)
    if group is not None:
        if name not in ("std", "mae", "rms"):
            raise NotImplementedError(f"metric {name!r}")
        return lambda x: _global_metric(name, x, axes, group)
    if name == "std":
        return lambda x: sqrt_rn(torch.var(x, dim=axes, correction=1))
    if name == "mae":
        return lambda x: torch.mean(torch.abs(x), dim=axes)
    if name == "rms":
        return lambda x: sqrt_rn(torch.mean(x**2, dim=axes))
    raise NotImplementedError(f"metric {name!r}")


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



def _global_mean(v: torch.Tensor, axes, group):
    """(mean over `axes`, kept as size-1 dims, and the element count) of
    the global tensor whose shards the group's processes hold; float64,
    differentiable: the sum and the count all-reduced together."""
    s = torch.sum(v, axes, keepdim=True, dtype=torch.float64)
    n = float(math.prod(v.shape[a] for a in axes))
    tot = all_reduce_sum(torch.cat([s.reshape(-1), s.new_tensor([n])]), group)
    return (tot[:-1] / tot[-1]).reshape(s.shape), tot[-1]


def global_moments(x: torch.Tensor, axes, group, ddof: int = 0):
    """(mean, variance, count) over `axes` of the global tensor whose shards
    the group's processes hold, in float64 and differentiable: the mean
    first, then the squared deviations about it all-reduced (two passes:
    the one-pass E[x^2] - E[x]^2 cancels).  The count is a float64 tensor;
    the variance divides by count - ddof."""
    axes = tuple(axes)
    mean, count = _global_mean(x, axes, group)
    sq = torch.sum((x.to(torch.float64) - mean) ** 2, axes)
    var = all_reduce_sum(sq, group) / (count - ddof)
    return mean.reshape(sq.shape), var, count


def _global_metric(name: str, x: torch.Tensor, axes, group) -> torch.Tensor:
    with torch.no_grad():
        x = x.detach()
        if name == "std":
            return sqrt_rn(global_moments(x, axes, group, ddof=1)[1].to(x.dtype))
        v = torch.abs(x) if name == "mae" else x.to(torch.float64) ** 2
        m = _global_mean(v, axes, group)[0].squeeze(axes).to(x.dtype)
        return m if name == "mae" else sqrt_rn(m)
