"""K2: NHWC int8 KxK convolution as an implicit GEMM with the fused
bias + requant epilogue -- the port of
`f8net_tpu/ops/pallas_conv.py:pallas_conv_int8` (`:212-344`), as the CUDA
kernel `csrc/int8_conv.cu` (wgmma on Hopper; see its header for what bounds
it on an H100 and what its design does about that).

    y = epilogue(conv2d(x, w; stride, padding filled with pad_value) + bias)

x: int8 NHWC, packed (pad_value is the packed zero: -128 for an unsigned
input, 0 for a signed one).  w: int8 HWIO, groups 1, or the same weights
packed once by `pack_conv_weight` into the kernel's layout (what
`IntEngine` passes).  bias: int32 at the accumulator scale, holding any
zero-point compensation.  Epilogues as `ops.gemm` ('int32' or 'requant8'
with the consumer's `net` and `out_signed`).

`plan_conv` chooses the kernel's tile width and its split of the reduction
(split-K where the output tiles cannot fill the card's SMs); the kernel
takes the plan from the wrapper.

`conv_int8` launches the kernel for CUDA tensors and raises on what it does
not take; for CPU tensors it runs `conv_int8_plain`, which computes from the
packed layout when given packed weights.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .fxp import wrap_i32
from .gemm import EPILOGUES, epilogue_plain

BM = 128  # output rows per block (csrc/int8_conv.cu kConvBM)
BK = 64  # reduction bytes per pipeline step (kConvBK)
N_ALIGN = 64  # packed output channels are padded to a multiple of this
SPLIT_MIN_STEPS = 2  # a split-K block runs at least this many steps
MAX_SPLITS = 8  # the splits of a tile form one cluster: at most 8 blocks (portable)
H100_SMS = 132


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


class PackedConvWeight(NamedTuple):
    """HWIO weights in K2's operand layout: `data` is (K_pad / 16, O_pad,
    16) int8, data[q, n, b] = w_flat[16 q + b, n], where w_flat is the HWIO
    tensor as a (kh*kw*C, O) matrix, zero-padded to K_pad (a multiple of
    BK) rows and O_pad (a multiple of N_ALIGN) columns.  Each 16-byte
    k-chunk of every output channel is contiguous, so a block copies a
    (step, channel tile) stage as runs of 16-byte chunks straight into the
    shared-memory image wgmma reads (csrc/wgmma_s8.cuh)."""

    data: torch.Tensor
    kh: int
    kw: int
    c: int
    o: int

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        """The logical HWIO shape."""
        return (self.kh, self.kw, self.c, self.o)

    @property
    def device(self) -> torch.device:
        return self.data.device


def pack_conv_weight(w: torch.Tensor) -> PackedConvWeight:
    """HWIO int8 weights -> PackedConvWeight, on w's device."""
    kh, kw, c, o = w.shape
    k = kh * kw * c
    kp, op = _round_up(k, BK), _round_up(o, N_ALIGN)
    m = torch.zeros((kp, op), dtype=torch.int8, device=w.device)
    m[:k, :o] = w.reshape(k, o)
    data = m.reshape(kp // 16, 16, op).permute(0, 2, 1).contiguous()
    return PackedConvWeight(data, kh, kw, c, o)


def unpack_conv_weight(p: PackedConvWeight) -> torch.Tensor:
    """The HWIO weights a PackedConvWeight holds."""
    kp16, op, _ = p.data.shape
    m = p.data.permute(0, 2, 1).reshape(kp16 * 16, op)
    return m[: p.kh * p.kw * p.c, : p.o].reshape(p.kh, p.kw, p.c, p.o).contiguous()


class ConvPlan(NamedTuple):
    """K2's launch plan: tile width `bn`, padded output channels `o_pad`,
    reduction steps `ksteps` (BK bytes each), output tiles `mtiles` x
    `ntiles` of BM x bn, and `splits` blocks per tile over the reduction."""

    bn: int
    o_pad: int
    ksteps: int
    mtiles: int
    ntiles: int
    splits: int

    @property
    def blocks(self) -> int:
        return self.mtiles * self.ntiles * self.splits


@functools.lru_cache(maxsize=None)
def plan_conv(m: int, k: int, o: int, sms: int = H100_SMS) -> ConvPlan:
    """Plan a K2 call of M = n*oh*ow output rows, reduction K = kh*kw*C and
    O output channels on a card with `sms` SMs.

    Where tiles of 128 x 64 give at least half as many tiles as SMs, the
    reduction is not split; tiles are 128 x 128 if that still gives a tile
    per SM.  Otherwise (small M) tiles are 128 x 128 where the padded
    channel count allows, and the reduction splits into the power of two
    >= sms / tiles, at most MAX_SPLITS (one cluster of blocks per tile), if
    every part keeps SPLIT_MIN_STEPS steps; failing that, 128 x 64 tiles
    and no split.  (Measured on an H100: powers of two beat cluster sizes
    of 3, 5 or 6, and 128-wide tiles beat 64-wide ones once split.)"""
    o_pad = _round_up(o, N_ALIGN)
    ksteps = -(-k // BK)
    mtiles = -(-m // BM)
    wide = o_pad % 128 == 0
    if 2 * mtiles * (o_pad // 64) >= sms:
        bn = 128 if wide and mtiles * (o_pad // 128) >= sms else 64
        return ConvPlan(bn, o_pad, ksteps, mtiles, o_pad // bn, 1)
    bn = 128 if wide else 64
    tiles = mtiles * (o_pad // bn)
    splits = min(1 << (-(-sms // tiles) - 1).bit_length(), MAX_SPLITS)
    if ksteps // splits < SPLIT_MIN_STEPS:
        return ConvPlan(64, o_pad, ksteps, mtiles, o_pad // 64, 1)
    return ConvPlan(bn, o_pad, ksteps, mtiles, o_pad // bn, splits)


def split_ranges(plan):
    """[(first step, end step)] of each split of a K2 or K7 plan: split s
    runs steps [s * ksteps // splits, (s + 1) * ksteps // splits), as the
    kernels compute them from the block's split index."""
    n, s = plan.ksteps, plan.splits
    return [(i * n // s, (i + 1) * n // s) for i in range(s)]


def _out_hw(h, w, kh, kw, stride, padding):
    return (h + 2 * padding - kh) // stride + 1, (w + 2 * padding - kw) // stride + 1


def conv_acc_packed(
    x: torch.Tensor, wp: PackedConvWeight, *, stride: int = 1, padding: int = 0,
    pad_value: int = 0, k_range=None,
) -> torch.Tensor:
    """The implicit GEMM from the packed layout, plain: every output pixel's
    taps gathered in the kernel's reduction order (tap-major, channel-minor,
    zero past K), times the packed weights.  Returns the exact int64
    accumulators (n, oh, ow, O) -- over reduction bytes [lo, hi) only when
    `k_range` = (lo, hi) is given.  The product runs in float64, exact for
    |acc| < 2^53."""
    n, h, w, c = x.shape
    oh, ow = _out_hw(h, w, wp.kh, wp.kw, stride, padding)
    xp = F.pad(x.to(torch.float64), (0, 0, padding, padding, padding, padding),
               value=float(pad_value))
    taps = [
        xp[:, ky: ky + stride * (oh - 1) + 1: stride, kx: kx + stride * (ow - 1) + 1: stride]
        for ky in range(wp.kh) for kx in range(wp.kw)
    ]
    a = torch.cat(taps, dim=3).reshape(n * oh * ow, -1)
    kp16, op, _ = wp.data.shape
    a = F.pad(a, (0, kp16 * 16 - a.shape[1]))
    b = wp.data.permute(0, 2, 1).reshape(kp16 * 16, op).to(torch.float64)
    if k_range is not None:
        lo, hi = k_range
        a, b = a[:, lo:hi], b[lo:hi]
    acc = torch.matmul(a, b)[:, : wp.o]
    return acc.to(torch.int64).reshape(n, oh, ow, wp.o)


def conv_int8_plain(
    x: torch.Tensor, w, bias: torch.Tensor, *, stride: int = 1,
    padding: int = 0, pad_value: int = 0, epilogue: str = "int32", net: int = 0,
    out_signed: bool = True, relu: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of K2.  HWIO weights: a float64 conv2d.  Packed
    weights: the implicit GEMM from the packed layout (conv_acc_packed).
    Both exact: |acc| <= kh*kw*C * 128 * 127, far below 2^53 (float64
    products are never TF32)."""
    if isinstance(w, PackedConvWeight):
        acc = conv_acc_packed(x, w, stride=stride, padding=padding, pad_value=pad_value)
        return epilogue_plain(acc, bias, epilogue, net, out_signed, relu).contiguous()
    xd = F.pad(
        x.permute(0, 3, 1, 2).to(torch.float64),
        (padding, padding, padding, padding), value=float(pad_value),
    )
    y = F.conv2d(xd, w.permute(3, 2, 0, 1).to(torch.float64), stride=stride)
    acc = y.permute(0, 2, 3, 1).to(torch.int64)
    return epilogue_plain(acc, bias, epilogue, net, out_signed, relu).contiguous()


def conv_int8_split_plain(
    x: torch.Tensor, wp: PackedConvWeight, bias: torch.Tensor, plan: ConvPlan, *,
    stride: int = 1, padding: int = 0, pad_value: int = 0, epilogue: str = "int32",
    net: int = 0, out_signed: bool = True, relu: bool = False,
) -> torch.Tensor:
    """K2's split-K arithmetic, plain: one int32 partial accumulator per
    split over the plan's reduction steps, the partials added with int32
    wraparound, then the epilogue once on the whole sum."""
    acc = None
    for lo, hi in split_ranges(plan):
        part = wrap_i32(conv_acc_packed(
            x, wp, stride=stride, padding=padding, pad_value=pad_value,
            k_range=(lo * BK, hi * BK),
        ))
        acc = part if acc is None else wrap_i32(acc.to(torch.int64) + part.to(torch.int64))
    return epilogue_plain(acc.to(torch.int64), bias, epilogue, net, out_signed, relu).contiguous()


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 20 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def conv_int8_check(
    x: torch.Tensor, w, bias: torch.Tensor, *, stride: int = 1, padding: int = 0,
    pad_value: int = 0, epilogue: str = "int32", net: int = 0, out_signed: bool = True,
    relu: bool = False, sms: int = H100_SMS,
):
    """What conv_int8 checks before it launches the kernel -- dtypes,
    shapes, the kernel's domain, its plan on a card of `sms` SMs, layout
    and alignment -- on tensors of any device; raises ValueError where the
    kernel does not take the call.  Returns (packed weight, plan)."""
    req = _build.require
    req(x.dtype == torch.int8, "conv_int8: x must be int8")
    req(bias.dtype == torch.int32, "conv_int8: bias must be int32")
    if isinstance(w, torch.Tensor):
        req(w.dtype == torch.int8 and w.ndim == 4, "conv_int8: w must be HWIO int8")
        w = pack_conv_weight(w)
    req(isinstance(w, PackedConvWeight), "conv_int8: w must be HWIO or a PackedConvWeight")
    req(x.ndim == 4 and w.c == x.shape[3], "conv_int8: shapes (groups 1)")
    n, h, wd, c = x.shape
    kh, kw, o = w.kh, w.kw, w.o
    req(bias.shape == (o,), "conv_int8: bias shape")
    req(c % 16 == 0, f"conv_int8: needs C % 16 == 0, got {c}")
    req(o % 4 == 0, f"conv_int8: needs O % 4 == 0, got {o}")
    req(stride in (1, 2) and padding >= 0, f"conv_int8: stride {stride}, padding {padding}")
    req(-128 <= pad_value <= 127, "conv_int8: pad_value is an int8")
    req(epilogue in EPILOGUES, f"conv_int8: unknown epilogue {epilogue!r}")
    req(-31 < net < 31, f"conv_int8: shift {net} out of range")
    oh, ow = _out_hw(h, wd, kh, kw, stride, padding)
    req(oh > 0 and ow > 0, "conv_int8: empty output")
    plan = plan_conv(n * oh * ow, kh * kw * c, o, sms)
    wdata = w.data
    req(
        wdata.dtype == torch.int8 and tuple(wdata.shape) == (plan.ksteps * BK // 16, plan.o_pad, 16),
        f"conv_int8: packed weight data {tuple(wdata.shape)} {wdata.dtype} does not match "
        f"kh={kh} kw={kw} C={c} O={o}",
    )
    req(x.is_contiguous() and wdata.is_contiguous() and bias.is_contiguous(),
        "conv_int8: contiguity")
    req(x.data_ptr() % 16 == 0 and wdata.data_ptr() % 16 == 0, "conv_int8: alignment")
    return w, plan


def conv_int8(
    x: torch.Tensor, w, bias: torch.Tensor, *, stride: int = 1,
    padding: int = 0, pad_value: int = 0, epilogue: str = "int32", net: int = 0,
    out_signed: bool = True, relu: bool = False,
) -> torch.Tensor:
    """K2 on the tensors' device: the CUDA kernel on a card, the plain
    version on the CPU.  `w` is HWIO (packed here, on every call) or a
    PackedConvWeight (packed once by the caller)."""
    kw_ = dict(
        stride=stride, padding=padding, pad_value=pad_value, epilogue=epilogue,
        net=net, out_signed=out_signed, relu=relu,
    )
    if x.device.type == "cpu":
        return conv_int8_plain(x, w, bias, **kw_)
    req = _build.require
    req(x.device.type == "cuda", f"conv_int8: no kernel for device {x.device}")
    req(w.device == x.device and bias.device == x.device, "conv_int8: mixed devices")
    w, plan = conv_int8_check(x, w, bias, **kw_, sms=_sm_count(x.device))
    wdata = w.data
    n, h, wd, c = x.shape
    kh, kw, o = w.kh, w.kw, w.o
    oh, ow = _out_hw(h, wd, kh, kw, stride, padding)
    out = torch.empty(
        (n, oh, ow, o), dtype=torch.int32 if epilogue == "int32" else torch.int8,
        device=x.device,
    )
    lib, fn = _build.kernel("int8_conv", "f8_int8_conv", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), wdata.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, h, wd, c, oh, ow, o, kh, kw, stride, padding, pad_value,
            EPILOGUES[epilogue], net, int(out_signed), int(relu),
            plan.bn, plan.o_pad, plan.ksteps, plan.splits, _build.stream_of(x),
        )
    _build.check(lib, rc, "conv_int8")
    conv_int8.launches += 1
    return out


conv_int8.launches = 0
