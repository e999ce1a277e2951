"""K6: stride-1 odd kxk int8 convolution on the flat padded raster, with
the fused bias + ReLU + requant epilogue and the pad-ring mask -- the port
of `f8net_tpu/ops/pallas_conv_flat.py:conv_flat_int8` (`:130-241`) and its
`pack_flat` / `unpack_flat` (`:249-267`), as the CUDA kernel
`csrc/conv_flat.cu` (wgmma on Hopper over one staged halo per 64-channel
slice; see its header for what bounds it on an H100 and what its design
does about that).

x is a flat (M, C) int8 matrix whose rows are the spatially padded raster,
M = n * h2 * w2, `geom` = (n, h2, w2), with the layer's packed zero in the
pad ring (`pack_flat`).  Output row m is

    epilogue(sum over taps (dy, dx) of x[m + (dy - p) * w2 + (dx - p)] @ w[dy, dx] + bias)

where rows outside [0, M) read 0, p = (k - 1) // 2.  With `mask_pad`, rows
on the pad ring are set to `mask_value` (the consumer's packed zero for a
requant8 chain, 0 for int32); without it they keep what their windows
compute, across image boundaries.  Every one of the M rows is part of the
result.  Epilogues as `ops.gemm`.

w: int8 HWIO (packed on every call) or the same weights packed once by
`ops.conv.pack_conv_weight` -- K2's operand image, whose reduction order
(tap-major, channel-minor) is K6's.  `plan_flat` chooses the kernel's tile
width and its split of the channel slices across a cluster (split-K where
the output tiles cannot fill the card's SMs); the wrapper takes `plan=` to
force another.

The JAX engine never calls K6, and neither does the port's: it is the op it
is in f8net_tpu.  `conv_flat_int8` launches the kernel for CUDA tensors and
raises on what it does not take; for CPU tensors it runs
`conv_flat_int8_plain`, which on packed weights reads them through the
kernel's chunk offsets.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build
from .conv import (
    H100_SMS, MAX_SPLITS, N_ALIGN, PackedConvWeight, _round_up, _sm_count, pack_conv_weight,
)
from .gemm import EPILOGUES, epilogue_plain

BM = 128  # output rows per tile (csrc/conv_flat.cu kFlatBM)
SLICE = 64  # channel bytes per staged halo: one reduction step of every tap
STAGES = 6  # the B ring's depth (kFlatStages)
STAGED_ROW = 64 * 4 + 32  # an epilogue row staged in shared memory (kFlatLd)
SMEM_LIMIT = 232448  # one block's dynamic shared memory (csrc/mma_tile.cuh kMaxSmem)
SPLIT_MIN_SLICES = 2  # a split-K block runs at least this many channel slices


def pack_flat(x: torch.Tensor, p: int, pad_value: int):
    """NHWC int8 -> (flat padded (M, C) raster, geometry (n, h2, w2))."""
    n, h, w, c = x.shape
    xp = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), value=pad_value).permute(0, 2, 3, 1)
    h2, w2 = h + 2 * p, w + 2 * p
    return xp.reshape(n * h2 * w2, c).contiguous(), (n, h2, w2)


def unpack_flat(y: torch.Tensor, geom, p: int) -> torch.Tensor:
    """Flat padded (M, O) -> NHWC with the pad ring sliced off."""
    n, h2, w2 = geom
    y = y.reshape(n, h2, w2, -1)
    return y[:, p:h2 - p, p:w2 - p, :].contiguous() if p else y


# -- the plan ---------------------------------------------------------------------


def halo_rows(k: int, w2: int) -> int:
    """Rows of one staged halo: a tile's BM rows and H = p * w2 + p on each side."""
    p = (k - 1) // 2
    return BM + 2 * (p * w2 + p)


def flat_smem(k: int, w2: int, bn: int, splits: int) -> int:
    """Dynamic shared memory of a K6 block on rows of width w2 with a k x k
    kernel (csrc/conv_flat.cu flat_smem): the halo of halo_rows x 64 bytes
    (rounded up to 128) and the STAGES-deep ring of bn x 64-byte weight
    stages -- or, where larger, the epilogue's staged rows (8 warps x 16
    rows) or the split-K partial tile (BM rows of bn int32 + 32 bytes),
    which reuse that memory -- then bn biases, BM ring flags and 2 x STAGES
    mbarriers."""
    halo = _round_up(halo_rows(k, w2) * 64, 128)
    park = BM * (bn * 4 + 32) if splits > 1 else 8 * 16 * STAGED_ROW
    body = max(halo + STAGES * bn * 64, park)
    return body + bn * 4 + BM + 2 * STAGES * 8


class FlatPlan(NamedTuple):
    """K6's launch plan: output tiles of BM x `bn` and `splits` blocks per
    tile over the channel slices (a cluster).  The rest follows from the
    call: O padded to N_ALIGN, ceil(C / SLICE) slices, ceil(M / BM) x
    o_pad / bn tiles, flat_smem bytes."""

    bn: int
    splits: int

    def blocks(self, m: int, o: int) -> int:
        return -(-m // BM) * (_round_up(o, N_ALIGN) // self.bn) * self.splits


def plan_fits(plan: FlatPlan, c: int, o: int, k: int, w2: int) -> bool:
    """Whether the kernel takes `plan` at a call of C input and O output
    channels, a k x k kernel on rows of width w2 (csrc/conv_flat.cu's
    checks)."""
    return (
        plan.bn in (64, 128) and _round_up(o, N_ALIGN) % plan.bn == 0
        and 1 <= plan.splits <= min(MAX_SPLITS, -(-c // SLICE))
        and flat_smem(k, w2, plan.bn, plan.splits) <= SMEM_LIMIT
    )


def flat_candidates(c: int, o: int, k: int, w2: int):
    """Every plan the kernel takes at this call that a planner could weigh:
    both tile widths (128 where the padded O allows), unsplit and split 2,
    4 and 8 ways (at most one split per slice)."""
    plans = (FlatPlan(bn, s) for bn in (64, 128) for s in (1, 2, 4, 8))
    return [plan for plan in plans if plan_fits(plan, c, o, k, w2)]


@functools.lru_cache(maxsize=None)
def plan_flat(m: int, c: int, o: int, k: int, w2: int, sms: int = H100_SMS) -> FlatPlan:
    """Plan a K6 call of M raster rows, C input and O output channels, a k x
    k kernel on rows of width w2, on a card with `sms` SMs.

    Where tiles of 128 x 64 give at least half as many tiles as SMs, the
    slices are not split (K2's rule); tiles are 128 x 128 if that still
    gives a tile per SM.  Otherwise the slices split in two, four or eight
    while each split keeps SPLIT_MIN_SLICES slices and the 128 x 64 tiles
    times the splits stay under one per SM; then tiles are 128 x 128 where
    the padded channel count allows and they still give half as many
    blocks as SMs, else 128 x 64.  (Measured on an H100 by
    probe_plans.py at ResNet's 14x14 and 7x7 stages, batch 8: 2 splits of
    128 x 64 tiles at 14x14 and 4 of 128 x 128 at 7x7 beat K2's rule of the
    power of two >= sms / tiles, 4 and 8 splits, by 30-50%: each block of a
    cluster pays the partial tile's exchange, and a block of one slice has
    too little to hide its copies behind.)  Raises RuntimeError where the
    halo does not fit one block's shared memory."""
    o_pad = _round_up(o, N_ALIGN)
    ksteps = -(-c // SLICE)
    mtiles = -(-m // BM)
    wide = o_pad % 128 == 0
    tiles64 = mtiles * (o_pad // 64)
    splits = 1
    if 2 * tiles64 >= sms:
        bn = 128 if wide and mtiles * (o_pad // 128) >= sms else 64
    else:
        while (2 * splits <= min(MAX_SPLITS, ksteps // SPLIT_MIN_SLICES)
               and tiles64 * splits < sms):
            splits *= 2
        bn = 128 if wide and 2 * mtiles * (o_pad // 128) * splits >= sms else 64
    smem = flat_smem(k, w2, bn, splits)
    if smem > SMEM_LIMIT:
        p = (k - 1) // 2
        raise RuntimeError(
            f"conv_flat_int8 on rows of width {w2} at pad {p}: a halo of "
            f"{halo_rows(k, w2)} rows needs {smem} bytes of shared memory, more than "
            f"one block has ({SMEM_LIMIT})"
        )
    return FlatPlan(bn, splits)


# -- the plain version ------------------------------------------------------------


def _check_geometry(x, w, bias, geom, kernel, epilogue, mask_value):
    req = _build.require
    n, h2, w2 = geom
    kh, kw = kernel
    p = (kh - 1) // 2
    req((kh, kw) == (2 * p + 1, 2 * p + 1), f"conv_flat_int8: odd square kernels, got {kernel}")
    req(x.ndim == 2 and x.shape[0] == n * h2 * w2, f"conv_flat_int8: x rows are not {geom}")
    req(len(w.shape) == 4 and tuple(w.shape[:3]) == (kh, kw, x.shape[1]),
        "conv_flat_int8: w shape")
    req(tuple(bias.shape) == (w.shape[3],), "conv_flat_int8: bias shape")
    req(h2 >= kh and w2 >= kw, "conv_flat_int8: raster smaller than the kernel")
    req(epilogue in EPILOGUES, f"conv_flat_int8: unknown epilogue {epilogue!r}")
    lo, hi = (-128, 127) if epilogue == "requant8" else (-(1 << 31), (1 << 31) - 1)
    req(lo <= mask_value <= hi, f"conv_flat_int8: mask_value {mask_value} out of range")
    return p


def _finish(acc, bias, geom, p, epilogue, net, out_signed, relu, mask_pad, mask_value):
    """The epilogue on the int64 accumulators, then the ring mask."""
    y = epilogue_plain(acc, bias, epilogue, net, out_signed, relu)
    if mask_pad:
        n, h2, w2 = geom
        m = torch.arange(acc.shape[0], device=acc.device)
        col, row = m % w2, (m // w2) % h2
        ring = (col < p) | (col >= w2 - p) | (row < p) | (row >= h2 - p)
        y = y.masked_fill(ring[:, None], mask_value)
    return y


def conv_flat_int8_plain(
    x: torch.Tensor, w, bias: torch.Tensor, *, geom, kernel=(3, 3),
    epilogue: str = "int32", net: int = 0, out_signed: bool = True, relu: bool = False,
    mask_pad: bool = True, mask_value: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of K6, every row.  HWIO weights: the k*k
    row-shifted products.  Packed weights: read through the kernel's chunk
    offsets -- for each 64-channel slice s and tap t, the slice of the
    raster (rows outside [0, M) and channels past C read 0) times the four
    packed 16-byte chunks from (t * C + 64 s) / 16 on, which reach into tap
    t + 1's weights where C % 64 != 0 and are cancelled by those zero
    channels.  The products run in float64, exact here: |acc| <= k*k*C *
    128 * 127, far below 2^53."""
    p = _check_geometry(x, w, bias, geom, kernel, epilogue, mask_value)
    w2 = geom[2]
    M, c = x.shape
    H = p * w2 + p
    k = kernel[0]
    offs = [H + (dy - p) * w2 + (dx - p) for dy in range(k) for dx in range(k)]
    if isinstance(w, PackedConvWeight):
        kp16, op, _ = w.data.shape
        b = w.data.to(torch.float64)  # (K_pad / 16, o_pad, 16)
        xe = F.pad(x.to(torch.float64), (0, _round_up(c, SLICE) - c, H, H))
        acc = torch.zeros((M, op), dtype=torch.float64, device=x.device)
        for s in range(-(-c // SLICE)):
            xs = xe[:, SLICE * s:SLICE * (s + 1)]
            for t, off in enumerate(offs):
                q0 = (t * c) // 16 + 4 * s
                _build.require(q0 + 4 <= kp16, "conv_flat_int8: packed weights too short")
                acc += xs[off:off + M] @ b[q0:q0 + 4].permute(0, 2, 1).reshape(SLICE, op)
        acc = acc[:, :w.o]
    else:
        xe = F.pad(x.to(torch.float64), (0, 0, H, H))  # rows outside [0, M) read 0
        wd = w.to(torch.float64).reshape(k * k, c, -1)
        acc = torch.zeros((M, w.shape[3]), dtype=torch.float64, device=x.device)
        for t, off in enumerate(offs):
            acc += xe[off:off + M] @ wd[t]
    return _finish(acc.to(torch.int64), bias, geom, p, epilogue, net, out_signed, relu,
                   mask_pad, mask_value)


# -- the kernel -------------------------------------------------------------------


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 + [ctypes.c_void_p]


def conv_flat_int8_check(
    x: torch.Tensor, w, bias: torch.Tensor, *, geom, kernel=(3, 3), epilogue: str = "int32",
    net: int = 0, mask_value: int = 0, plan: Optional[FlatPlan] = None, sms: int = H100_SMS,
):
    """What conv_flat_int8 checks before it launches the kernel -- dtypes,
    shapes, the kernel's domain, the plan (plan_flat's on a card of `sms`
    SMs where none is given; RuntimeError where the halo does not fit),
    layout and alignment -- on tensors of any device; raises ValueError
    where the kernel does not take the call.  Returns (packed weight, plan)."""
    req = _build.require
    req(x.dtype == torch.int8, "conv_flat_int8: x must be int8")
    req(bias.dtype == torch.int32, "conv_flat_int8: bias must be int32")
    if isinstance(w, torch.Tensor):
        req(w.dtype == torch.int8, "conv_flat_int8: w must be int8")
    else:
        req(isinstance(w, PackedConvWeight), "conv_flat_int8: w must be HWIO or a PackedConvWeight")
    p = _check_geometry(x, w, bias, geom, kernel, epilogue, mask_value)
    M, c = x.shape
    o = w.shape[3]
    k, w2 = kernel[0], geom[2]
    req(c % 16 == 0, f"conv_flat_int8: needs C % 16 == 0, got {c}")
    req(o % 4 == 0, f"conv_flat_int8: needs O % 4 == 0, got {o}")
    req(-31 < net < 31, f"conv_flat_int8: shift {net} out of range")
    if isinstance(w, torch.Tensor):
        w = pack_conv_weight(w)
    if plan is None:
        plan = plan_flat(M, c, o, k, w2, sms)
    req(plan_fits(plan, c, o, k, w2), f"conv_flat_int8: the plan does not fit the call: {plan}")
    wdata = w.data
    req(
        wdata.dtype == torch.int8
        and tuple(wdata.shape) == (_round_up(k * k * c, 64) // 16, _round_up(o, N_ALIGN), 16),
        f"conv_flat_int8: packed weight data {tuple(wdata.shape)} {wdata.dtype} does not match "
        f"k={k} C={c} O={o}",
    )
    req(x.is_contiguous() and wdata.is_contiguous() and bias.is_contiguous(),
        "conv_flat_int8: contiguity")
    req(x.data_ptr() % 16 == 0 and wdata.data_ptr() % 16 == 0, "conv_flat_int8: alignment")
    return w, plan


def conv_flat_int8(
    x: torch.Tensor, w, bias: torch.Tensor, *, geom, kernel=(3, 3), epilogue: str = "int32",
    net: int = 0, out_signed: bool = True, relu: bool = False, mask_pad: bool = True,
    mask_value: int = 0, plan: Optional[FlatPlan] = None,
) -> torch.Tensor:
    """K6 on the tensors' device: the CUDA kernel on a card, the plain
    version on the CPU.  `w` is HWIO (packed here, on every call) or a
    PackedConvWeight (packed once by the caller).  `plan` overrides
    plan_flat's (to measure or test another one); on the CPU it is only
    checked against the call."""
    if x.device.type == "cpu":
        if plan is not None:
            conv_flat_int8_check(x, w, bias, geom=geom, kernel=kernel, epilogue=epilogue,
                                 net=net, mask_value=mask_value, plan=plan)
        return conv_flat_int8_plain(
            x, w, bias, geom=geom, kernel=kernel, epilogue=epilogue, net=net,
            out_signed=out_signed, relu=relu, mask_pad=mask_pad, mask_value=mask_value,
        )
    req = _build.require
    req(x.device.type == "cuda", f"conv_flat_int8: no kernel for device {x.device}")
    req(w.device == x.device and bias.device == x.device, "conv_flat_int8: mixed devices")
    w, plan = conv_flat_int8_check(
        x, w, bias, geom=geom, kernel=kernel, epilogue=epilogue, net=net, mask_value=mask_value,
        plan=plan, sms=_sm_count(x.device),
    )
    M, c = x.shape
    _, h2, w2 = geom
    out = torch.empty(
        (M, w.o), dtype=torch.int32 if epilogue == "int32" else torch.int8, device=x.device
    )
    lib, fn = _build.kernel("conv_flat", "f8_conv_flat", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), w.data.data_ptr(), bias.data_ptr(), out.data_ptr(), M, c, w.o, h2, w2,
            kernel[0], EPILOGUES[epilogue], net, int(out_signed), int(relu), int(mask_pad),
            mask_value, plan.bn, plan.splits, _build.stream_of(x),
        )
    # the entry refuses (invalid argument) a plan or a halo it does not take
    _build.check(lib, rc, f"conv_flat_int8 on rows of width {w2} at pad {(kernel[0] - 1) // 2}")
    conv_flat_int8.launches += 1
    return out


conv_flat_int8.launches = 0
