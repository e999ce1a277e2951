"""K6: stride-1 odd kxk int8 convolution on the flat padded raster, with
the fused bias + ReLU + requant epilogue and the pad-ring mask -- the port
of `f8net_tpu/ops/pallas_conv_flat.py:conv_flat_int8` (`:130-241`) and its
`pack_flat` / `unpack_flat` (`:249-267`), as the CUDA kernel
`csrc/conv_flat.cu` (see its header for what bounds it on an H100 and what
its design does about that).

x is a flat (M, C) int8 matrix whose rows are the spatially padded raster,
M = n * h2 * w2, `geom` = (n, h2, w2), with the layer's packed zero in the
pad ring (`pack_flat`).  Output row m is

    epilogue(sum over taps (dy, dx) of x[m + (dy - p) * w2 + (dx - p)] @ w[dy, dx] + bias)

where rows outside [0, M) read 0, p = (k - 1) // 2.  With `mask_pad`, rows
on the pad ring are set to `mask_value` (the consumer's packed zero for a
requant8 chain, 0 for int32); without it they keep what their windows
compute, across image boundaries.  Every one of the M rows is part of the
result.  Epilogues as `ops.gemm`.

The JAX engine never calls K6, and neither does the port's: it is the op it
is in f8net_tpu.  `conv_flat_int8` launches the kernel for CUDA tensors and
raises on what it does not take; for CPU tensors it runs
`conv_flat_int8_plain`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .gemm import EPILOGUES, epilogue_plain


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


def _check_geometry(x, w, bias, geom, kernel, epilogue, mask_value):
    req = _build.require
    n, h2, w2 = geom
    kh, kw = kernel
    p = (kh - 1) // 2
    req((kh, kw) == (2 * p + 1, 2 * p + 1), f"conv_flat_int8: odd square kernels, got {kernel}")
    req(x.ndim == 2 and x.shape[0] == n * h2 * w2, f"conv_flat_int8: x rows are not {geom}")
    req(w.ndim == 4 and tuple(w.shape[:3]) == (kh, kw, x.shape[1]), "conv_flat_int8: w shape")
    req(bias.shape == (w.shape[3],), "conv_flat_int8: bias shape")
    req(h2 >= kh and w2 >= kw, "conv_flat_int8: raster smaller than the kernel")
    req(epilogue in EPILOGUES, f"conv_flat_int8: unknown epilogue {epilogue!r}")
    lo, hi = (-128, 127) if epilogue == "requant8" else (-(1 << 31), (1 << 31) - 1)
    req(lo <= mask_value <= hi, f"conv_flat_int8: mask_value {mask_value} out of range")
    return p


def conv_flat_int8_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *, geom, kernel=(3, 3),
    epilogue: str = "int32", net: int = 0, out_signed: bool = True, relu: bool = False,
    mask_pad: bool = True, mask_value: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of K6, every row.  The taps' products run in
    float64, exact here: |acc| <= k*k*C * 128 * 127, far below 2^53."""
    p = _check_geometry(x, w, bias, geom, kernel, epilogue, mask_value)
    n, h2, w2 = geom
    M = x.shape[0]
    H = p * w2 + p
    xe = F.pad(x.to(torch.float64), (0, 0, H, H))  # rows outside [0, M) read 0
    wd = w.to(torch.float64)
    acc = torch.zeros((M, w.shape[3]), dtype=torch.float64, device=x.device)
    for dy in range(kernel[0]):
        for dx in range(kernel[1]):
            off = H + (dy - p) * w2 + (dx - p)
            acc += xe[off:off + M] @ wd[dy, dx]
    y = epilogue_plain(acc.to(torch.int64), bias, epilogue, net, out_signed, relu)
    if mask_pad:
        m = torch.arange(M, device=x.device)
        col, row = m % w2, (m // w2) % h2
        ring = (col < p) | (col >= w2 - p) | (row < p) | (row >= h2 - p)
        y = y.masked_fill(ring[:, None], mask_value)
    return y


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


def conv_flat_int8(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *, geom, kernel=(3, 3),
    epilogue: str = "int32", net: int = 0, out_signed: bool = True, relu: bool = False,
    mask_pad: bool = True, mask_value: int = 0,
) -> torch.Tensor:
    """K6 on the tensors' device: the CUDA kernel on a card, the plain
    version on the CPU."""
    kw_ = dict(
        geom=geom, kernel=kernel, epilogue=epilogue, net=net, out_signed=out_signed, relu=relu,
        mask_pad=mask_pad, mask_value=mask_value,
    )
    if x.device.type == "cpu":
        return conv_flat_int8_plain(x, w, bias, **kw_)
    req = _build.require
    req(x.device.type == "cuda", f"conv_flat_int8: no kernel for device {x.device}")
    req(w.device == x.device and bias.device == x.device, "conv_flat_int8: mixed devices")
    req(x.dtype == torch.int8 and w.dtype == torch.int8, "conv_flat_int8: x and w must be int8")
    req(bias.dtype == torch.int32, "conv_flat_int8: bias must be int32")
    p = _check_geometry(x, w, bias, geom, kernel, epilogue, mask_value)
    M, c = x.shape
    o = w.shape[3]
    _, h2, w2 = geom
    req(c % 16 == 0, f"conv_flat_int8: needs C % 16 == 0, got {c}")
    req(o % 4 == 0, f"conv_flat_int8: needs O % 4 == 0, got {o}")
    req(x.is_contiguous() and w.is_contiguous() and bias.is_contiguous(),
        "conv_flat_int8: contiguity")
    req(x.data_ptr() % 16 == 0 and w.data_ptr() % 4 == 0, "conv_flat_int8: alignment")
    req(-31 < net < 31, f"conv_flat_int8: shift {net} out of range")
    out = torch.empty(
        (M, o), dtype=torch.int32 if epilogue == "int32" else torch.int8, device=x.device
    )
    lib, fn = _build.kernel("conv_flat", "f8_conv_flat", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), M, c, o, h2, w2,
            kernel[0], EPILOGUES[epilogue], net, int(out_signed), int(relu), int(mask_pad),
            mask_value, _build.stream_of(x),
        )
    # the entry refuses (invalid argument) a halo that does not fit one block's shared memory
    _build.check(lib, rc, f"conv_flat_int8 on rows of width {w2} at pad {p}")
    conv_flat_int8.launches += 1
    return out


conv_flat_int8.launches = 0
