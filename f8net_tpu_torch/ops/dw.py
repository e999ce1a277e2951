"""K4: NHWC int8 depthwise KxK convolution with the fused bias + requant
epilogue -- the port of `f8net_tpu/ops/pallas_dw.py:pallas_depthwise_int8`
(`:112-230`), as the CUDA kernel `csrc/dw_conv.cu` (see its header for what
bounds it on an H100 and what its design does about that).

    y = epilogue(depthwise_conv2d(x, w; stride, padding filled with pad_value)
                 + bias)

x: int8 NHWC, packed (pad_value is the packed zero: -128 for an unsigned
input, 0 for a signed one).  w: int8 (kh, kw, 1, C), square and odd.  bias:
int32 (C,) at the accumulator scale, holding any zero-point compensation.
Stride 1 or 2: the Pallas kernel compiled only at stride 1, and the JAX
engine kept stride-2 depthwise on XLA; here both run on the kernel.
Epilogues as `ops.gemm`.

`dw_int8` launches the kernel for CUDA tensors and raises on what it does
not take; for CPU tensors it runs `dw_int8_plain`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .gemm import EPILOGUES, epilogue_plain


def dw_int8_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *, stride: int = 1,
    padding: int = 0, pad_value: int = 0, epilogue: str = "int32", net: int = 0,
    out_signed: bool = True, relu: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of K4: a float64 grouped convolution, exact
    here (|acc| <= kh*kw * 128 * 127, far below 2^53)."""
    c = x.shape[3]
    xd = F.pad(
        x.permute(0, 3, 1, 2).to(torch.float64),
        (padding, padding, padding, padding), value=float(pad_value),
    )
    y = F.conv2d(xd, w.permute(3, 2, 0, 1).to(torch.float64), stride=stride, groups=c)
    acc = y.permute(0, 2, 3, 1).to(torch.int64)
    return epilogue_plain(acc, bias, epilogue, net, out_signed, relu).contiguous()


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 + [ctypes.c_void_p]


def dw_int8(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *, stride: int = 1,
    padding: int = 0, pad_value: int = 0, epilogue: str = "int32", net: int = 0,
    out_signed: bool = True, relu: bool = False,
) -> torch.Tensor:
    """K4 on the tensors' device: the CUDA kernel on a card, the plain
    version on the CPU."""
    kw_ = dict(
        stride=stride, padding=padding, pad_value=pad_value, epilogue=epilogue,
        net=net, out_signed=out_signed, relu=relu,
    )
    if x.device.type == "cpu":
        return dw_int8_plain(x, w, bias, **kw_)
    req = _build.require
    req(x.device.type == "cuda", f"dw_int8: no kernel for device {x.device}")
    req(w.device == x.device and bias.device == x.device, "dw_int8: mixed devices")
    req(x.dtype == torch.int8 and w.dtype == torch.int8, "dw_int8: x and w must be int8")
    req(bias.dtype == torch.int32, "dw_int8: bias must be int32")
    req(x.ndim == 4 and w.ndim == 4, "dw_int8: x must be NHWC, w (kh, kw, 1, C)")
    n, h, wd, c = x.shape
    kh, kw, wi, o = w.shape
    req(wi == 1 and o == c and bias.shape == (c,), "dw_int8: w (kh, kw, 1, C), bias (C,)")
    req(c % 16 == 0, f"dw_int8: needs C % 16 == 0, got {c}")
    req(kh == kw and kh % 2 == 1 and kh <= 9, f"dw_int8: needs a square odd k <= 9, got {kh}x{kw}")
    req(stride in (1, 2) and padding >= 0, f"dw_int8: stride {stride}, padding {padding}")
    req(-128 <= pad_value <= 127, "dw_int8: pad_value is an int8")
    req(x.is_contiguous() and w.is_contiguous() and bias.is_contiguous(), "dw_int8: contiguity")
    req(x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0, "dw_int8: alignment")
    req(epilogue in EPILOGUES, f"dw_int8: unknown epilogue {epilogue!r}")
    req(-31 < net < 31, f"dw_int8: shift {net} out of range")
    oh = (h + 2 * padding - kh) // stride + 1
    ow = (wd + 2 * padding - kw) // stride + 1
    req(oh > 0 and ow > 0, "dw_int8: empty output")
    out = torch.empty(
        (n, oh, ow, c), dtype=torch.int32 if epilogue == "int32" else torch.int8,
        device=x.device,
    )
    lib, fn = _build.kernel("dw_conv", "f8_dw_conv", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, h, wd, c, oh, ow, kh, stride, padding, pad_value,
            EPILOGUES[epilogue], net, int(out_signed), int(relu), _build.stream_of(x),
        )
        dw_int8.launches += 1
    _build.check(lib, rc, "dw_int8")
    return out


dw_int8.launches = 0
