"""K5: a whole MobileNetV2 inverted-residual block -- 1x1 expand, requant,
KxK depthwise at stride 1, requant, 1x1 project, optional aligned residual
add -- in one kernel.  The port of
`f8net_tpu/ops/pallas_ir_block.py:fused_ir_block` (`:249-329`) in its strict
form (int32 or requant8 output, int32 carry), as the CUDA kernel
`csrc/ir_block.cu` (see its header for what bounds it on an H100 and what
its design does about that).

Junction math, bit for bit the Pallas kernel's (`_ir_kernel` `:121-217`):
  1. e = x8 . w1 + b1 (int32, wrapping); x8 packed on the expand's grid and
     b1 zero-point-compensated for that packing;
  2. e is requantized by `net1` onto the depthwise input's grid, whose clamp
     absorbs the ReLU, and kept UNPACKED (0..255 or -127..127);
  3. the depthwise runs on those values with true-zero padding and the plain
     bias bd;
  4. its result is requantized by `net2` and packed for the project;
  5. y = d8 . w2 + b2 (int32, wrapping; b2 zero-point-compensated);
  6. with a carry: (y << shift_res) + (carry << shift_carry) with int32
     wraparound, then a clip to +-INT32_MAX;
  7. an int32 output, or requant8 by `net_out` (`out_signed`).

`fused_ir_block` launches the kernel for CUDA tensors and raises on what it
does not take; for CPU tensors it runs `fused_ir_block_plain`.  The bf16
output and the packed 1-byte carry of the Pallas kernel serve the boundary
rungs, which the port does not have yet (ROADMAP item 4).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .fxp import INT32_MAX, requant_net, wrap_i32
from .gemm import EPILOGUES, int8_gemm_plain


def ir_block_operands_plain(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor, *,
    net1: int = 0, dw_in_signed: bool = False, net2: int = 0, proj_in_signed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Steps 1-4 of the junction math, plainly: the depthwise's 8-bit input
    UNPACKED (int32, 0..255 or -127..127) and the project's 8-bit input
    packed (int8), both (n, h, w, ce).  The depthwise runs in float64 on the
    unpacked values (exact: |acc| <= k*k * 255 * 128, far below 2^53)."""
    n, h, w, cin = x.shape
    kh, kw, ce = wd.shape
    e = int8_gemm_plain(x.reshape(-1, cin), w1, b1)
    ev = requant_net(e, net1, 8, dw_in_signed).reshape(n, h, w, ce)
    acc = F.conv2d(
        ev.permute(0, 3, 1, 2).to(torch.float64),
        wd.permute(2, 0, 1).unsqueeze(1).to(torch.float64),
        padding=((kh - 1) // 2, (kw - 1) // 2), groups=ce,
    )
    d = wrap_i32(acc.permute(0, 2, 3, 1).to(torch.int64) + bd.to(torch.int64))
    d8 = requant_net(d, net2, 8, proj_in_signed)
    if not proj_in_signed:
        d8 = d8 - 128
    return ev, d8.to(torch.int8)


def fused_ir_block_plain(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor, carry: Optional[torch.Tensor] = None, *,
    net1: int = 0, dw_in_signed: bool = False, net2: int = 0, proj_in_signed: bool = False,
    out: str = "int32", net_out: int = 0, out_signed: bool = False, shift_res: int = 0,
    shift_carry: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of K5: `ir_block_operands_plain`, then the
    project with K1's plain GEMM, the carry add and the output epilogue."""
    n, h, w, _ = x.shape
    ce, cout = w2.shape
    _, d8 = ir_block_operands_plain(
        x, w1, b1, wd, bd, net1=net1, dw_in_signed=dw_in_signed, net2=net2,
        proj_in_signed=proj_in_signed,
    )
    y = int8_gemm_plain(d8.reshape(-1, ce), w2, b2).reshape(n, h, w, cout)
    if carry is not None:
        y = wrap_i32((y.to(torch.int64) << shift_res) + (carry.to(torch.int64) << shift_carry))
        y = y.clamp(-INT32_MAX, INT32_MAX)
    if out == "int32":
        return y.contiguous()
    if out != "requant8":
        raise ValueError(f"unknown output {out!r}")
    r = requant_net(y, net_out, 8, out_signed)
    if not out_signed:
        r = r - 128
    return r.to(torch.int8).contiguous()


_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 16 + [ctypes.c_void_p]


def fused_ir_block(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor, carry: Optional[torch.Tensor] = None, *,
    net1: int = 0, dw_in_signed: bool = False, net2: int = 0, proj_in_signed: bool = False,
    out: str = "int32", net_out: int = 0, out_signed: bool = False, shift_res: int = 0,
    shift_carry: int = 0,
) -> torch.Tensor:
    """K5 on the tensors' device: the CUDA kernel on a card, the plain
    version on the CPU."""
    kw_ = dict(
        net1=net1, dw_in_signed=dw_in_signed, net2=net2, proj_in_signed=proj_in_signed,
        out=out, net_out=net_out, out_signed=out_signed, shift_res=shift_res,
        shift_carry=shift_carry,
    )
    if x.device.type == "cpu":
        return fused_ir_block_plain(x, w1, b1, wd, bd, w2, b2, carry, **kw_)
    req = _build.require
    ins = (x, w1, b1, wd, bd, w2, b2) + ((carry,) if carry is not None else ())
    req(x.device.type == "cuda", f"fused_ir_block: no kernel for device {x.device}")
    req(all(t.device == x.device for t in ins), "fused_ir_block: mixed devices")
    req(all(t.dtype == torch.int8 for t in (x, w1, wd, w2)), "fused_ir_block: x, w1, wd, w2: int8")
    req(
        all(t.dtype == torch.int32 for t in ins if t.dtype != torch.int8),
        "fused_ir_block: b1, bd, b2, carry: int32",
    )
    req(x.ndim == 4 and w1.ndim == 2 and wd.ndim == 3 and w2.ndim == 2, "fused_ir_block: ranks")
    n, h, w, cin = x.shape
    kh, kw, ce = wd.shape
    cout = w2.shape[1]
    req(
        tuple(w1.shape) == (cin, ce) and tuple(w2.shape) == (ce, cout)
        and b1.shape == (ce,) and bd.shape == (ce,) and b2.shape == (cout,),
        "fused_ir_block: weight or bias shapes",
    )
    req(carry is None or tuple(carry.shape) == (n, h, w, cout), "fused_ir_block: carry shape")
    req(kh == kw and kh % 2 == 1, f"fused_ir_block: needs a square odd kernel, got {kh}x{kw}")
    req(
        cin % 4 == 0 and ce % 4 == 0 and cout % 4 == 0,
        f"fused_ir_block: needs channels % 4 == 0, got {cin}, {ce}, {cout}",
    )
    req(all(t.is_contiguous() for t in ins), "fused_ir_block: contiguity")
    req(all(t.data_ptr() % 4 == 0 for t in ins), "fused_ir_block: alignment")
    req(out in EPILOGUES, f"fused_ir_block: unknown output {out!r}")
    req(all(-31 < s < 31 for s in (net1, net2, net_out)), "fused_ir_block: shift out of range")
    req(0 <= shift_res < 32 and 0 <= shift_carry < 32, "fused_ir_block: carry shift out of range")
    y = torch.empty(
        (n, h, w, cout), dtype=torch.int32 if out == "int32" else torch.int8, device=x.device
    )
    lib, fn = _build.kernel("ir_block", "f8_ir_block", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), wd.data_ptr(), bd.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), None if carry is None else carry.data_ptr(),
            y.data_ptr(), n, h, w, cin, ce, cout, kh, net1, int(dw_in_signed), net2,
            int(proj_in_signed), EPILOGUES[out], net_out, int(out_signed), shift_res,
            shift_carry, _build.stream_of(x),
        )
        fused_ir_block.launches += 1
    _build.check(lib, rc, "fused_ir_block")
    return y


fused_ir_block.launches = 0
