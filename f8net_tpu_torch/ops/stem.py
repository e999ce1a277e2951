"""K3: the fused ResNet stem -- 7x7/s2/p3 conv over packed int8 NHWC input
with 3 channels, + int32 bias, ReLU, 3x3/s2/p1 maxpool -- writing only the
pooled int32 activation.  The port of
`f8net_tpu/ops/pallas_stem.py:stem_pool_int8_v2` (`:252-316`) and of the v1
`stem_pool_int8` (`:101`), as the CUDA kernel `csrc/stem_pool.cu` (see its
header for what bounds it on an H100 and what its design does about that).

The kernel reads the packed input directly; the Pallas kernels' band and
space-to-depth pre-pass (`build_stem_inputs_v2`) existed only for Mosaic.
The border is filled with `pad_value`, the packed zero (-128 for the
unsigned head, 0 for the signed one), so the bias `b + zp * colsum(w)` --
the engine's `b_zp` -- compensates every tap alike.

The kernel computes the conv as an int8 GEMM on tensor cores over a
reduction of 7 kernel rows x 8 pixels x 4 bytes (3 channels and a pad
byte); `pack_stem_weight` lays the (7, 7, 3, O) HWIO weights out in that
order once, with zeros at every pad byte, and `IntEngine` passes them
packed.  O is ResNet's 64, or any multiple of 64 (128 where
`IntEngine(pad_channels_to=128)` pads the stem): the kernel runs one
64-channel group per grid row.

`stem_pool` launches the kernel for CUDA tensors and raises on what it does
not take; for CPU tensors it runs `stem_pool_plain`, which computes from the
packed layout when given packed weights.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .fxp import wrap_i32

STEM_K = 7 * 8 * 4  # packed reduction: 7 ky x 8 pixels x 4 bytes


def stem_out_hw(h: int, w: int):
    """(conv h, conv w, pooled h, pooled w) of the 7x7/s2/p3 conv and the
    3x3/s2/p1 pool."""
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return oh, ow, (oh - 1) // 2 + 1, (ow - 1) // 2 + 1


def pack_stem_weight(w: torch.Tensor) -> torch.Tensor:
    """(7, 7, 3, O) HWIO int8 -> (O, STEM_K) K-major int8, on w's device:
    packed[o, 32 ky + 4 kx + c] = w[ky, kx, c, o] for kx < 7 and c < 3, 0
    at the pad bytes (kx = 7, c = 3)."""
    o = w.shape[3]
    p = torch.zeros((o, 7, 8, 4), dtype=torch.int8, device=w.device)
    p[:, :, :7, :3] = w.permute(3, 0, 1, 2)
    return p.reshape(o, STEM_K)


def _stem_acc_packed(x: torch.Tensor, wp: torch.Tensor, pad_value: int) -> torch.Tensor:
    """The stem conv from the packed layout, plain: for every conv position
    the 7 input rows of 8 pixels at 4 bytes each (3 channels, then a pad
    byte of 0; pixels past the padded input are 0 too) in the kernel's
    reduction order, times the packed weights.  NCHW float64 accumulators,
    exact (|acc| < 2^53)."""
    n, h, w, _ = x.shape
    oh, ow, _, _ = stem_out_hw(h, w)
    xp = F.pad(x.to(torch.float64), (0, 1, 3, 3, 3, 3), value=float(pad_value))
    xp[..., 3] = 0
    xp = F.pad(xp, (0, 0, 0, 2 * ow + 6 - xp.shape[2]))  # the 8th pixel of the last window
    rows = [
        xp[:, ky: ky + 2 * oh - 1: 2, kx: kx + 2 * ow - 1: 2]
        for ky in range(7) for kx in range(8)
    ]
    a = torch.cat(rows, dim=3).reshape(n * oh * ow, STEM_K)
    acc = torch.matmul(a, wp.to(torch.float64).t())
    return acc.reshape(n, oh, ow, wp.shape[0]).permute(0, 3, 1, 2)


def stem_pool_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *, pad_value: int = 0
) -> torch.Tensor:
    """Plain PyTorch version of K3, from HWIO weights (a float64 conv2d) or
    packed ones (_stem_acc_packed).  Conv and pool run in float64, exact for
    these integers (|acc| <= 147 * 128 * 127)."""
    if w.ndim == 2:
        y = _stem_acc_packed(x, w, pad_value)
    else:
        xd = F.pad(x.permute(0, 3, 1, 2).to(torch.float64), (3, 3, 3, 3), value=float(pad_value))
        y = F.conv2d(xd, w.permute(3, 2, 0, 1).to(torch.float64), stride=2)
    acc = wrap_i32(y.to(torch.int64) + bias.to(torch.int64).reshape(1, -1, 1, 1))
    acc = acc.clamp_min(0)
    pooled = F.max_pool2d(acc.to(torch.float64), 3, 2, 1)
    return pooled.to(torch.int32).permute(0, 2, 3, 1).contiguous()


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def stem_pool_check(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *, pad_value: int = 0
) -> torch.Tensor:
    """What stem_pool checks before it launches the kernel -- dtypes,
    shapes, layout and alignment -- on tensors of any device; raises
    ValueError where the kernel does not take the call.  Returns the packed
    weights."""
    req = _build.require
    req(x.dtype == torch.int8 and w.dtype == torch.int8, "stem_pool: x and w must be int8")
    o = w.shape[-1] if w.ndim == 4 else w.shape[0]
    req(o >= 64 and o % 64 == 0, f"stem_pool: needs O % 64 == 0, got {o}")
    req(bias.dtype == torch.int32 and bias.shape == (o,), f"stem_pool: bias ({o},) int32")
    req(x.ndim == 4 and x.shape[3] == 3, "stem_pool: x must be (n, h, w, 3)")
    req(tuple(w.shape) in ((7, 7, 3, o), (o, STEM_K)),
        f"stem_pool: w must be (7, 7, 3, {o}) HWIO or ({o}, {STEM_K}) packed")
    if w.ndim == 4:
        w = pack_stem_weight(w)
    req(-128 <= pad_value <= 127, "stem_pool: pad_value is an int8")
    req(x.is_contiguous() and w.is_contiguous() and bias.is_contiguous(), "stem_pool: contiguity")
    req(w.data_ptr() % 16 == 0, "stem_pool: alignment")
    return w


def stem_pool(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *, pad_value: int = 0
) -> torch.Tensor:
    """K3 on the tensors' device: the CUDA kernel on a card, the plain
    version on the CPU.  `w` is (7, 7, 3, O) HWIO (packed here, on every
    call) or (O, STEM_K) packed by pack_stem_weight (once, by the caller),
    O a multiple of 64."""
    if x.device.type == "cpu":
        return stem_pool_plain(x, w, bias, pad_value=pad_value)
    req = _build.require
    req(x.device.type == "cuda", f"stem_pool: no kernel for device {x.device}")
    req(w.device == x.device and bias.device == x.device, "stem_pool: mixed devices")
    w = stem_pool_check(x, w, bias, pad_value=pad_value)
    n, h, wd, _ = x.shape
    oh, ow, ph, pw = stem_out_hw(h, wd)
    out = torch.empty((n, ph, pw, w.shape[0]), dtype=torch.int32, device=x.device)
    lib, fn = _build.kernel("stem_pool", "f8_stem_pool", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, h, wd, oh, ow, ph, pw, w.shape[0], pad_value, _build.stream_of(x),
        )
    _build.check(lib, rc, "stem_pool")
    stem_pool.launches += 1
    return out


stem_pool.launches = 0
