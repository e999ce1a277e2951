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

The kernel computes a tile of th x tw output pixels x cb channels per block
step from a halo of the input staged in shared memory, border cells filled
with pad_value; `plan_dw` shapes the tiles per call.

`dw_int8` launches the kernel for CUDA tensors and raises on what it does
not take; for CPU tensors it runs `dw_int8_plain` (with a plan:
`dw_int8_tiled_plain`, the kernel's tiling and border fill emulated).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .gemm import EPILOGUES, H100_SMS, SMEM_LIMIT, SMEM_PER_SM, _round_up, _sm_count
from .gemm import epilogue_plain

RUN = {1: 8, 2: 4}  # output pixels along x per thread, by stride (csrc/dw_conv.cu dw_run)
MAX_THREADS = 512
MAX_CB = 128  # channels per tile: the halo loader's multiply-shift divides by cb / 16 <= 8
MAX_HALO_CHUNKS = 8192  # 16-byte chunks per halo row it divides exactly (r * 8 < 2^16)


def regs_per_thread(k: int, stride: int) -> int:
    """Registers a thread of the kernel takes, as the plans assume them
    (ptxas on sm_90a gave 64-78 at k = 3 and up to 111 at k = 9)."""
    return (80 if stride == 1 else 64) if k <= 3 else 112


def dw_npx(k: int, stride: int) -> int:
    """Input pixels a thread reads per halo row: its run's window, widened
    so that every 4-tap weight word's window lies inside (csrc dw_npx)."""
    return _round_up((RUN[stride] - 1) * stride + _round_up(k, 4), 4)


class DwPlan(NamedTuple):
    """K4's launch plan: output tiles of `th` rows x `tw` columns (a
    multiple of the per-thread run) x `cb` channels, halo rows of `rowb`
    bytes in shared memory, `grid` persistent blocks."""

    th: int
    tw: int
    cb: int
    rowb: int
    grid: int


class DwGeometry(NamedTuple):
    """What a plan means for one call: output size, halo rows x pixels per
    row, tiles along y, x and channels, threads per block, shared memory
    (two halos)."""

    oh: int
    ow: int
    ih: int
    iwp: int
    ty: int
    tx: int
    cg: int
    threads: int
    smem: int

    @property
    def tiles_per_image(self) -> int:
        return self.ty * self.tx * self.cg


def dw_out_hw(h: int, w: int, k: int, stride: int, padding: int) -> Tuple[int, int]:
    return (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1


def dw_geometry(h, w, c, k, stride, padding, th, tw, cb, rowb=None) -> DwGeometry:
    oh, ow = dw_out_hw(h, w, k, stride, padding)
    r = RUN[stride]
    ih = (th - 1) * stride + k
    iwp = (tw - r) * stride + dw_npx(k, stride)
    rowb = iwp * cb if rowb is None else rowb
    threads = (cb // 4) * th * (tw // r)
    return DwGeometry(oh, ow, ih, iwp, -(-oh // th), -(-ow // tw), c // cb, threads, 2 * ih * rowb)


def _bank_ways(th, tw, cb, stride, rowb) -> int:
    """Most distinct 4-byte words one shared-memory bank serves in a warp's
    first halo read (lane -> channel quad, then output row, then run: the
    kernel's mapping)."""
    q, r = cb // 4, RUN[stride]
    banks = {}
    for lane in range(min(32, q * th * (tw // r))):
        run = lane // q
        ry, rx = run % th, run // th
        word = (ry * stride * rowb + rx * r * stride * cb + 4 * (lane % q)) // 4
        banks.setdefault(word % 32, set()).add(word)
    return max(len(v) for v in banks.values())


def row_bytes(th, tw, cb, k, stride) -> int:
    """Halo row stride: the pixels' bytes padded by the multiple of 16 (below
    128) that spreads a warp's first read over the most banks."""
    base = ((tw - RUN[stride]) * stride + dw_npx(k, stride)) * cb
    return min((base + p for p in range(0, 128, 16)),
               key=lambda rb: (_bank_ways(th, tw, cb, stride, rb), rb))


def blocks_per_sm(threads: int, smem: int, regs: int) -> int:
    """Resident blocks per SM: by threads (2048 per SM), by registers (64K
    per SM at `regs` a thread), by shared memory; at most 8."""
    return max(1, min(8, 2048 // threads, 65536 // (regs * threads), SMEM_PER_SM // (smem + 1024)))


def dw_candidates(n, h, w, c, k, stride, padding, sms: int = H100_SMS):
    """Every plan plan_dw weighs for a call (probe_plans.py times them all):
    channel blocks cb (multiples of 16 dividing C, at most MAX_CB), tile rows
    th (1-16, or the whole output height if it is at most 16), tile columns
    tw (1-8 runs), with 64-512 threads a block (fewer only where the call
    is too small for 64); grid = the tiles, up to the blocks the card holds
    at once, or one or two persistent blocks per SM that walk several tiles
    each."""
    oh, ow = dw_out_hw(h, w, k, stride, padding)
    r = RUN[stride]
    out = []
    for cb in range(16, min(c, MAX_CB) + 1, 16):
        if c % cb:
            continue
        for th in sorted({1, 2, 4, 8, 16} | ({oh} if oh <= 16 else set())):
            if th > oh:
                continue
            for runs in (1, 2, 4, 8):
                tw = runs * r
                if tw > _round_up(ow, r):
                    continue
                threads = (cb // 4) * th * runs
                if threads > MAX_THREADS:
                    continue
                rowb = row_bytes(th, tw, cb, k, stride)
                g = dw_geometry(h, w, c, k, stride, padding, th, tw, cb, rowb)
                tiles = n * g.tiles_per_image
                full = min(tiles, sms * blocks_per_sm(threads, g.smem, regs_per_thread(k, stride)))
                for grid in sorted({full, min(full, sms), min(full, 2 * sms)}):
                    out.append((threads, DwPlan(th, tw, cb, rowb, grid)))
    # blocks of fewer than 64 threads only where the call allows no larger
    return [p for t, p in out if t >= min(64, max(t for t, _ in out))]


def dw_cost(plan: DwPlan, n, h, w, c, k, stride, padding, sms: int = H100_SMS) -> float:
    """plan_dw's cost model, in bytes one SM moves: the waves of resident
    blocks the tiles take, times the blocks an SM holds, times what a tile
    moves -- its halo, each pixel's cb bytes rounded up to whole 32-byte
    sectors unless the block takes every channel, and its outputs.  Fitted
    to probe_plans.py's times of every candidate at MobileNetV2's five calls
    at batch 8 and 64 on an H100 (PERF.md section 6)."""
    g = dw_geometry(h, w, c, k, stride, padding, plan.th, plan.tw, plan.cb, plan.rowb)
    bps = blocks_per_sm(g.threads, g.smem, regs_per_thread(k, stride))
    waves = -(-n * g.tiles_per_image // (sms * bps))
    pixel = plan.cb if plan.cb == c else _round_up(plan.cb, 32)
    return waves * bps * (g.ih * g.iwp * pixel + plan.th * plan.tw * plan.cb)


@functools.lru_cache(maxsize=None)
def plan_dw(n, h, w, c, k, stride, padding, sms: int = H100_SMS) -> DwPlan:
    """Plan a K4 call: the candidate of least dw_cost (ties: more threads,
    then more blocks)."""
    cands = dw_candidates(n, h, w, c, k, stride, padding, sms)
    return min(cands, key=lambda p: (dw_cost(p, n, h, w, c, k, stride, padding, sms),
                                     -(p.cb // 4) * p.th * p.tw, -p.grid))


def dw_tiles(plan: DwPlan, n, h, w, c, k, stride, padding) -> Iterator[Tuple[int, ...]]:
    """(image, first output row, first output column, first channel, first
    halo row, first halo column) of each tile, in the kernel's order
    (channel block fastest)."""
    g = dw_geometry(h, w, c, k, stride, padding, plan.th, plan.tw, plan.cb, plan.rowb)
    for t in range(n * g.tiles_per_image):
        rest, cg = divmod(t, g.cg)
        rest, tx = divmod(rest, g.tx)
        img, ty = divmod(rest, g.ty)
        oy0, ox0 = ty * plan.th, tx * plan.tw
        yield img, oy0, ox0, cg * plan.cb, oy0 * stride - padding, ox0 * stride - padding


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


def dw_int8_tiled_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, plan: DwPlan, *, stride: int = 1,
    padding: int = 0, pad_value: int = 0, epilogue: str = "int32", net: int = 0,
    out_signed: bool = True, relu: bool = False,
) -> torch.Tensor:
    """K4 under `plan`, plain: each tile's outputs computed from its halo
    alone -- ih x iwp pixels of cb channels, the cells outside the image set
    to pad_value as the kernel's loader sets them -- then the epilogue."""
    n, h, wd, c = x.shape
    k = w.shape[0]
    g = dw_geometry(h, wd, c, k, stride, padding, plan.th, plan.tw, plan.cb, plan.rowb)
    acc = torch.zeros((n, g.oh, g.ow, c), dtype=torch.int64)
    seen = torch.zeros((n, g.oh, g.ow, c), dtype=torch.int64)
    for img, oy0, ox0, c0, iy0, ix0 in dw_tiles(plan, n, h, wd, c, k, stride, padding):
        halo = torch.full((g.ih, g.iwp, plan.cb), pad_value, dtype=torch.float64)
        y0, y1 = max(iy0, 0), min(iy0 + g.ih, h)
        x0, x1 = max(ix0, 0), min(ix0 + g.iwp, wd)
        if y0 < y1 and x0 < x1:
            halo[y0 - iy0:y1 - iy0, x0 - ix0:x1 - ix0] = x[img, y0:y1, x0:x1, c0:c0 + plan.cb].double()
        wt = w[..., c0:c0 + plan.cb].permute(3, 2, 0, 1).to(torch.float64)
        y = F.conv2d(halo.permute(2, 0, 1)[None], wt, stride=stride, groups=plan.cb)[0]
        oy1, ox1 = min(oy0 + plan.th, g.oh), min(ox0 + plan.tw, g.ow)
        tile = y[:, : oy1 - oy0, : ox1 - ox0].permute(1, 2, 0).to(torch.int64)
        acc[img, oy0:oy1, ox0:ox1, c0:c0 + plan.cb] = tile
        seen[img, oy0:oy1, ox0:ox1, c0:c0 + plan.cb] += 1
    if not bool((seen == 1).all()):
        raise AssertionError("the plan does not compute every output once")
    return epilogue_plain(acc, bias, epilogue, net, out_signed, relu).contiguous()


@functools.lru_cache(maxsize=None)
def plan_fits(plan: DwPlan, n, h, w, c, k, stride, padding) -> bool:
    """Whether the kernel takes `plan` for the call."""
    g = dw_geometry(h, w, c, k, stride, padding, plan.th, plan.tw, plan.cb, plan.rowb)
    return (plan.cb % 16 == 0 and 16 <= plan.cb <= MAX_CB and c % plan.cb == 0 and plan.th >= 1
            and plan.tw >= RUN[stride] and plan.tw % RUN[stride] == 0
            and 1 <= g.threads <= MAX_THREADS and plan.rowb % 16 == 0
            and plan.rowb >= g.iwp * plan.cb and g.iwp * plan.cb // 16 <= MAX_HALO_CHUNKS
            and g.smem <= SMEM_LIMIT and plan.grid >= 1)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 19 + [ctypes.c_void_p]


def dw_int8_check(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *, stride: int = 1,
    padding: int = 0, pad_value: int = 0, epilogue: str = "int32", net: int = 0,
    out_signed: bool = True, relu: bool = False, plan: Optional[DwPlan] = None,
    sms: int = H100_SMS,
) -> DwPlan:
    """What dw_int8 checks before it launches the kernel -- dtypes, shapes,
    the kernel's domain, the plan (plan_dw's on a card of `sms` SMs where
    none is given), layout and alignment -- on tensors of any device;
    raises ValueError where the kernel does not take the call.  Returns
    the plan."""
    req = _build.require
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
    req(x.data_ptr() % 16 == 0 and w.data_ptr() % 4 == 0, "dw_int8: alignment")
    req(epilogue in EPILOGUES, f"dw_int8: unknown epilogue {epilogue!r}")
    req(-31 < net < 31, f"dw_int8: shift {net} out of range")
    oh, ow = dw_out_hw(h, wd, kh, stride, padding)
    req(oh > 0 and ow > 0, "dw_int8: empty output")
    if plan is None:
        plan = plan_dw(n, h, wd, c, kh, stride, padding, sms)
    req(plan_fits(plan, n, h, wd, c, kh, stride, padding),
        f"dw_int8: the plan does not fit the call: {plan}")
    return plan


def dw_int8(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *, stride: int = 1,
    padding: int = 0, pad_value: int = 0, epilogue: str = "int32", net: int = 0,
    out_signed: bool = True, relu: bool = False, plan: Optional[DwPlan] = None,
) -> torch.Tensor:
    """K4 on the tensors' device: the CUDA kernel on a card, the plain
    version on the CPU.  `plan` overrides plan_dw's (to measure or test
    another one)."""
    kw_ = dict(
        stride=stride, padding=padding, pad_value=pad_value, epilogue=epilogue,
        net=net, out_signed=out_signed, relu=relu,
    )
    if x.device.type == "cpu":
        if plan is not None:
            return dw_int8_tiled_plain(x, w, bias, plan, **kw_)
        return dw_int8_plain(x, w, bias, **kw_)
    req = _build.require
    req(x.device.type == "cuda", f"dw_int8: no kernel for device {x.device}")
    req(w.device == x.device and bias.device == x.device, "dw_int8: mixed devices")
    plan = dw_int8_check(x, w, bias, **kw_, plan=plan, sms=_sm_count(x.device))
    n, h, wd, c = x.shape
    kh = w.shape[0]
    oh, ow = dw_out_hw(h, wd, kh, stride, padding)
    out = torch.empty(
        (n, oh, ow, c), dtype=torch.int32 if epilogue == "int32" else torch.int8,
        device=x.device,
    )
    lib, fn = _build.kernel("dw_conv", "f8_dw_conv", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, h, wd, c, oh, ow, kh, stride, padding, plan.th, plan.tw, plan.cb, plan.rowb,
            plan.grid, pad_value, EPILOGUES[epilogue], net, int(out_signed), int(relu),
            _build.stream_of(x),
        )
    _build.check(lib, rc, "dw_int8")
    dw_int8.launches += 1
    return out


dw_int8.launches = 0
