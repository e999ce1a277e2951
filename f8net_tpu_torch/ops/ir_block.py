"""K5: a whole MobileNetV2 inverted-residual block -- 1x1 expand, requant,
KxK depthwise at stride 1, requant, 1x1 project, optional aligned residual
add -- in one kernel.  The port of
`f8net_tpu/ops/pallas_ir_block.py:fused_ir_block` (`:249-329`) in every
form the Pallas kernel has -- int32, requant8 or bf16 output; no carry, an
int32 carry, or a packed 1-byte carry widened by `carry_add_offset` -- as
the CUDA kernel `csrc/ir_block.cu` (see its header for what bounds it on an
H100 and what its design does about that).

Junction math, bit for bit the Pallas kernel's (`_ir_kernel` `:121-217`):
  1. e = x8 . w1 + b1 (int32, wrapping); x8 packed on the expand's grid and
     b1 zero-point-compensated for that packing;
  2. e is requantized by `net1` onto the depthwise input's grid, whose clamp
     absorbs the ReLU, and kept UNPACKED (0..255 or -127..127);
  3. the depthwise runs on those values with true-zero padding and the plain
     bias bd;
  4. its result is requantized by `net2` and packed for the project;
  5. y = d8 . w2 + b2 (int32, wrapping; b2 zero-point-compensated);
  6. with a carry: the carry widened to int32 plus `carry_add_offset` (0,
     or 128 for a 1-byte carry packed on an unsigned grid as u - 128), then
     (y << shift_res) + (carry << shift_carry) with int32 wraparound, then a
     clip to +-INT32_MAX;
  7. an int32 output, requant8 by `net_out` (`out_signed`), or the real
     value in bf16 at fraclen `out_fl` (ops.fxp.to_real_bf16: int32 ->
     float32 -> bfloat16, rounding twice).

The int32 carry and output serve the strict rung; the 1-byte carry and the
requant8 output after a carry serve the int8-boundary rung; the bf16 output
serves the bf16-boundary rung.

w1 (cin, ce) and w2 (ce, cout) are int8 matrices (packed here, on every
call) or the same weights packed once by `ops.gemm_v2.pack_gemm_weight`
into the kernel's operand layout (what `IntEngine` passes).  `plan_ir`
chooses the kernel's band height and its split of the expanded channels
across a cluster, and lays out its shared memory.

`fused_ir_block` launches the kernel for CUDA tensors and raises on what it
does not take; for CPU tensors it runs `fused_ir_block_plain`, which
computes from the packed layouts when given packed weights.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build
from .conv import H100_SMS, MAX_SPLITS, PackedConvWeight, _round_up, _sm_count
from .fxp import INT32_MAX, requant_net, to_real_bf16, wrap_i32
from .gemm import int8_gemm_plain
from .gemm_v2 import gemm_acc_packed, pack_gemm_weight

SMEM_LIMIT = 232448  # one block's dynamic shared memory (csrc/mma_tile.cuh kMaxSmem)
SM_SMEM = 233472  # shared memory of one SM; each resident block also takes 1 KB
BLOCKS_PER_SM = 2  # csrc/ir_block.cu __launch_bounds__(256, 2)
# The planner's time model, in ns: a fixed cost per wave of blocks (launch
# share, copies' latency, barriers), and per block wgmma multiply-adds,
# depthwise multiply-adds on the CUDA cores, bytes from L2 and partial-sum
# bytes read across the cluster, at per-SM rates; blocks that share an SM
# overlap half their work.  The constants were fitted to the H100 times of
# every plan probe_plans.py tries at MobileNetV2's K5 calls (PERF.md
# section 6); they only rank plans.
_FIXED_NS, _TC_MAC_NS, _DW_MAC_NS, _L2_B_NS, _DSMEM_B_NS = 250.0, 500.0, 200.0, 40.0, 25.0
_OVERLAP = 0.5
# K5's output forms and their dtypes, in the order csrc/ir_block.cu numbers them
OUTPUTS = {"int32": torch.int32, "requant8": torch.int8, "bf16": torch.bfloat16}
CARRY_OFFSETS = (0, 128)


class IrPlan(NamedTuple):
    """K5's launch plan: output rows per band `th` (`bands` per image),
    `splits` blocks per band (one cluster) each taking `cs` expanded
    channels, the padded reductions and widths of the two products, the
    x copy width `xvec`, and the shared-memory layout: the rows per 16-byte
    chunk of the two products' A operands (`ld_x`, `ld_d`: the rows rounded
    up to 64, plus 1 so that neighbouring chunks start on other banks), the
    partial's row stride in bytes (`ld_p`), the bytes of one carry element
    (`carry_bytes`: 0 without a carry, 1 or 4) and byte offsets (the
    project's partial `o_p` overlays the expand's buffers)."""

    th: int
    bands: int
    splits: int
    cs: int
    cin_k: int
    ce_pad: int
    cout32: int
    cout_pad: int
    xvec: int
    ld_x: int
    ld_d: int
    ld_p: int
    carry_bytes: int
    o_w2: int
    o_d: int
    o_wd: int
    o_bd: int
    o_b1: int
    o_b2: int
    o_c: int
    o_x: int
    o_w1: int
    o_e: int
    o_p: int
    total: int


def _r128(v: int) -> int:
    return _round_up(v, 128)


def _layout(h, w, cin, ce, cout, k, th, splits, cs, carry_bytes=4) -> IrPlan:
    pad = (k - 1) // 2
    cin_k, cout32 = _round_up(cin, 32), _round_up(cout, 32)
    ld_x = _round_up(min(th + 2 * pad, h) * w, 64) + 1
    mp = min(th, h) * w
    ld_d = _round_up(mp, 64) + 1
    ld_p = cout32 * 4 + 32  # 8-byte fragment stores free of bank conflicts
    o_w2 = 0
    o_d = _r128(o_w2 + cs * cout32)
    o_wd = _r128(o_d + ld_d * cs)
    o_bd = _r128(o_wd + k * k * cs)
    o_b1 = o_bd + 4 * cs
    o_b2 = o_b1 + 4 * cs
    o_c = _r128(o_b2 + 4 * cout)  # this block's share of the carry rows
    o_x = _r128(o_c + -(-mp // splits) * cout * carry_bytes)
    o_w1 = _r128(o_x + ld_x * cin_k)
    o_e = _r128(o_w1 + cin_k * cs)
    end_e = o_e + (th + 2 * pad) * (w + 2 * pad) * cs
    total = max(end_e, o_x + mp * ld_p)
    xvec = 16 if cin % 16 == 0 else 8 if cin % 8 == 0 else 4
    return IrPlan(
        th, -(-h // th), splits, cs, cin_k, _round_up(ce, 64), cout32, _round_up(cout, 64), xvec,
        ld_x, ld_d, ld_p, carry_bytes, o_w2, o_d, o_wd, o_bd, o_b1, o_b2, o_c, o_x, o_w1, o_e, o_x, total,
    )


def _block_ns(h, w, cin, cout, k, plan: IrPlan, out_bytes: int) -> float:
    """The planner's model of one block's work, without the fixed cost (the
    largest band); the larger of the carry's and the output's bytes per
    element stands for both."""
    pad = (k - 1) // 2
    me = min(plan.th + 2 * pad, h) * w
    mp = min(plan.th, h) * w
    cs = plan.cs
    tc = (-(-me // 64) * 64 * plan.cin_k * cs + -(-mp // 64) * 64 * cs * plan.cout32)
    dw = mp * cs * k * k
    io = max(out_bytes, plan.carry_bytes)
    l2 = me * cin + plan.cin_k * cs + cs * plan.cout32 + mp * cout * io // plan.splits
    red = mp * plan.cout32 * 4 if plan.splits > 1 else 0
    return tc / _TC_MAC_NS + dw / _DW_MAC_NS + l2 / _L2_B_NS + red / _DSMEM_B_NS


def ir_candidates(h, w, cin, ce, cout, k, carry_bytes=4):
    """Every plan plan_ir weighs: each band height th (1 .. h) that makes
    other bands than th - 1, each split of Ce into slices of a multiple of
    32 channels (1 .. MAX_SPLITS, each non-empty) that makes other slices
    than a smaller split, whose layout fits one block's shared memory."""
    units = _round_up(ce, 32) // 32
    for th in range(1, h + 1):
        if th > 1 and -(-h // (th - 1)) == -(-h // th):
            continue  # the same bands as th - 1, with more padding
        for s in range(1, min(MAX_SPLITS, units) + 1):
            su = -(-units // s)
            if -(-units // su) != s:
                continue  # the same slices as a smaller s
            plan = _layout(h, w, cin, ce, cout, k, th, s, 32 * su, carry_bytes)
            if plan.total <= SMEM_LIMIT:
                yield plan


@functools.lru_cache(maxsize=None)
def plan_ir(n: int, h: int, w: int, cin: int, ce: int, cout: int, k: int,
            sms: int = H100_SMS, carry_bytes: int = 4, out_bytes: int = 4) -> IrPlan:
    """Plan a K5 call on a card with `sms` SMs, with a carry of
    `carry_bytes` per element (0: none) and an output of `out_bytes`
    (`call_bytes` gives both for a call): of ir_candidates, the plan with
    the least modelled time of the busiest SM: the fixed cost once per wave
    of the blocks that fit on it together, and the work of each block
    (_block_ns), of which blocks on one SM overlap the fraction _OVERLAP.
    Ties go to fewer blocks."""
    best = None
    for plan in ir_candidates(h, w, cin, ce, cout, k, carry_bytes):
        per_sm = min(BLOCKS_PER_SM, SM_SMEM // (plan.total + 1024))
        blocks = n * plan.bands * plan.splits
        on_sm = -(-blocks // sms)
        waves = -(-on_sm // per_sm)
        work = _block_ns(h, w, cin, cout, k, plan, out_bytes)
        t = waves * _FIXED_NS + ((1 - _OVERLAP) * on_sm + _OVERLAP * waves) * work
        key = (t, blocks)
        if best is None or key < best[0]:
            best = (key, plan)
    if best is None:
        raise ValueError(f"K5: no plan fits one block's shared memory at {h}x{w}, "
                         f"cin {cin}, ce {ce}, cout {cout}")
    return best[1]


def call_bytes(carry: Optional[torch.Tensor], out: str) -> tuple:
    """(carry bytes per element, 0 without one; output bytes per element)
    of a K5 call: what plan_ir and _layout take."""
    return (0 if carry is None else carry.element_size()), OUTPUTS[out].itemsize


def ir_bands(plan: IrPlan, h: int):
    """[(first row, end row)] of each band's output rows."""
    return [(b * plan.th, min((b + 1) * plan.th, h)) for b in range(plan.bands)]


def ir_slices(plan: IrPlan, ce: int):
    """[(first channel, end channel)] of each block's slice of Ce, as the
    kernel computes them (channels past ce carry zero weights)."""
    ce32 = _round_up(ce, 32)
    return [(q * plan.cs, min((q + 1) * plan.cs, ce32)) for q in range(plan.splits)]


def _expand_plain(x2: torch.Tensor, w1, b1: torch.Tensor) -> torch.Tensor:
    if isinstance(w1, PackedConvWeight):
        return wrap_i32(gemm_acc_packed(x2, w1) + b1.to(torch.int64))
    return int8_gemm_plain(x2, w1, b1)


def ir_block_operands_plain(
    x: torch.Tensor, w1, b1: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor, *,
    net1: int = 0, dw_in_signed: bool = False, net2: int = 0, proj_in_signed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Steps 1-4 of the junction math, plainly: the depthwise's 8-bit input
    UNPACKED (int32, 0..255 or -127..127) and the project's 8-bit input
    packed (int8), both (n, h, w, ce).  w1 is (cin, ce) or packed.  The
    depthwise runs in float64 on the unpacked values (exact: |acc| <= k*k *
    255 * 128, far below 2^53)."""
    n, h, w, cin = x.shape
    kh, kw, ce = wd.shape
    e = _expand_plain(x.reshape(-1, cin), w1, b1)
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


def _project_acc(d8: torch.Tensor, w2, k_range=None) -> torch.Tensor:
    """d8 (pixels, ce) . w2 as exact int64, over channels [lo, hi) only when
    `k_range` is given (w2 packed)."""
    if isinstance(w2, PackedConvWeight):
        return gemm_acc_packed(d8, w2, k_range)
    return torch.matmul(d8.to(torch.float64), w2.to(torch.float64)).to(torch.int64)


def _finish(y: torch.Tensor, carry, out, net_out, out_signed, shift_res, shift_carry, out_fl,
            carry_add_offset):
    """Steps 6-7 on the wrapped int32 project output y (n, h, w, cout)."""
    if carry is not None:
        c = carry.to(torch.int64) + carry_add_offset
        y = wrap_i32((y.to(torch.int64) << shift_res) + (c << shift_carry))
        y = y.clamp(-INT32_MAX, INT32_MAX)
    if out == "int32":
        return y.contiguous()
    if out == "bf16":
        return to_real_bf16(y, out_fl).contiguous()
    if out != "requant8":
        raise ValueError(f"unknown output {out!r}")
    r = requant_net(y, net_out, 8, out_signed)
    if not out_signed:
        r = r - 128
    return r.to(torch.int8).contiguous()


def fused_ir_block_plain(
    x: torch.Tensor, w1, b1: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor,
    w2, b2: torch.Tensor, carry: Optional[torch.Tensor] = None, *,
    net1: int = 0, dw_in_signed: bool = False, net2: int = 0, proj_in_signed: bool = False,
    out: str = "int32", net_out: int = 0, out_signed: bool = False, shift_res: int = 0,
    shift_carry: int = 0, out_fl: int = 0, carry_add_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of K5: `ir_block_operands_plain`, then the
    project (from the packed layout when w2 is packed), the carry add and
    the output epilogue."""
    n, h, w, _ = x.shape
    ce = wd.shape[2]
    _, d8 = ir_block_operands_plain(
        x, w1, b1, wd, bd, net1=net1, dw_in_signed=dw_in_signed, net2=net2,
        proj_in_signed=proj_in_signed,
    )
    y = wrap_i32(_project_acc(d8.reshape(-1, ce), w2) + b2.to(torch.int64))
    return _finish(y.reshape(n, h, w, -1), carry, out, net_out, out_signed, shift_res,
                   shift_carry, out_fl, carry_add_offset)


def fused_ir_block_split_plain(
    x: torch.Tensor, w1: PackedConvWeight, b1: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor,
    w2: PackedConvWeight, b2: torch.Tensor, carry: Optional[torch.Tensor], plan: IrPlan, *,
    net1: int = 0, dw_in_signed: bool = False, net2: int = 0, proj_in_signed: bool = False,
    out: str = "int32", net_out: int = 0, out_signed: bool = False, shift_res: int = 0,
    shift_carry: int = 0, out_fl: int = 0, carry_add_offset: int = 0,
) -> torch.Tensor:
    """K5's arithmetic as the plan splits it, plain: each band's expand and
    depthwise from its own input rows and halo (zero outside the image), one
    int32 partial project per slice of Ce over that slice's rows of w2, the
    partials added with int32 wraparound, + b2, then the carry add and the
    epilogue once on the whole sum."""
    n, h, w, _ = x.shape
    k, ce = wd.shape[0], wd.shape[2]
    pad = (k - 1) // 2
    kw_ = dict(net1=net1, dw_in_signed=dw_in_signed, net2=net2, proj_in_signed=proj_in_signed)
    ys = []
    for r0, r1 in ir_bands(plan, h):
        lo, hi = max(r0 - pad, 0), min(r1 + pad, h)
        _, d8 = ir_block_operands_plain(x[:, lo:hi], w1, b1, wd, bd, **kw_)
        d8 = d8[:, r0 - lo: r1 - lo].reshape(-1, ce)
        acc = torch.zeros((d8.shape[0], w2.o), dtype=torch.int64)
        for c0, c1 in ir_slices(plan, ce):
            part = wrap_i32(_project_acc(d8, w2, k_range=(c0, c1)))
            acc = wrap_i32(acc + part.to(torch.int64)).to(torch.int64)
        ys.append(wrap_i32(acc + b2.to(torch.int64)).reshape(n, r1 - r0, w, -1))
    return _finish(torch.cat(ys, dim=1), carry, out, net_out, out_signed, shift_res, shift_carry,
                   out_fl, carry_add_offset)


# the C entry's IrParams fields, in order (csrc/ir_block.cu)
_PARAMS = (
    "n", "h", "w", "cin", "ce", "cout", "k", "pad",
    "th", "cs", "splits", "cin_k", "ce_pad", "cout32", "cout_pad", "xvec",
    "net1", "dw_in_signed", "net2", "proj_in_signed", "epilogue", "net_out", "out_signed",
    "shift_res", "shift_carry", "out_fl", "carry_add_offset", "ld_x", "ld_d", "ld_p",
    "carry_bytes",
    "o_w2", "o_d", "o_wd", "o_bd", "o_b1", "o_b2", "o_c", "o_x", "o_w1", "o_e", "o_p", "total",
)
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=1024)
def _param_array(plan: IrPlan, shape: tuple, junction: tuple):
    """The C entry's IrParams as a ctypes int array, built once per (plan,
    shape, junction formats): the engine makes the same twelve calls every
    forward."""
    n, h, w, cin, ce, cout, k = shape
    names = ("net1", "dw_in_signed", "net2", "proj_in_signed", "epilogue", "net_out",
             "out_signed", "shift_res", "shift_carry", "out_fl", "carry_add_offset")
    fields = dict(plan._asdict(), n=n, h=h, w=w, cin=cin, ce=ce, cout=cout, k=k,
                  pad=(k - 1) // 2, **dict(zip(names, junction)))
    return (ctypes.c_int * len(_PARAMS))(*(fields[f] for f in _PARAMS))


def _packed_1x1(w, rows: int, cols: int, what: str):
    """w as a packed 1x1 weight of (rows, cols), packing a plain matrix."""
    req = _build.require
    if isinstance(w, torch.Tensor):
        req(w.dtype == torch.int8 and tuple(w.shape) == (rows, cols),
            f"fused_ir_block: {what} must be a ({rows}, {cols}) int8 matrix")
        return pack_gemm_weight(w)
    req(isinstance(w, PackedConvWeight) and w.kh == 1 and w.kw == 1 and (w.c, w.o) == (rows, cols),
        f"fused_ir_block: {what} must be ({rows}, {cols}) or its packed 1x1 weight")
    want = (_round_up(rows, 64) // 16, _round_up(cols, 64), 16)
    req(w.data.dtype == torch.int8 and tuple(w.data.shape) == want and w.data.is_contiguous(),
        f"fused_ir_block: packed weight data {tuple(w.data.shape)} {w.data.dtype} does not "
        f"match {what} ({rows}, {cols})")
    return w


def fused_ir_block_check(
    x: torch.Tensor, w1, b1: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor,
    w2, b2: torch.Tensor, carry: Optional[torch.Tensor] = None, *,
    net1: int = 0, dw_in_signed: bool = False, net2: int = 0, proj_in_signed: bool = False,
    out: str = "int32", net_out: int = 0, out_signed: bool = False, shift_res: int = 0,
    shift_carry: int = 0, out_fl: int = 0, carry_add_offset: int = 0,
    plan: Optional[IrPlan] = None, sms: int = H100_SMS,
):
    """What fused_ir_block checks before it launches the kernel -- dtypes,
    shapes, the kernel's domain, the plan (plan_ir's on a card of `sms` SMs
    where none is given), layout and alignment -- on tensors of any device;
    raises ValueError where the kernel does not take the call.  Returns
    (packed w1, packed w2, plan)."""
    req = _build.require
    ins = (x, w1, b1, wd, bd, w2, b2) + ((carry,) if carry is not None else ())
    req(x.dtype == torch.int8 and wd.dtype == torch.int8, "fused_ir_block: x, wd: int8")
    req(all(t.dtype == torch.int32 for t in (b1, bd, b2)), "fused_ir_block: b1, bd, b2: int32")
    req(carry is None or carry.dtype in (torch.int32, torch.int8),
        "fused_ir_block: carry: int32 or int8 (packed, 1 byte)")
    req(carry_add_offset in CARRY_OFFSETS and (carry is not None or carry_add_offset == 0),
        f"fused_ir_block: carry_add_offset {carry_add_offset} (0, or 128 with a carry)")
    req(x.ndim == 4 and wd.ndim == 3, "fused_ir_block: ranks")
    n, h, w, cin = x.shape
    kh, kw, ce = wd.shape
    cout = b2.shape[0] if b2.ndim == 1 else -1
    w1 = _packed_1x1(w1, cin, ce, "w1")
    w2 = _packed_1x1(w2, ce, cout, "w2")
    req(b1.shape == (ce,) and bd.shape == (ce,), "fused_ir_block: bias shapes")
    req(carry is None or tuple(carry.shape) == (n, h, w, cout), "fused_ir_block: carry shape")
    req(kh == kw and kh % 2 == 1, f"fused_ir_block: needs a square odd kernel, got {kh}x{kw}")
    req(
        cin % 4 == 0 and ce % 4 == 0 and cout % 4 == 0,
        f"fused_ir_block: needs channels % 4 == 0, got {cin}, {ce}, {cout}",
    )
    req(out in OUTPUTS, f"fused_ir_block: unknown output {out!r}")
    cb, ob = call_bytes(carry, out)
    if plan is None:
        plan = plan_ir(n, h, w, cin, ce, cout, kh, sms, cb, ob)
    else:
        req(plan == _layout(h, w, cin, ce, cout, kh, plan.th, plan.splits, plan.cs, cb)
            and 0 < plan.splits <= MAX_SPLITS and plan.cs % 32 == 0
            and plan.splits == -(-_round_up(ce, 32) // plan.cs) and plan.total <= SMEM_LIMIT,
            "fused_ir_block: the plan does not fit the call")
    tensors = (x, w1.data, b1, wd, bd, w2.data, b2) + ins[7:]
    req(all(t.is_contiguous() for t in tensors), "fused_ir_block: contiguity")
    req(
        x.data_ptr() % plan.xvec == 0 and all(t.data_ptr() % 4 == 0 for t in tensors)
        and all(t.data_ptr() % 16 == 0 for t in (w1.data, w2.data) + ins[7:]),
        "fused_ir_block: alignment",
    )
    req(all(-31 < s < 31 for s in (net1, net2, net_out)), "fused_ir_block: shift out of range")
    req(0 <= shift_res < 32 and 0 <= shift_carry < 32, "fused_ir_block: carry shift out of range")
    req(0 <= out_fl < 100, f"fused_ir_block: out_fl {out_fl} out of range")
    return w1, w2, plan


def fused_ir_block(
    x: torch.Tensor, w1, b1: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor,
    w2, b2: torch.Tensor, carry: Optional[torch.Tensor] = None, *,
    net1: int = 0, dw_in_signed: bool = False, net2: int = 0, proj_in_signed: bool = False,
    out: str = "int32", net_out: int = 0, out_signed: bool = False, shift_res: int = 0,
    shift_carry: int = 0, out_fl: int = 0, carry_add_offset: int = 0,
    plan: Optional[IrPlan] = None,
) -> torch.Tensor:
    """K5 on the tensors' device: the CUDA kernel on a card, the plain
    version on the CPU.  `carry` is int32, or int8 (a 1-byte operand
    packed for the block's expand, widened by `carry_add_offset`); `out_fl`
    is the bf16 output's fraclen.  `plan` overrides plan_ir's (to measure
    or test another one)."""
    kw_ = dict(
        net1=net1, dw_in_signed=dw_in_signed, net2=net2, proj_in_signed=proj_in_signed,
        out=out, net_out=net_out, out_signed=out_signed, shift_res=shift_res,
        shift_carry=shift_carry, out_fl=out_fl, carry_add_offset=carry_add_offset,
    )
    if x.device.type == "cpu":
        if plan is not None:
            p1 = w1 if isinstance(w1, PackedConvWeight) else pack_gemm_weight(w1)
            p2 = w2 if isinstance(w2, PackedConvWeight) else pack_gemm_weight(w2)
            return fused_ir_block_split_plain(x, p1, b1, wd, bd, p2, b2, carry, plan, **kw_)
        return fused_ir_block_plain(x, w1, b1, wd, bd, w2, b2, carry, **kw_)
    req = _build.require
    ins = (x, w1, b1, wd, bd, w2, b2) + ((carry,) if carry is not None else ())
    req(x.device.type == "cuda", f"fused_ir_block: no kernel for device {x.device}")
    req(all(t.device == x.device for t in ins), "fused_ir_block: mixed devices")
    w1, w2, plan = fused_ir_block_check(x, w1, b1, wd, bd, w2, b2, carry, **kw_, plan=plan,
                                        sms=_sm_count(x.device))
    n, h, w, cin = x.shape
    kh, kw, ce = wd.shape
    cout = b2.shape[0]
    y = torch.empty((n, h, w, cout), dtype=OUTPUTS[out], device=x.device)
    params = _param_array(
        plan, (n, h, w, cin, ce, cout, kh),
        (net1, int(dw_in_signed), net2, int(proj_in_signed), list(OUTPUTS).index(out), net_out,
         int(out_signed), shift_res, shift_carry, out_fl, carry_add_offset),
    )
    lib, fn = _build.kernel("ir_block", "f8_ir_block", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), w1.data.data_ptr(), b1.data_ptr(), wd.data_ptr(), bd.data_ptr(),
            w2.data.data_ptr(), b2.data_ptr(), None if carry is None else carry.data_ptr(),
            y.data_ptr(), params, len(_PARAMS), _build.stream_of(x),
        )
    _build.check(lib, rc, "fused_ir_block")
    fused_ir_block.launches += 1
    return y


fused_ir_block.launches = 0
