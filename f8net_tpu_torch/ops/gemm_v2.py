"""K7: the persistent int8 GEMM -- the port of
`f8net_tpu/ops/pallas_gemm_v2.py:int8_gemm_v2` (`:123-228`), as the CUDA
kernel `csrc/int8_gemm_v2.cu` (wgmma on Hopper, fed by a producer warp; see
its header for what bounds it on an H100 and what its design does about
that).

Its contract is K1's (`ops/gemm.py`):

    y[M, N] = epilogue(x[M, K] @ w[K, N] + bias[N])

with the int32 and requant8 epilogues, optional ReLU, and unsigned results
stored as u - 128.  Its domain is narrower: K % 16 == 0 (16-byte cp.async
row slices), N % 4 == 0 (16-byte epilogue stores), and K <= MAX_K, the
domain of the resident-slab kernel this one replaced -- every pointwise conv
of ResNet-50 meets it.

`w` is a (K, N) int8 matrix (packed here, on every call) or the same
weights packed once by `pack_gemm_weight` into the kernel's operand layout
(K2's `PackedConvWeight` of a 1x1 conv; what `IntEngine` passes).
`plan_gemm` chooses the tile width, the persistent grid and, where the tiles
cannot fill the card, a split of the reduction across a cluster.

`int8_gemm_v2` launches the kernel for CUDA tensors and raises on what it
does not take; for CPU tensors it runs `int8_gemm_v2_plain`, which computes
from the packed layout when given packed weights.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build
from .conv import H100_SMS, MAX_SPLITS, SPLIT_MIN_STEPS, PackedConvWeight, _round_up, _sm_count
from .conv import pack_conv_weight, split_ranges, unpack_conv_weight
from .fxp import wrap_i32
from .gemm import EPILOGUES, epilogue_plain, int8_gemm_plain

MAX_K = 3328  # K7's domain since it was ported
MIN_N = 32  # narrower outputs fill under half of K7's 64-column tile: K1 wins there
BM = 128  # output rows per tile (csrc/int8_gemm_v2.cu kG2BM)
BK = 64  # reduction bytes per ring stage (kG2BK)


def takes(k: int, n: int) -> bool:
    """Whether a (., k) x (k, n) GEMM goes to K7: inside its domain (K % 16
    == 0, K <= MAX_K, N % 4 == 0) and at least MIN_N columns wide.  On an
    H100 K7 ran no slower than K1 at every pointwise conv of ResNet-50 and
    MobileNetV2 this admits, and slower at the two it does not (N = 16 and
    24; PERF.md section 6)."""
    return k % 16 == 0 and k <= MAX_K and n % 4 == 0 and n >= MIN_N


def pack_gemm_weight(w: torch.Tensor) -> PackedConvWeight:
    """(K, N) int8 weights -> K7's operand layout, on w's device: the
    PackedConvWeight of the 1x1 conv with those weights."""
    k, n = w.shape
    return pack_conv_weight(w.reshape(1, 1, k, n))


def unpack_gemm_weight(p: PackedConvWeight) -> torch.Tensor:
    """The (K, N) matrix a packed 1x1 weight holds."""
    return unpack_conv_weight(p).reshape(p.c, p.o)


class GemmPlan(NamedTuple):
    """K7's launch plan: tile width `bn`, padded columns `n_pad`, reduction
    steps `ksteps` (BK bytes each), `mtiles` x `ntiles` tiles of BM x bn,
    `splits` blocks per tile over the reduction (a cluster), and the
    `grid` of blocks (persistent when splits == 1)."""

    bn: int
    n_pad: int
    ksteps: int
    mtiles: int
    ntiles: int
    splits: int
    grid: int

    @property
    def tiles(self) -> int:
        return self.mtiles * self.ntiles


@functools.lru_cache(maxsize=None)
def plan_gemm(m: int, k: int, n: int, sms: int = H100_SMS) -> GemmPlan:
    """Plan a K7 call of an (m, k) x (k, n) product on a card with `sms` SMs
    (one persistent block per SM).

    Where 64-wide tiles give at least half as many tiles as SMs, the
    reduction is not split, and the tile width is the one whose persistent
    rounds move fewer stage bytes, ceil(tiles / sms) x (BM + bn) -- a tie
    goes to 128 (fewer epilogues, each A stage feeding twice the columns).
    Otherwise (few rows, ResNet-50's stages 2-3 at batch 8) 128-wide tiles
    split the reduction into the largest power of two <= MAX_SPLITS that
    keeps one block per SM and SPLIT_MIN_STEPS steps per block, one cluster
    per tile; where that is 1, 64-wide tiles, unsplit."""
    n_pad = _round_up(n, 64)
    ksteps = -(-k // BK)
    mtiles = -(-m // BM)
    widths = (64, 128) if n_pad % 128 == 0 else (64,)
    if 2 * mtiles * (n_pad // 64) >= sms:
        bn = min(widths, key=lambda b: (-(-mtiles * (n_pad // b) // sms) * (BM + b), -b))
        tiles = mtiles * (n_pad // bn)
        return GemmPlan(bn, n_pad, ksteps, mtiles, n_pad // bn, 1, min(tiles, sms))
    bn = widths[-1]
    tiles = mtiles * (n_pad // bn)
    splits = MAX_SPLITS
    while splits > 1 and (tiles * splits > sms or ksteps // splits < SPLIT_MIN_STEPS):
        splits //= 2
    if splits == 1:
        tiles = mtiles * (n_pad // 64)
        return GemmPlan(64, n_pad, ksteps, mtiles, n_pad // 64, 1, min(tiles, sms))
    return GemmPlan(bn, n_pad, ksteps, mtiles, n_pad // bn, splits, tiles * splits)


def gemm_acc_packed(x: torch.Tensor, wp: PackedConvWeight, k_range=None) -> torch.Tensor:
    """x @ w from the packed layout, plain: the exact int64 accumulators
    (M, N), over reduction bytes [lo, hi) only when `k_range` = (lo, hi) is
    given.  The product runs in float64, exact for |acc| < 2^53."""
    kp16, n_pad, _ = wp.data.shape
    a = F.pad(x.to(torch.float64), (0, kp16 * 16 - x.shape[1]))
    b = wp.data.permute(0, 2, 1).reshape(kp16 * 16, n_pad).to(torch.float64)
    if k_range is not None:
        lo, hi = k_range
        a, b = a[:, lo:hi], b[lo:hi]
    return torch.matmul(a, b)[:, : wp.o].to(torch.int64)


def int8_gemm_v2_plain(
    x: torch.Tensor, w, bias: torch.Tensor, *, epilogue: str = "int32", net: int = 0,
    out_signed: bool = True, relu: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of K7.  A (K, N) matrix: K1's plain version.  A
    packed weight: the product from the packed layout (gemm_acc_packed)."""
    if isinstance(w, PackedConvWeight):
        return epilogue_plain(gemm_acc_packed(x, w), bias, epilogue, net, out_signed, relu)
    return int8_gemm_plain(x, w, bias, epilogue=epilogue, net=net, out_signed=out_signed,
                           relu=relu)


def int8_gemm_v2_split_plain(
    x: torch.Tensor, wp: PackedConvWeight, bias: torch.Tensor, plan: GemmPlan, *,
    epilogue: str = "int32", net: int = 0, out_signed: bool = True, relu: bool = False,
) -> torch.Tensor:
    """K7's split-K arithmetic, plain: one int32 partial per split over the
    plan's reduction steps, the partials added with int32 wraparound, then
    the epilogue once on the whole sum."""
    acc = torch.zeros((x.shape[0], wp.o), dtype=torch.int64)
    for lo, hi in split_ranges(plan):
        part = wrap_i32(gemm_acc_packed(x, wp, k_range=(lo * BK, hi * BK)))
        acc = wrap_i32(acc + part.to(torch.int64)).to(torch.int64)
    return epilogue_plain(acc, bias, epilogue, net, out_signed, relu)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


def int8_gemm_v2_check(
    x: torch.Tensor, w, bias: torch.Tensor, *, epilogue: str = "int32", net: int = 0,
    out_signed: bool = True, relu: bool = False, plan: Optional[GemmPlan] = None,
    sms: int = H100_SMS,
):
    """What int8_gemm_v2 checks before it launches the kernel -- dtypes,
    shapes, the kernel's domain, the plan (plan_gemm's on a card of `sms`
    SMs where none is given), layout and alignment -- on tensors of any
    device; raises ValueError where the kernel does not take the call.
    Returns (packed weight, plan)."""
    req = _build.require
    req(x.dtype == torch.int8, "int8_gemm_v2: x must be int8")
    req(bias.dtype == torch.int32, "int8_gemm_v2: bias must be int32")
    if isinstance(w, torch.Tensor):
        req(w.dtype == torch.int8 and w.ndim == 2, "int8_gemm_v2: w must be a (K, N) int8 matrix")
        w = pack_gemm_weight(w)
    req(isinstance(w, PackedConvWeight) and w.kh == 1 and w.kw == 1,
        "int8_gemm_v2: w must be (K, N) or a PackedConvWeight of a 1x1 conv")
    req(x.ndim == 2 and x.shape[1] == w.c, "int8_gemm_v2: shapes")
    M, K = x.shape
    N = w.o
    req(bias.shape == (N,), "int8_gemm_v2: bias shape")
    req(M > 0 and N > 0, "int8_gemm_v2: empty output")
    req(K > 0 and K % 16 == 0, f"int8_gemm_v2: needs K % 16 == 0, got {K}")
    req(K <= MAX_K, f"int8_gemm_v2: needs K <= {MAX_K}, got {K}")
    req(N % 4 == 0, f"int8_gemm_v2: needs N % 4 == 0, got {N}")
    req(epilogue in EPILOGUES, f"int8_gemm_v2: unknown epilogue {epilogue!r}")
    req(-31 < net < 31, f"int8_gemm_v2: shift {net} out of range")
    if plan is None:
        plan = plan_gemm(M, K, N, sms)
    tiles = -(-M // BM) * (plan.n_pad // max(plan.bn, 1))
    req(plan.bn in (64, 128) and plan.n_pad == _round_up(N, 64) and plan.n_pad % plan.bn == 0
        and plan.ksteps == -(-K // BK) and 1 <= plan.splits <= MAX_SPLITS
        and plan.ksteps >= plan.splits and plan.grid >= 1
        and (plan.splits == 1 or plan.grid == tiles * plan.splits),
        "int8_gemm_v2: the plan does not fit the call")
    wdata = w.data
    req(
        wdata.dtype == torch.int8 and tuple(wdata.shape) == (plan.ksteps * BK // 16, plan.n_pad, 16),
        f"int8_gemm_v2: packed weight data {tuple(wdata.shape)} {wdata.dtype} does not match "
        f"K={K} N={N}",
    )
    req(x.is_contiguous() and wdata.is_contiguous() and bias.is_contiguous(),
        "int8_gemm_v2: contiguity")
    req(x.data_ptr() % 16 == 0 and wdata.data_ptr() % 16 == 0 and bias.data_ptr() % 16 == 0,
        "int8_gemm_v2: alignment")
    return w, plan


def int8_gemm_v2(
    x: torch.Tensor, w, bias: torch.Tensor, *,
    epilogue: str = "int32", net: int = 0, out_signed: bool = True, relu: bool = False,
    plan: Optional[GemmPlan] = None,
) -> torch.Tensor:
    """K7 on the tensors' device: the CUDA kernel on a card, the plain
    version on the CPU.  `w` is (K, N) (packed here, on every call) or a
    PackedConvWeight of a 1x1 conv (packed once by the caller).  `plan`
    overrides plan_gemm's (to measure or test another one)."""
    epi = dict(epilogue=epilogue, net=net, out_signed=out_signed, relu=relu)
    if x.device.type == "cpu":
        if plan is not None:
            wp = w if isinstance(w, PackedConvWeight) else pack_gemm_weight(w)
            return int8_gemm_v2_split_plain(x, wp, bias, plan, **epi)
        return int8_gemm_v2_plain(x, w, bias, **epi)
    req = _build.require
    req(x.device.type == "cuda", f"int8_gemm_v2: no kernel for device {x.device}")
    req(w.device == x.device and bias.device == x.device, "int8_gemm_v2: mixed devices")
    w, plan = int8_gemm_v2_check(x, w, bias, **epi, plan=plan, sms=_sm_count(x.device))
    wdata = w.data
    M, K = x.shape
    N = w.o
    out = torch.empty(
        (M, N), dtype=torch.int32 if epilogue == "int32" else torch.int8, device=x.device
    )
    lib, fn = _build.kernel("int8_gemm_v2", "f8_int8_gemm_v2", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), wdata.data_ptr(), bias.data_ptr(), out.data_ptr(), M, N, K,
            plan.n_pad, plan.bn, plan.ksteps, plan.splits, plan.grid,
            EPILOGUES[epilogue], net, int(out_signed), int(relu), _build.stream_of(x),
        )
    _build.check(lib, rc, "int8_gemm_v2")
    int8_gemm_v2.launches += 1
    return out


int8_gemm_v2.launches = 0
