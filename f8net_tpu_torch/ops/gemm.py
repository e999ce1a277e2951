"""K1: int8 GEMM with int32 accumulation and a fused requant epilogue --
the port of `f8net_tpu/ops/pallas_gemm.py:int8_gemm` (`:121-198`), as the
CUDA kernel `csrc/int8_gemm.cu` (see its header for what bounds it on an
H100 and what its design does about that).

    y[M, N] = epilogue(x[M, K] @ w[K, N] + bias[N])

x and w are int8, K % 4 == 0.  Unsigned activations arrive packed as s8 = u8 - 128, with
the compensation 128 * colsum(w) already folded into the int32 bias.
Epilogues:
  'int32'    -> the int32 accumulator (+ bias, + optional ReLU)
  'requant8' -> int8 at the consumer's fraclen: shift by `net` with
                round-half-to-even, clamp to the signed or unsigned 8-bit
                range, unsigned stored as u - 128 (`out_signed` False)

`int8_gemm` launches the kernel for CUDA tensors and raises on what it does
not take; for CPU tensors it runs `int8_gemm_plain`, the plain PyTorch
version that the tests and `chip_smoke.py` hold the kernel against.
"""

from __future__ import annotations

import ctypes
import torch

from . import _build
from .fxp import requant_net, wrap_i32

EPILOGUES = {"int32": 0, "requant8": 1}


def epilogue_plain(
    acc: torch.Tensor, bias: torch.Tensor, epilogue: str, net: int, out_signed: bool,
    relu: bool,
) -> torch.Tensor:
    """Plain form of csrc/requant.cuh: `acc` is the exact product as int64;
    bias add wrapping in int32, optional ReLU, then int32 or requant8."""
    y = wrap_i32(acc + bias.to(torch.int64))
    if relu:
        y = y.clamp_min(0)
    if epilogue == "int32":
        return y
    if epilogue != "requant8":
        raise ValueError(f"unknown epilogue {epilogue!r}")
    r = requant_net(y, net, 8, out_signed)
    if not out_signed:
        r = r - 128
    return r.to(torch.int8)


def int8_gemm_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *, epilogue: str = "int32",
    net: int = 0, out_signed: bool = True, relu: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of K1.  The product runs in float64, exact
    here: |acc| <= K * 128 * 127 < 2^53 for any K below 5e11."""
    acc = torch.matmul(x.to(torch.float64), w.to(torch.float64)).to(torch.int64)
    return epilogue_plain(acc, bias, epilogue, net, out_signed, relu)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def int8_gemm(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
    epilogue: str = "int32", net: int = 0, out_signed: bool = True, relu: bool = False,
) -> torch.Tensor:
    """K1 on the tensors' device: the CUDA kernel on a card, the plain
    version on the CPU."""
    if x.device.type == "cpu":
        return int8_gemm_plain(
            x, w, bias, epilogue=epilogue, net=net, out_signed=out_signed, relu=relu
        )
    req = _build.require
    req(x.device.type == "cuda", f"int8_gemm: no kernel for device {x.device}")
    req(w.device == x.device and bias.device == x.device, "int8_gemm: mixed devices")
    req(x.dtype == torch.int8 and w.dtype == torch.int8, "int8_gemm: x and w must be int8")
    req(bias.dtype == torch.int32, "int8_gemm: bias must be int32")
    req(x.ndim == 2 and w.ndim == 2 and x.shape[1] == w.shape[0], "int8_gemm: shapes")
    M, K = x.shape
    N = w.shape[1]
    req(bias.shape == (N,), "int8_gemm: bias shape")
    req(K > 0 and K % 4 == 0, f"int8_gemm: needs K % 4 == 0, got {K}")
    req(x.is_contiguous() and w.is_contiguous() and bias.is_contiguous(), "int8_gemm: contiguity")
    vec_a = 16 if K % 16 == 0 else 4  # bytes per load of an x row in the kernel
    req(x.data_ptr() % vec_a == 0 and w.data_ptr() % 4 == 0, "int8_gemm: alignment")
    req(epilogue in EPILOGUES, f"int8_gemm: unknown epilogue {epilogue!r}")
    req(-31 < net < 31, f"int8_gemm: shift {net} out of range")
    out = torch.empty(
        (M, N), dtype=torch.int32 if epilogue == "int32" else torch.int8, device=x.device
    )
    lib, fn = _build.kernel("int8_gemm", "f8_int8_gemm", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), M, N, K,
            vec_a, EPILOGUES[epilogue], net, int(out_signed), int(relu), _build.stream_of(x),
        )
        int8_gemm.launches += 1
    _build.check(lib, rc, "int8_gemm")
    return out


int8_gemm.launches = 0
