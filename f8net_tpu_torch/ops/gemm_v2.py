"""K7: the persistent int8 GEMM with resident weights -- the port of
`f8net_tpu/ops/pallas_gemm_v2.py:int8_gemm_v2` (`:123-228`), as the CUDA
kernel `csrc/int8_gemm_v2.cu` (see its header for what bounds it on an H100
and what its design does about that).

Its contract is K1's (`ops/gemm.py`):

    y[M, N] = epilogue(x[M, K] @ w[K, N] + bias[N])

with the int32 and requant8 epilogues, optional ReLU, and unsigned results
stored as u - 128.  Its domain is narrower: K % 16 == 0 (16-byte cp.async
row slices), N % 4 == 0, and K <= 3328 (the K-deep weight slab of 64
columns lives in one block's shared memory) -- every pointwise conv of
ResNet-50 meets it.

`int8_gemm_v2` launches the kernel for CUDA tensors and raises on what it
does not take; for CPU tensors it runs K1's plain version,
`int8_gemm_plain`, which computes the same function.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .gemm import EPILOGUES, int8_gemm_plain

MAX_K = 3328  # 64 * (round_up(K, 64) + 16) + the 15 KB x ring <= 227 KB

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def int8_gemm_v2(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
    epilogue: str = "int32", net: int = 0, out_signed: bool = True, relu: bool = False,
) -> torch.Tensor:
    """K7 on the tensors' device: the CUDA kernel on a card, the plain
    version on the CPU."""
    if x.device.type == "cpu":
        return int8_gemm_plain(
            x, w, bias, epilogue=epilogue, net=net, out_signed=out_signed, relu=relu
        )
    req = _build.require
    req(x.device.type == "cuda", f"int8_gemm_v2: no kernel for device {x.device}")
    req(w.device == x.device and bias.device == x.device, "int8_gemm_v2: mixed devices")
    req(x.dtype == torch.int8 and w.dtype == torch.int8, "int8_gemm_v2: x and w must be int8")
    req(bias.dtype == torch.int32, "int8_gemm_v2: bias must be int32")
    req(x.ndim == 2 and w.ndim == 2 and x.shape[1] == w.shape[0], "int8_gemm_v2: shapes")
    M, K = x.shape
    N = w.shape[1]
    req(bias.shape == (N,), "int8_gemm_v2: bias shape")
    req(M > 0 and N > 0, "int8_gemm_v2: empty output")
    req(K > 0 and K % 16 == 0, f"int8_gemm_v2: needs K % 16 == 0, got {K}")
    req(K <= MAX_K, f"int8_gemm_v2: needs K <= {MAX_K}, got {K}")
    req(N % 4 == 0, f"int8_gemm_v2: needs N % 4 == 0, got {N}")
    req(x.is_contiguous() and w.is_contiguous() and bias.is_contiguous(),
        "int8_gemm_v2: contiguity")
    req(x.data_ptr() % 16 == 0 and w.data_ptr() % 4 == 0, "int8_gemm_v2: alignment")
    req(epilogue in EPILOGUES, f"int8_gemm_v2: unknown epilogue {epilogue!r}")
    req(-31 < net < 31, f"int8_gemm_v2: shift {net} out of range")
    out = torch.empty(
        (M, N), dtype=torch.int32 if epilogue == "int32" else torch.int8, device=x.device
    )
    lib, fn = _build.kernel("int8_gemm_v2", "f8_int8_gemm_v2", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), M, N, K,
            EPILOGUES[epilogue], net, int(out_signed), int(relu), _build.stream_of(x),
        )
        int8_gemm_v2.launches += 1
    _build.check(lib, rc, "int8_gemm_v2")
    return out


int8_gemm_v2.launches = 0
