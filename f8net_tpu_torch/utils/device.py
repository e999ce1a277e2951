"""Device selection for the port's entry points.

Entry points take `device=` and default to "cuda".  Asking for a card where
there is none raises: the port never falls back to the CPU on its own.  The
CPU runs only when the caller asks for it, as the tests do.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev


@contextlib.contextmanager
def float32_exact():
    """Within the block, float32 convolutions and matmuls on the card run in
    full float32, not TF32, whatever a caller set globally; the caller's
    settings come back on exit.  The QAT forward needs it: TF32 would move
    the batch statistics its fraclens come from."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


@contextlib.contextmanager
def tf32_conv():
    """Within the block, cuDNN convolutions may run on TF32 tensor cores,
    whatever the caller set (float32_exact included); the caller's setting
    comes back on exit.  The bf16-operand training conv
    (`nn.quant_layers.conv2d_bf16`) runs under it: its operands lie on
    bfloat16's grid, which TF32 holds exactly, so every product is exact
    and only the float32 accumulation rounds.  It switches the same legacy
    flag as float32_exact, never torch's newer precision settings, which
    some torch versions refuse to mix with it."""
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
