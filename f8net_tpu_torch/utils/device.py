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
