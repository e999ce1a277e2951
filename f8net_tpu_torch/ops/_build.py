"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc for `sm_90a` into its own shared
library with a plain C interface, loaded with ctypes.  Libraries are named
by a digest of their source, of every header in `csrc/` and of the nvcc
flags, so a repeated run reuses what an earlier run built from the same
sources, and a changed source builds anew.  Builds go to `_build/` in the
package (listed in .gitignore), one nvcc per source, all started together.

Nothing here runs when the module is imported: a library is built or
loaded on the first launch of its kernel, or by `build_all`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
SOURCES = (
    "int8_gemm", "int8_conv", "stem_pool", "dw_conv", "ir_block", "int8_gemm_v2", "conv_flat",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the build log
)

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, tuple] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing or stale, one
    nvcc process per source, all started together.  Returns
    {name: nvcc output} for the sources it compiled; raises with that
    output if any compile fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        (BUILD_DIR / f"{name}.log").write_text(logs[name])
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def kernel(name: str, symbol: str, argtypes):
    """(library, C entry `symbol`) of csrc/<name>.cu, built on first use,
    with the entry's argument and return types declared once."""
    key = (name, symbol)
    found = _entries.get(key)
    if found is not None:
        return found
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            lib.f8_error_string.argtypes = [ctypes.c_int]
            lib.f8_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[key] = (lib, fn)
    return lib, fn


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel's C entry reported a CUDA error."""
    if code != 0:
        msg = lib.f8_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t) -> int:
    """The current CUDA stream of `t`'s device, as the C entries take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    """Validate a kernel argument: raise instead of launching on it."""
    if not cond:
        raise ValueError(msg)
