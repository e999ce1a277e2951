"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc for `sm_90a` into its own shared
library with a plain C interface, loaded with ctypes.  Libraries are named
by a digest of their source, of every header in `csrc/` and of the nvcc
flags, so a repeated run reuses what an earlier run built from the same
sources, and a changed source builds anew.  Builds go to `_build/` in the
package (listed in .gitignore), one nvcc per source, all started together.

Nothing here runs when the module is imported: a library is built or
loaded on the first launch of its kernel, or by `build_all`.  The naming
and the compile into a temporary file that replaces nothing until it has
succeeded (`digest_path`, `start_build`, `finish_build`) also build the
native image library (`native/imageops.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Tuple

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


def digest_path(stem: str, flags: Iterable[str], sources: Iterable[Path]) -> Path:
    """`_build/<stem>-<digest>.so`, the digest taken over the flags and
    each source's name and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def start_build(command: Callable[[Path], List[str]], out: Path):
    """Starts the compile `command(tmp)` into a temporary file beside
    `out`, named by this process (concurrent builds each write their
    own); returns (process, tmp) for finish_build."""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(command(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def finish_build(proc, tmp: Path, out: Path) -> Tuple[bool, str]:
    """Waits for a start_build's compile; moves its output onto `out`
    (atomically) where it succeeded.  Returns (succeeded, its output)."""
    log = proc.communicate()[0]
    if proc.returncode == 0:
        os.replace(tmp, out)
    else:
        tmp.unlink(missing_ok=True)
    return proc.returncode == 0, log


def library_path(name: str) -> Path:
    return digest_path(name, NVCC_FLAGS, sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"])


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing or stale, one
    nvcc process per source, all started together.  Returns
    {name: nvcc output} for the sources it compiled; raises with that
    output if any compile fails."""
    nvcc = None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        src = CSRC / f"{name}.cu"
        procs[name] = (*start_build(lambda tmp: [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                    out), out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        ok, logs[name] = finish_build(proc, tmp, out)
        (BUILD_DIR / f"{name}.log").write_text(logs[name])
        if not ok:
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
