"""ctypes bindings of the native image operations (the port of the
`libimageops.so` half of `f8net_tpu/native/bindings.py:151-312`).

`csrc/imageops.cc` in this package (a copy of the JAX package's
`csrc/imageops.cc`) holds threaded bilinear resize, crop, flip and
normalize, and a libjpeg decode that runs on native threads without the
GIL.  It is built with g++ on first use, with the flags of the JAX
package's `csrc/Makefile`, into `_build/` in the package (listed in
.gitignore), under a name keyed by a digest of the source and the flags
(`ops/_build.py`'s naming and compile step): a changed source builds
anew, an unchanged one is loaded again.  The
compilers tried, in order: $CXX, g++ and c++ on the PATH, /usr/bin/g++
(a toolchain on the PATH may lack OpenMP's files, which -fopenmp needs);
the first that builds the library is used.  The decode links libjpeg only
where both its header and its linkable library exist (the Makefile's
JPEG_OK); elsewhere the library is built with F8NET_NO_JPEG and
`jpeg_available()` is False.

Nothing here runs when the module is imported.  `imageops_available()`
builds and loads the library and says whether that worked, as the
reference's does; `load()` raises with the compiler's output instead.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops import _build

SOURCE = _build.CSRC / "imageops.cc"
# csrc/Makefile:2's CXXFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread", "-fopenmp")

_lock = threading.Lock()
_state: dict = {}  # "lib": the loaded CDLL, or "error": why it could not be built


def compilers() -> list:
    """The C++ compilers to try, in order, each once."""
    found = [os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++"), "/usr/bin/g++"]
    out = []
    for c in found:
        if c and os.access(c, os.X_OK) and c not in out:
            out.append(c)
    return out


def _jpeg_ok(cxx: str) -> bool:
    """csrc/Makefile's JPEG_OK: libjpeg's development symlink is in the
    linker cache and its header preprocesses."""
    ldconfig = shutil.which("ldconfig") or "/sbin/ldconfig"
    try:
        cache = subprocess.run([ldconfig, "-p"], capture_output=True, text=True).stdout
    except OSError:
        return False
    if not any(line.strip().startswith("libjpeg.so ") for line in cache.splitlines()):
        return False
    header = subprocess.run([cxx, "-E", "-x", "c++", "-", "-include", "jpeglib.h"],
                            input="", capture_output=True, text=True)
    return header.returncode == 0


def library_path(jpeg_flag: str) -> Path:
    """The library's name: a digest of the flags, the JPEG choice ("-ljpeg"
    or "-DF8NET_NO_JPEG") and the source (not of the compiler's path)."""
    return _build.digest_path("imageops", (*CXX_FLAGS, jpeg_flag), [SOURCE])


def load() -> ctypes.CDLL:
    """The library, built on first use.  Raises RuntimeError with the
    compiler's output if it cannot be built or loaded."""
    with _lock:
        if "lib" in _state:
            return _state["lib"]
        if "error" in _state:
            raise RuntimeError(_state["error"])
        try:
            _state["lib"] = _build_and_load()
        except (RuntimeError, OSError) as e:
            _state["error"] = f"libimageops: {e}"
            raise RuntimeError(_state["error"]) from e
        return _state["lib"]


def _build_and_load() -> ctypes.CDLL:
    failures = []
    for cxx in compilers():
        jpeg = "-ljpeg" if _jpeg_ok(cxx) else "-DF8NET_NO_JPEG"
        path = library_path(jpeg)
        if not path.exists():
            command = lambda tmp: [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), jpeg]
            ok, log = _build.finish_build(*_build.start_build(command, path), path)
            if not ok:
                failures.append(f"{cxx} failed:\n{log}")
                continue
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        return lib
    raise RuntimeError("\n".join(failures) or "no C++ compiler found: the native image path "
                       "needs g++")


_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32a = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32a = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8a = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_c = ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    lib.train_preprocess_batch.argtypes = [
        ctypes.POINTER(_u8p), _i32a, _i32a, _u8a, _c, _c, _c, _f32a, _f32a, _f32a, _c, _c,
    ]
    lib.train_preprocess_batch.restype = None
    lib.eval_preprocess_batch.argtypes = [
        ctypes.POINTER(_u8p), _i32a, _c, _c, _c, _c, _f32a, _f32a, _f32a, _c, _c,
    ]
    lib.eval_preprocess_batch.restype = None
    lib.jpeg_support.argtypes = []
    lib.jpeg_support.restype = ctypes.c_int
    lib.jpeg_dims_batch.argtypes = [
        ctypes.POINTER(_u8p), ctypes.POINTER(ctypes.c_long), _c, _i32a, _i32a, _i32a, _i32a,
    ]
    lib.jpeg_dims_batch.restype = None
    lib.jpeg_decode_batch.argtypes = [
        ctypes.POINTER(_u8p), ctypes.POINTER(ctypes.c_long), _c, _i32a, ctypes.POINTER(_u8p),
        _i32a, _i32a, _i32a, _c,
    ]
    lib.jpeg_decode_batch.restype = None


def _lib_or_none() -> Optional[ctypes.CDLL]:
    try:
        return load()
    except RuntimeError:
        return None


def imageops_available() -> bool:
    """Whether the library builds and loads on this host."""
    return _lib_or_none() is not None


def jpeg_available() -> bool:
    """Whether the library decodes JPEG (it was linked with libjpeg)."""
    lib = _lib_or_none()
    return lib is not None and bool(lib.jpeg_support())


def _image_pointers(images):
    """(contiguous uint8 copies or views, kept alive by the caller; their
    pointers; (n, 2) int32 heights and widths)."""
    images = [np.ascontiguousarray(im, np.uint8) for im in images]
    for im in images:
        if im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"images are HWC RGB uint8, got shape {im.shape}")
    ptrs = (_u8p * len(images))(*[im.ctypes.data_as(_u8p) for im in images])
    dims = np.array([[im.shape[0], im.shape[1]] for im in images], np.int32).reshape(-1, 2)
    return images, ptrs, dims


def _mean_std(mean, std):
    do_norm = int(mean is not None)
    mean = np.ascontiguousarray(mean if mean is not None else np.zeros(3), np.float32)
    std = np.ascontiguousarray(std if std is not None else np.ones(3), np.float32)
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError("mean and std are 3 per-channel values")
    return mean, std, do_norm


def c_train_preprocess_batch(images, boxes, flips, size: int, mean=None, std=None,
                             num_threads: int = 4) -> np.ndarray:
    """images: uint8 HWC arrays; boxes: (n, 4) int32 (y0, x0, h, w); flips:
    (n,) uint8 -> (n, size, size, 3) float32 (crop -> antialiased resize ->
    flip -> [0, 1] or normalized)."""
    lib = load()
    n = len(images)
    images, ptrs, dims = _image_pointers(images)
    boxes = np.ascontiguousarray(boxes, np.int32).reshape(-1, 4)
    flips = np.ascontiguousarray(flips, np.uint8).reshape(-1)
    if boxes.shape[0] != n or flips.shape[0] != n:
        raise ValueError(f"{n} images need {n} boxes and flips")
    for (h, w), (y0, x0, ch, cw) in zip(dims, boxes):
        if not (0 <= y0 and 0 <= x0 and 0 < ch and 0 < cw and y0 + ch <= h and x0 + cw <= w):
            raise ValueError(f"crop box {(y0, x0, ch, cw)} outside a {h}x{w} image")
    out = np.empty((n, size, size, 3), np.float32)
    mean, std, do_norm = _mean_std(mean, std)
    lib.train_preprocess_batch(ptrs, dims.ravel(), boxes.ravel(), flips, n, 3, size,
                               out.ravel(), mean, std, do_norm, num_threads)
    return out


def c_eval_preprocess_batch(images, resize: int, size: int, mean=None, std=None,
                            num_threads: int = 4) -> np.ndarray:
    """images: uint8 HWC arrays of any sizes -> (n, size, size, 3) float32
    (shorter side to `resize`, antialiased, then a center crop of `size`)."""
    lib = load()
    if size > resize:
        raise ValueError(f"crop {size} larger than the resized side {resize}")
    n = len(images)
    images, ptrs, dims = _image_pointers(images)
    out = np.empty((n, size, size, 3), np.float32)
    mean, std, do_norm = _mean_std(mean, std)
    lib.eval_preprocess_batch(ptrs, dims.ravel(), n, 3, resize, size, out.ravel(), mean, std,
                              do_norm, num_threads)
    return out


def _blob_pointers(blobs):
    bufs = [np.frombuffer(b, np.uint8) for b in blobs]
    ptrs = (_u8p * len(bufs))(*[b.ctypes.data_as(_u8p) for b in bufs])
    sizes = (ctypes.c_long * len(bufs))(*[len(b) for b in bufs])
    return bufs, ptrs, sizes


def _denoms(denoms, n: int) -> np.ndarray:
    dn = np.ascontiguousarray(denoms if denoms is not None else [1] * n, np.int32).reshape(-1)
    if dn.shape[0] != n or not np.isin(dn, (1, 2, 4, 8)).all():
        raise ValueError("one DCT scale denominator in {1, 2, 4, 8} per image")
    return dn


def c_jpeg_dims_batch(blobs, denoms=None):
    """Header-only (w, h, ok) per JPEG byte string, at each image's scale
    denominator (the native decoder's view)."""
    n = len(blobs)
    if n == 0:
        return []
    lib = load()
    bufs, ptrs, sizes = _blob_pointers(blobs)
    dn = _denoms(denoms, n)
    ws, hs, oks = (np.zeros(n, np.int32) for _ in range(3))
    lib.jpeg_dims_batch(ptrs, sizes, n, dn, ws, hs, oks)
    del bufs
    return [(int(ws[i]), int(hs[i]), bool(oks[i])) for i in range(n)]


def c_decode_jpeg_batch(blobs, denoms=None, num_threads: int = 4, dims=None):
    """Decode JPEG byte strings on native threads, without the GIL.

    denoms: optional per-image DCT scale denominator in {1, 2, 4, 8}
    (libjpeg's scaled decode).  dims: optional [(w, h, ok)] from
    c_jpeg_dims_batch at the same denoms, which skips a second header
    parse.  Returns uint8 HWC RGB arrays, None where the native
    decoder cannot decode the image (the caller falls back to PIL)."""
    n = len(blobs)
    if n == 0:
        return []
    lib = load()
    bufs, ptrs, sizes = _blob_pointers(blobs)
    dn = _denoms(denoms, n)
    if dims is not None:
        if len(dims) != n:
            raise ValueError(f"{len(dims)} dims for {n} images")
        ws = np.asarray([d[0] for d in dims], np.int32)
        hs = np.asarray([d[1] for d in dims], np.int32)
        oks = np.asarray([int(d[2]) for d in dims], np.int32)
    else:
        ws, hs, oks = (np.zeros(n, np.int32) for _ in range(3))
        lib.jpeg_dims_batch(ptrs, sizes, n, dn, ws, hs, oks)
    outs = [np.empty((int(hs[i]), int(ws[i]), 3), np.uint8) if oks[i] else None
            for i in range(n)]
    optrs = (_u8p * n)(*[o.ctypes.data_as(_u8p) if o is not None else _u8p() for o in outs])
    dec_oks = np.array(oks)  # the decode clears the images it rejects
    lib.jpeg_decode_batch(ptrs, sizes, n, dn, optrs, ws, hs, dec_oks, num_threads)
    del bufs
    return [outs[i] if (oks[i] and dec_oks[i]) else None for i in range(n)]
