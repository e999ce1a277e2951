"""The port's native image operations (`f8net_tpu_torch.native`, built from
its own `csrc/imageops.cc` into `f8net_tpu_torch/_build/`) bitwise against
the JAX package's bindings (`f8net_tpu.native`, over `csrc/libimageops.so`):
train and eval preprocessing with and without mean and std, JPEG decode at
DCT scale denominators 1, 2 and 4, JPEG dims, and the decoder's refusal of
a file it cannot decode."""

import io

import numpy as np
import pytest
from PIL import Image

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

import f8net_tpu.native as jax_native
from f8net_tpu_torch import native
from f8net_tpu_torch.native import imageops
from f8net_tpu_torch.ops import _build

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3), np.uint8)
            for h, w in ((50, 37), (33, 61), (120, 90), (375, 500))]


def _jpegs(images, quality=85, mode="RGB"):
    """JPEG files of the images; mode "CMYK" gives files the native decoder
    rejects (PIL decodes them)."""
    blobs = []
    for im in images:
        buf = io.BytesIO()
        Image.fromarray(im).convert(mode).save(buf, "JPEG", quality=quality)
        blobs.append(buf.getvalue())
    return blobs


def test_library_builds_from_the_ports_source():
    """The library is the port's own build: keyed by a digest of its source
    and flags under f8net_tpu_torch/_build/, the copy of csrc/imageops.cc
    byte for byte, with libjpeg where the host has it (as here)."""
    assert native.imageops_available() and native.jpeg_available()
    lib = imageops.load()
    build_dir = _build.BUILD_DIR
    assert build_dir.name == "_build" and build_dir.parent.name == "f8net_tpu_torch"
    assert lib._name.startswith(str(build_dir / "imageops-"))
    assert imageops._jpeg_ok(imageops.compilers()[0])
    assert "-fopenmp" in imageops.CXX_FLAGS and "-march=native" in imageops.CXX_FLAGS
    assert lib._name == str(imageops.library_path("-ljpeg"))
    with open(imageops.SOURCE, "rb") as a, open(jax_native.bindings._CSRC + "/imageops.cc", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("normalize", [False, True])
def test_preprocess_equals_jax(normalize):
    mean, std = (MEAN, STD) if normalize else (None, None)
    images = _images()
    boxes = np.array([[1, 2, 30, 20], [0, 0, 33, 61], [10, 5, 60, 80], [20, 100, 300, 280]],
                     np.int32)
    flips = np.array([0, 1, 1, 0], np.uint8)
    for size in (24, 32):
        got = native.c_train_preprocess_batch(images, boxes, flips, size, mean, std)
        want = jax_native.c_train_preprocess_batch(images, boxes, flips, size, mean, std)
        assert got.shape == (4, size, size, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        got = native.c_eval_preprocess_batch(images, int(size * 256 / 224), size, mean, std,
                                             num_threads=3)
        want = jax_native.c_eval_preprocess_batch(images, int(size * 256 / 224), size, mean, std,
                                                  num_threads=3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("denom", [1, 2, 4])
def test_jpeg_decode_and_dims_equal_jax(denom):
    blobs = _jpegs(_images(1)) + [b"junk", _jpegs(_images(2), mode="CMYK")[3]]
    denoms = [denom] * len(blobs)
    dims = native.c_jpeg_dims_batch(blobs, denoms)
    assert dims == jax_native.c_jpeg_dims_batch(blobs, denoms)
    assert [ok for _, _, ok in dims] == [True] * 4 + [False, False]
    for reuse in (None, dims):
        got = native.c_decode_jpeg_batch(blobs, denoms, num_threads=2, dims=reuse)
        want = jax_native.c_decode_jpeg_batch(blobs, denoms, num_threads=2, dims=reuse)
        assert [g is None for g in got] == [w is None for w in want]
        assert got[4] is None and got[5] is None  # junk, a CMYK file
        for g, w, (wd, ht, _) in zip(got[:4], want[:4], dims):
            assert g.shape == (ht, wd, 3)
            np.testing.assert_array_equal(g, w)
    if denom == 1:  # the exact decode is PIL's (both libjpeg)
        np.testing.assert_array_equal(got[0], np.asarray(Image.open(io.BytesIO(blobs[0]))))


def test_bindings_refuse_bad_arguments():
    images = _images()[:2]
    with pytest.raises(ValueError, match="boxes"):
        native.c_train_preprocess_batch(images, np.zeros((1, 4), np.int32), [0, 0], 8)
    with pytest.raises(ValueError, match="outside"):
        native.c_train_preprocess_batch(images, [[0, 0, 51, 10], [0, 0, 4, 4]], [0, 0], 8)
    with pytest.raises(ValueError, match="HWC"):
        native.c_eval_preprocess_batch([np.zeros((4, 4), np.uint8)], 9, 8)
    with pytest.raises(ValueError, match="larger"):
        native.c_eval_preprocess_batch(images, 8, 9)
    with pytest.raises(ValueError, match="denominator"):
        native.c_jpeg_dims_batch([b"x"], [3])
    with pytest.raises(ValueError, match="dims"):
        native.c_decode_jpeg_batch([b"x"], dims=[])
    assert native.c_decode_jpeg_batch([]) == [] and native.c_jpeg_dims_batch([]) == []
