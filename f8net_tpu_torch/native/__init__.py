"""Native (C++) image operations for the data Loader's fast path."""

from .imageops import (
    c_decode_jpeg_batch,
    c_eval_preprocess_batch,
    c_jpeg_dims_batch,
    c_train_preprocess_batch,
    imageops_available,
    jpeg_available,
)
