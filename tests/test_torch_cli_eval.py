"""The port's CLI (`f8net_tpu_torch.run.main`, on the CPU) against the JAX
package's on the scenarios of tests/test_cli.py that do not train the QAT
forward from random numbers alone: test_only and the int_op_only phase
print exactly the JAX CLI's lines (the eval forward, the bake and the
integer engine agree bit for bit), and training on a JPEG ImageFolder tree
prints the same lines in form (tests/_cli_compare.py)."""

import os

import numpy as np
from PIL import Image

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from _cli_compare import compare, run_both
from f8net_tpu.train import load_checkpoint as jax_load_checkpoint
from f8net_tpu_torch.train import load_checkpoint

INT = dict(quant_bias=True, quant_avgpool=True, pool_fusing=True, int_infer=True,
           int_op_only=True, test_only=True, int_op_only_file_path="export")


def test_cli_test_only_matches_jax(tmp_path, monkeypatch):
    got = compare(run_both(tmp_path, monkeypatch, test_only=True), exact=True)
    assert any(ln.startswith("T\ttest\t-1/1: loss: ") for ln in got)
    assert sum(ln.startswith("weight_fraclen:") for ln in got) == 21


def test_cli_int_op_only_matches_jax(tmp_path, monkeypatch):
    got = compare(run_both(tmp_path, monkeypatch, **INT), exact=True)
    assert "Converted model saved to RUN/export." in got
    assert any(ln.startswith("test\t-1/1: top1_error: ") for ln in got)
    path = os.path.join(tmp_path, "{}", "export", "checkpoints", "int_op_only_model")
    trees, meta = load_checkpoint(path.format("port"))
    jtrees, jmeta = jax_load_checkpoint(path.format("jax"))
    assert meta == jmeta and len(meta["plan"]) == 21
    for lname, sub in jtrees["int_params"].items():
        for k, v in sub.items():
            assert trees["int_params"][lname][k].dtype == v.dtype
            np.testing.assert_array_equal(trees["int_params"][lname][k], v)


def test_cli_train_on_jpeg_imagefolder_matches_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    for split, n in (("train", 20), ("val", 10)):
        for i in range(n):
            d = os.path.join(tmp_path, "data", split, f"c{i % 5}")
            os.makedirs(d, exist_ok=True)
            Image.fromarray(rng.randint(0, 256, (48, 56, 3), np.uint8)).save(
                os.path.join(d, f"i{i:03d}.jpg"), quality=80)
    got = compare(run_both(tmp_path, monkeypatch, dataset="imagenet1k",
                           dataset_dir=os.path.join(tmp_path, "data"), synthetic_size=None),
                  exact=False)
    assert "Start training." in got and "layer name: head." in got
