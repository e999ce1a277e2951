"""The port's CLI (`f8net_tpu_torch.run.main`, on the CPU) against the JAX
package's on the scenarios of tests/test_cli.py that train: train then
resume, in the quantized config and under floating_wo_clip, and the
bn-calibration phase.  Both start from the same weights (tests/
_cli_compare.py) and must print the same lines: the same words in the same
order, and the same numbers but where a train- or calib-mode QAT forward
makes them (chaotic at random init: their form alone is compared), and
under floating_wo_clip every number within 1% (two SGD steps of float32
sums in other orders, amplified by BatchNorm over 8 images; the step itself
is held tighter in tests/test_torch_train.py).  The checkpoints each CLI
writes load into the other package."""

import os

import numpy as np

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from _cli_compare import compare, run_both
from f8net_tpu.train import load_checkpoint as jax_load_checkpoint
from f8net_tpu_torch.train import load_checkpoint


def _trees_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


def test_cli_train_then_resume_matches_jax(tmp_path, monkeypatch):
    out = run_both(tmp_path, monkeypatch, runs=2)
    got = compare(out, exact=False)
    assert got.count("Start training.") == 2 and "layer name: head." in got
    assert "Loaded checkpoint RUN/log at epoch 1." in got
    for name in ("jax", "port"):
        latest = os.path.join(tmp_path, name, "log", "latest_checkpoint")
        trees, meta = load_checkpoint(latest)
        jtrees, jmeta = jax_load_checkpoint(latest)
        assert meta == jmeta and meta["last_epoch"] == 1 and _trees_equal(trees, jtrees)
        assert set(trees) == {"params", "state", "opt_momentum"}
        assert os.path.exists(os.path.join(tmp_path, name, "log", "best_model.npz"))


def test_cli_float_train_then_resume_matches_jax(tmp_path, monkeypatch):
    out = run_both(tmp_path, monkeypatch, runs=2, floating_wo_clip=True, lr=0.0005)
    got = compare(out, exact=False, rtol=1e-2)
    assert any(ln.startswith("T\ttrain\t0/1: loss: ") for ln in got)


def test_cli_bn_calib_phase_matches_jax(tmp_path, monkeypatch):
    out = run_both(tmp_path, monkeypatch, bn_calib_before_test=True, bn_calib_batch_num=1)
    got = compare(out, exact=False)
    assert "Start calibration." in got and any(ln.startswith("T\tcalib\t-1/1") for ln in got)
    assert os.path.exists(os.path.join(tmp_path, "port", "log", "best_model_bn_calibrated.npz"))
