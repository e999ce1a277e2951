"""Runs one CLI scenario through the JAX package's `f8net_tpu.run.main` and
the port's `f8net_tpu_torch.run.main` (on the CPU) and splits what each
printed into comparable lines.

Both runs read the same YAML but for their log directories, and start from
the same weights: the port's `Model.init` written as an npz checkpoint and
named as `fp_pretrained_file` (random inits of the two packages cannot be
matched draw for draw).  Both Loaders are held on their PIL paths (their
native paths are held against each other in tests/test_torch_data.py).
"""

import contextlib
import io
import os
import re

import torch
import yaml

import f8net_tpu.native as jax_native
from f8net_tpu import run as jax_cli
from f8net_tpu_torch import native as port_native
from f8net_tpu_torch import run as port_cli
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.train import save_checkpoint
from f8net_tpu_torch.utils.flags import from_flags

BASE = {
    "dataset": "synthetic",
    "synthetic_size": 16,
    "num_classes": 5,
    "image_size": 32,
    "num_epochs": 1,
    "lr": 0.01,
    "lr_scheduler": "constant",
    "batch_size": 8,
    "data_loader_workers": 1,
    "topk": [1],
    "model": "models.fix_resnet",
    "depth": 18,
    "weight_format": [8, 7],
    "input_format": [8, 6],
    "format_from_metric": True,
    "metric": "std",
    "momentum": 0.9,
    "weight_decay": 0.0,
    "nesterov": True,
    "random_seed": 7,
    "experiment_subdir": False,
}

_NUMBER = re.compile(r"-?\d+(?:\.\d*)?(?:e[-+]?\d+)?")


def split(line: str):
    """(the line with every number replaced by '#', its numbers)."""
    return _NUMBER.sub("#", line), [float(v) for v in _NUMBER.findall(line)]


def run_both(tmp_path, monkeypatch, runs: int = 1, **over):
    """Each package's CLI `runs` times on the scenario's config; returns
    {'jax': lines, 'port': lines}, each run's phase timings ("1.2s") and
    its own directory replaced by fixed tokens."""
    monkeypatch.setattr(jax_native, "imageops_available", lambda: False)
    monkeypatch.setattr(port_native, "imageops_available", lambda: False)
    flags = dict(BASE, **over)
    cfg, tcfg, extras = from_flags(flags, flags["batch_size"])
    model = get_model(f"resnet{flags['depth']}", cfg, num_classes=tcfg.num_classes,
                      image_size=tcfg.image_size)
    params, state = model.init(torch.Generator().manual_seed(0), device="cpu")
    init = save_checkpoint(str(tmp_path / "init"), {"params": params, "state": state})
    out = {}
    for name, main in (("jax", jax_cli.main),
                       ("port", lambda argv: port_cli.main(argv, device="cpu"))):
        root = str(tmp_path / name)
        d = dict(flags, log_dir=os.path.join(root, "log"), fp_pretrained_file=init)
        if "int_op_only_file_path" in d:
            d["int_op_only_file_path"] = os.path.join(root, "export")
        path = os.path.join(str(tmp_path), f"{name}.yml")
        with open(path, "w") as f:
            yaml.safe_dump(d, f)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            for _ in range(runs):
                main([f"app:{path}", f"bs:{flags['batch_size']}"])
        text = buf.getvalue().replace(root, "RUN")
        out[name] = [re.sub(r"^\d+\.\ds\t", "T\t", ln) for ln in text.splitlines()]
    return out


# lines whose numbers come out of a train- or calib-mode QAT forward: at
# random init that forward is chaotic end to end (one ulp of input moves the
# reference's own logits by more than a tenth), so two packages agree on
# their form and not their digits
CHAOTIC = ("T\ttrain", "T\tval", "T\tcalib", "New best", "alpha:", "master layer alpha:",
           "fix scaling:", "following layer fix scaling:", "input_fraclen:", "weight_fraclen:")


def compare(out, exact: bool = True, rtol: float = 0.0):
    """The port's lines against the JAX CLI's: the same lines in the same
    order with the same words; their numbers equal (`exact`), equal within
    `rtol` relative, or -- without either -- equal but on the lines of
    CHAOTIC."""
    got, want = out["port"], out["jax"]
    assert [split(ln)[0] for ln in got] == [split(ln)[0] for ln in want]
    for g, w in zip(got, want):
        gn, wn = split(g)[1], split(w)[1]
        if exact:
            assert gn == wn, (g, w)
        elif rtol:
            assert all(abs(a - b) <= rtol * max(abs(b), 1e-3) for a, b in zip(gn, wn)), (g, w)
        elif not g.startswith(CHAOTIC):
            assert gn == wn, (g, w)
    return got
