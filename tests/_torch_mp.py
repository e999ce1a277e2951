"""What tests/test_torch_tp.py, tests/test_torch_tp_overlap.py and
tests/test_torch_pp.py share: the port's bake of each family at 32 px
(Model.init, two train-mode forwards, the BN calibration's reset and two
calib-mode forwards, bake_plan), the same model, plan and
params on the JAX side, and one run of tests/_torch_tp_worker.py on four
gloo ranks."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_tp_worker import CFG, CLASSES, RUNG_KW, SIZE, model_of, plan_of
from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.quant.plan import LayerPlan as JaxLayerPlan
from f8net_tpu.quant.plan import QuantPlan as JaxQuantPlan
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu_torch.engine import IntEngine
from f8net_tpu_torch.quant import bake_plan, reset_bn_for_calib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, BATCH = 4, 8
JAX_THREADS = 3  # threads that compile the JAX references at once
RUNGS = tuple(RUNG_KW)
# the JAX reference's keywords per rung (its integer requant: f32_requant is
# a TPU exactness shortcut, bitwise the same, and not ported)
JAX_RUNG_KW = {"strict": {}, "int8": {"int8_boundary": True}, "bf16": {"bf16_boundary": True}}
# XLA may keep a bf16 value in float32 inside a fusion; the port's contract
# rounds every bf16 value where the engine's code says (tests/_rung_reference.py)
BF16_OPTIONS = {"xla_allow_excess_precision": False}


def port_bake(family, seed=0):
    """(plan records, {layer: {"w", "b"}} as numpy, images): the port's
    Model.init from a seed, two train-mode forwards on the images, the BN
    calibration (two calib-mode forwards on reset statistics) and
    bake_plan, at 32 px and 16 classes.  Without the calibration the
    MobileNets' logits come out the same for every image."""
    model = model_of(family)
    params, state = model.init(torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.RandomState(seed + 1)
    x = torch.from_numpy((np.round(255 * rng.rand(BATCH, SIZE, SIZE, 3)) / 256).astype(np.float32))
    for _ in range(2):
        _, state = model.apply(params, state, x, mode="train")
    state = reset_bn_for_calib(state)
    for _ in range(2):
        _, state = model.apply(params, state, x, mode="calib")
    plan, ip = bake_plan(model, params, state)
    records = [(p.name, p.input_fl, p.weight_fl, p.input_symmetric) for p in plan.layers]
    arrays = {k: {kk: v.numpy() for kk, v in d.items()} for k, d in ip.items()}
    return records, arrays, x.numpy()


def port_engine(family, records, arrays, rung):
    return IntEngine(model_of(family), plan_of(records),
                     {k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in arrays.items()},
                     device="cpu", **RUNG_KW[rung])


def port_logits(family, records, arrays, x, rung):
    """The port's single engine on the images: (conditioned input, logits)."""
    eng = port_engine(family, records, arrays, rung)
    xi = eng.condition_input(torch.from_numpy(x))
    return xi, eng(xi)


def jax_side(family, records, arrays):
    """The JAX model, plan and int params of the port's bake."""
    model = jax_get_model(family, JaxQuantConfig(**CFG), CLASSES, SIZE)
    plan = JaxQuantPlan(tuple(JaxLayerPlan(*r) for r in records))
    ip = {k: {kk: jnp.asarray(v) for kk, v in d.items()} for k, d in arrays.items()}
    return model, plan, ip


def compiled(fn, rung, *args):
    """fn jitted and run on args; the bf16 rung compiled with BF16_OPTIONS."""
    lowered = jax.jit(fn).lower(*args)
    options = BF16_OPTIONS if rung == "bf16" else None
    return np.asarray(lowered.compile(compiler_options=options)(*args))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(out, payload):
    """Writes the payload and starts tests/_torch_tp_worker.py on WORLD gloo
    ranks; returns a function that waits for them and gives each rank's
    results."""
    torch.save(payload, os.path.join(out, "cases.pt"))
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "_torch_tp_worker.py"),
                               str(port), str(r), str(WORLD), str(out)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]

    def wait():
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:  # exact-PID cleanup only
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                for r in range(WORLD)]

    return wait


def row_slice(t, mesh, rank):
    """The rows of a global batch that `rank`'s data row holds on a (data,
    model) mesh (parallel.shard_batch's contiguous slice)."""
    d, m = mesh
    per = t.shape[0] // d
    row = rank // m
    return t[row * per:(row + 1) * per]
