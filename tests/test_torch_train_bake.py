"""A checkpoint the JAX Trainer wrote, loaded and baked by the port.

The JAX Trainer takes two SGD steps of a ResNet-18 (32 px, batch 4, the
configs' fix_quant flags) and its `latest_checkpoint`-style npz is read by
the port's `load_checkpoint`.  The port's `bake_plan` on it gives JAX's
plan and int8 weights bitwise, and its int32 biases bitwise but where
XLA's float32 exp2 is inexact (2^13 and odd exponents above: a bias within
that much of a rounding tie lands one unit off in the JAX bake; the port
scales by the exact power of two -- tests/test_torch_bake.py).  The port's
strict IntEngine on the CPU gives the JAX engine's logits bit for bit on
the port's bake, and on JAX's own where the two bakes are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from f8net_tpu.engine import IntEngine as JaxIntEngine
from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.quant import bake_plan as jax_bake_plan
from f8net_tpu.train import Trainer as JaxTrainer
from f8net_tpu.train import save_checkpoint as jax_save_checkpoint
from f8net_tpu.train import sgd_init as jax_sgd_init
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu.utils.config import TrainConfig as JaxTrainConfig
from f8net_tpu_torch.engine import IntEngine
from f8net_tpu_torch.export import qat_from_numpy, qat_to_numpy, tensors_from_numpy
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.quant import bake_plan
from f8net_tpu_torch.train import load_checkpoint
from f8net_tpu_torch.utils import QuantConfig

CFG = dict(format_from_metric=True, metric="std", quant_bias=True, quant_avgpool=True,
           pool_fusing=True)


def _xla_exp2_misses(fl: int) -> bool:
    return float(jnp.exp2(jnp.float32(fl))) != 2.0**fl


def test_jax_trainer_checkpoint_bakes_in_the_port(tmp_path):
    model = get_model("resnet18", QuantConfig(**CFG), num_classes=10, image_size=32)
    params, state = qat_to_numpy(*model.init(torch.Generator().manual_seed(21), device="cpu"))
    jmodel = jax_get_model("resnet18", JaxQuantConfig(**CFG), 10, 32)
    tcfg = JaxTrainConfig(num_epochs=1, batch_size=4, lr=0.01, lr_scheduler="constant",
                          topk=(1,), num_classes=10)
    tr = JaxTrainer(jmodel, jmodel.cfg, tcfg, log=lambda *a: None)
    rng = np.random.RandomState(8)
    batches = [(jnp.asarray(rng.rand(4, 32, 32, 3).astype(np.float32)),
                jnp.asarray(rng.randint(0, 10, 4).astype(np.int32))) for _ in range(2)]
    jp, js = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state)
    jp, js, jopt, _ = tr.run_epoch(jp, js, jax_sgd_init(jp), batches, 0, 2, "train")
    path = jax_save_checkpoint(str(tmp_path / "latest_checkpoint"),
                               {"params": jp, "state": js, "opt_momentum": jopt.momentum},
                               meta={"last_epoch": 1, "best_val": 1.0})

    trees, meta = load_checkpoint(path)
    assert meta == {"last_epoch": 1, "best_val": 1.0}
    qp, qs = qat_from_numpy(trees["params"], trees["state"], device="cpu")
    mom = tensors_from_numpy(trees["opt_momentum"], device="cpu")
    assert float(mom["head"]["w"].abs().sum()) > 0  # two steps moved the momentum
    plan, ip = bake_plan(model, qp, qs)
    jplan, jip = jax_bake_plan(jmodel, jp, js)
    records = [(p.name, p.input_fl, p.weight_fl, p.input_symmetric) for p in plan.layers]
    assert records == [(p.name, p.input_fl, p.weight_fl, p.input_symmetric)
                       for p in jplan.layers]
    assert len({p.input_fl for p in plan.layers}) > 1  # the EMAs moved
    same = True
    for lname, entry in jip.items():
        np.testing.assert_array_equal(ip[lname]["w"].numpy(), np.asarray(entry["w"]), lname)
        got_b, want_b = ip[lname]["b"].numpy(), np.asarray(entry["b"])
        off = np.nonzero(got_b != want_b)[0]
        if len(off):
            same = False
            assert _xla_exp2_misses(plan[lname].out_fl), lname
            assert np.abs(got_b[off] - want_b[off]).max() == 1, lname

    x = rng.rand(4, 32, 32, 3).astype(np.float32)
    eng = IntEngine(model, plan, ip, device="cpu")
    got = eng(eng.condition_input(x)).numpy()
    assert not np.array_equal(got[0], got[1])
    port_ip = {k: {kk: jnp.asarray(v.numpy()) for kk, v in d.items()} for k, d in ip.items()}
    jeng = JaxIntEngine(jmodel, jplan, port_ip, int_only=True)
    np.testing.assert_array_equal(got, np.asarray(jeng(jeng.condition_input(jnp.asarray(x)))))
    if same:
        jeng = JaxIntEngine(jmodel, jplan, jip, int_only=True)
        np.testing.assert_array_equal(got, np.asarray(jeng(jeng.condition_input(jnp.asarray(x)))))
