"""The port's data parallelism in two processes on the CPU (gloo), held
against the port in one process and against the JAX package.

tests/_torch_dist_worker.py runs every scenario on each of two ranks (each
rank its shard of seeded global batches) and saves what it computed; the
tests here read both ranks' results:
  * the group helpers: init_dist (a second call a no-op), ranks, master_only,
    all_reduce_metrics;
  * the global statistics (metric_fn's std, mae and rms, per layer and per
    channel; fraclen_gridsearch; the BN moments) against one process on the
    whole tensor;
  * a floating_wo_clip train step of a ResNet-18 at 16 px, global batch 16,
    against the port's one-process step and against JAX's make_train_step
    over Mesh(data=2) on the same global batch, with the limits of
    tests/test_torch_train.py::test_float_train_step_matches_jax;
  * the QAT step's fraclen EMAs equal to one process's, layer by layer, and
    its BN state within a stated limit, in train and calib modes (the QAT
    forward is chaotic end to end: it is not compared whole);
  * both ranks' params, state and momentum bitwise equal after every step;
  * the CLI under two ranks: rank 0 alone writes and prints, the resume
    loads the same tensors on both ranks, both end with equal params, the
    int phase reduces its counts, and under use_diff_seed the ranks' shards
    partition the dataset -- where the JAX CLI's overlap (property (b)).
"""

import inspect
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)
import _torch_dist_worker as worker

import f8net_tpu.data as jax_data
import f8net_tpu.parallel.dist as jax_dist
import f8net_tpu.run as jax_run
from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.parallel import batch_sharding, make_mesh
from f8net_tpu.train import loop as jax_loop
from f8net_tpu.train import optim as jax_optim
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu.utils.config import TrainConfig as JaxTrainConfig
from f8net_tpu_torch import run as port_cli
from f8net_tpu_torch.data import SyntheticDataset
from f8net_tpu_torch.export import qat_to_numpy
from f8net_tpu_torch.ops import fxp
from f8net_tpu_torch.quant import reset_bn_for_calib
from f8net_tpu_torch.train import make_eval_step, make_train_step, sgd_init
from f8net_tpu_torch.train.checkpoint import load_checkpoint
from f8net_tpu_torch.utils import TrainConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
# the QAT step's BN running statistics, two processes against one, as a
# share of each tensor's largest element: the BN fold reads statistics
# summed in another order, which can move a folded weight across a
# rounding boundary and so a later layer's statistics by one quantization
# step of some elements (measured 2.1e-7 in train mode, 1.4e-7 in calib
# mode on these inputs)
QAT_BN_LIMIT = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results (tests/_torch_dist_worker.py)."""
    out = tmp_path_factory.mktemp("dist")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "_torch_dist_worker.py"),
                               str(port), str(r), str(WORLD), str(out)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:  # exact-PID cleanup only
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _same(a, b, what):
    """Two {layer: {name: tensor}} trees bitwise equal."""
    assert list(a) == list(b), what
    for lname, sub in a.items():
        for k, v in sub.items():
            assert torch.equal(v, b[lname][k]), f"{what}: {lname}/{k}"


def _close(got, want, rtol, what):
    """Each tensor within rtol of the reference tensor's largest element."""
    for lname, sub in want.items():
        for k, w in sub.items():
            w = np.asarray(w)
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(np.asarray(got[lname][k]), w, rtol=0, atol=rtol * scale,
                                       err_msg=f"{what}: {lname}/{k}")


def test_init_dist_ranks_and_reductions(ranks):
    """init_dist gives each process its rank (a second call returns it and
    joins nothing), master_only runs on rank 0 alone, all_reduce_metrics
    sums and averages a float and a tensor over the ranks."""
    for r, res in enumerate(ranks):
        assert res["rank"] == (r, r, r, WORLD, r == 0)
        assert res["master_only"] == ("ran" if r == 0 else None)
        assert res["metrics_sum"] == {"x": 3.0, "t": 4.0}
        assert res["metrics_mean"] == {"x": 1.5}


def test_global_statistics_equal_one_process(ranks):
    """Every metric over the global tensor, from its two shards, equal to
    the one-process metric of the whole tensor within float32 rounding, its
    fraclen equal; the grid search's fraclen and the BN moments (against
    float64 numpy) too; both ranks bitwise alike."""
    full = torch.from_numpy(worker.statistic_input())
    a, b = ranks[0]["stats"], ranks[1]["stats"]
    for name in worker.METRICS:
        for axes in ((0, 1, 2, 3), (0, 1, 2)):
            got, want = a[(name, axes)], fxp.metric_fn(name, axes)(full)
            assert torch.equal(got, b[(name, axes)])
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-7, err_msg=name)
            for signed in (True, False):
                assert torch.equal(fxp.metric2fraclen(got, name, 1.0, signed),
                                   fxp.metric2fraclen(want, name, 1.0, signed))
    for signed in (True, False):
        assert a[("grid", signed)] == fxp.fraclen_gridsearch(full, 8, 3, signed)
    mean, var, count = a["moments"]
    x = worker.statistic_input().astype(np.float64)
    assert float(count) == 8 * 5 * 5
    np.testing.assert_allclose(mean.numpy(), x.mean((0, 1, 2)), rtol=1e-13)
    np.testing.assert_allclose(var.numpy(), x.var((0, 1, 2)), rtol=1e-12)


def _one_process_step(cfg, seed=1):
    model, (params, state) = worker.init(cfg)
    p0 = {l: {k: v.clone() for k, v in sub.items()} for l, sub in params.items()}
    images, labels = worker.global_batch(seed)
    step = make_train_step(model, model.cfg, TrainConfig(**worker.TRAIN_KW))
    p, s, opt, m = step(params, state, sgd_init(params), torch.from_numpy(images),
                        torch.from_numpy(labels), 0.01)
    return p0, p, s, opt.momentum, {k: float(v) for k, v in m.items()}


def _jax_mesh_step(p0, state0, cfg):
    """JAX's jitted step with the global batch sharded over Mesh(data=2)."""
    pnp, snp = qat_to_numpy(p0, state0)
    jmodel = jax_get_model("resnet18", JaxQuantConfig(**cfg), worker.CLASSES, worker.SIZE)
    mesh = make_mesh(data=WORLD, model=1, devices=jax.devices()[:WORLD])
    repl, bsh = NamedSharding(mesh, P()), batch_sharding(mesh)
    images, labels = worker.global_batch(1)
    jstep = jax_loop.make_train_step(jmodel, jmodel.cfg, JaxTrainConfig(**worker.TRAIN_KW))
    jp = jax.device_put(jax.tree.map(jnp.asarray, pnp), repl)
    jp, js, jo, jm = jstep(jp, jax.device_put(jax.tree.map(jnp.asarray, snp), repl),
                           jax.device_put(jax_optim.sgd_init(jp), repl),
                           jax.device_put(jnp.asarray(images), bsh),
                           jax.device_put(jnp.asarray(labels), bsh), 0.01)
    return pnp, jp, js, jo.momentum, {k: float(v) for k, v in jm.items()}


def test_float_dp_step_matches_one_process_and_jax(ranks):
    """The floating_wo_clip step on two ranks against the port's one
    process and against JAX's mesh step on the same global batch: loss
    within 1e-5 relative, BN state within 1e-5 and each tensor's update
    and momentum within 1e-4 of their largest elements, the top-1 count
    and the global row count equal.  Measured against one process: 5.5e-7,
    9.8e-7, 3.8e-5 and 3.9e-5."""
    dp_p, dp_s, dp_m, dp_metrics = ranks[0]["float_steps"][0]
    p0, p, s, mom, metrics = _one_process_step(worker.FLOAT)
    _, (_, state0) = worker.init(worker.FLOAT)
    pnp, jp, js, jmom, jm = _jax_mesh_step(p0, state0, worker.FLOAT)
    for name, (rp, rs, rmom, rm) in {"one process": (p, s, mom, metrics),
                                     "JAX mesh": (jp, js, jmom, jm)}.items():
        assert abs(dp_metrics["loss"] - rm["loss"]) <= 1e-5 * abs(rm["loss"]), name
        assert dp_metrics["top1"] == rm["top1"] and dp_metrics["n"] == rm["n"] == 16, name
        upd = {l: {k: pnp[l][k] - np.asarray(rp[l][k]) for k in sub} for l, sub in pnp.items()}
        dp_upd = {l: {k: pnp[l][k] - dp_p[l][k].numpy() for k in sub} for l, sub in pnp.items()}
        _close(dp_upd, upd, 1e-4, f"update against {name}")
        _close(dp_m, {l: {k: np.asarray(v) for k, v in sub.items()} for l, sub in rmom.items()},
               1e-4, f"momentum against {name}")
        _close(dp_s, {l: {k: np.asarray(v) for k, v in sub.items()} for l, sub in rs.items()},
               1e-5, f"BN state against {name}")


def test_dp_replicas_bitwise_equal(ranks):
    """After every step, both ranks hold the same params, state and
    momentum, bit for bit, and report the same metrics."""
    a, b = ranks
    for kind in ("float_steps", "qat_steps"):
        for i, (x, y) in enumerate(zip(a[kind], b[kind])):
            for j, what in enumerate(("params", "state", "momentum")):
                _same(x[j], y[j], f"{kind} step {i} {what}")
            assert x[3] == y[3]
        assert not torch.equal(a[kind][0][0]["classifier"]["w"], a[kind][1][0]["classifier"]["w"])
    _same(a["calib"][0], b["calib"][0], "calib state")


def _fraclens_and_bn(got, want, what):
    for lname, sub in want.items():
        assert torch.equal(got[lname]["input_fl_ema"], sub["input_fl_ema"]), f"{what}: {lname}"
    bn = {l: {k: v for k, v in sub.items() if k in ("bn_mean", "bn_var")}
          for l, sub in want.items()}
    _close(got, bn, QAT_BN_LIMIT, what)


def test_qat_dp_step_fraclens_and_bn_state(ranks):
    """The QAT train step and a calib step on two ranks against one
    process on the global batch, layer by layer: every input fraclen's EMA
    equal (the fraclens of this step), BN running statistics within
    QAT_BN_LIMIT of each tensor's largest element."""
    _, _, s, _, metrics = _one_process_step(worker.QAT)
    _, dp_s, _, dp_metrics = ranks[0]["qat_steps"][0]
    assert dp_metrics["n"] == metrics["n"] == 16
    _fraclens_and_bn(dp_s, s, "train")
    model, (params, state) = worker.init(worker.QAT)
    images, labels = worker.global_batch(9)
    step = make_eval_step(model, model.cfg, TrainConfig(**worker.TRAIN_KW), mode="calib")
    s, _ = step(params, reset_bn_for_calib(state), torch.from_numpy(images),
                torch.from_numpy(labels))
    _fraclens_and_bn(ranks[0]["calib"][0], s, "calib")


def test_cli_two_ranks(ranks, tmp_path):
    """run.main on two ranks: rank 0 alone writes files and prints; the
    resumed run loads the same tensors on both ranks, those that rank 0's
    first run saved; both ranks end each epoch with equal params; the
    int_op_only phase's reduced top-1 error and image count equal the
    one-process CLI's on the same checkpoint."""
    a, b = ranks[0]["cli"], ranks[1]["cli"]
    assert b["writes"] == [] and all(out == "" for out in b["printed"])
    assert {"latest_checkpoint.npz", "int_op_only_model.npz"} <= set(a["writes"])
    assert "Start training." in a["printed"][0]
    assert f"Loaded checkpoint {a['log_dir']} at epoch 1." in a["printed"][1]
    assert len(a["trained"]) == len(b["trained"]) == 2  # the train run's epoch, the resumed one
    for x, y in zip(a["trained"], b["trained"]):
        _same(x, y, "params after an epoch")
    # loaded: the resume's (params, state), then the int phase's
    assert len(a["loaded"]) == len(b["loaded"]) == 2
    for x, y in zip(a["loaded"], b["loaded"]):
        for tx, ty in zip(x, y):
            _same(tx, ty, "loaded")
    _same(a["loaded"][0][0], a["trained"][0], "resumed params against the first epoch's")
    assert a["results"][2] == b["results"][2]
    assert a["results"][2]["images"] == 4  # the val set, two images per rank

    import yaml

    path = tmp_path / "int.yml"
    with open(path, "w") as f:
        yaml.safe_dump(dict(worker.CLI_FLAGS, log_dir=str(tmp_path / "log"), int_op_only=True,
                            pretrained_file=os.path.join(a["log_dir"], "latest_checkpoint.npz")), f)
    one = port_cli.main([f"app:{path}", f"bs:{worker.CLI_FLAGS['batch_size']}"], device="cpu")
    assert one == a["results"][2]
    trees, meta = load_checkpoint(os.path.join(a["log_dir"], "latest_checkpoint.npz"))
    assert meta["last_epoch"] == 2
    for lname, sub in a["trained"][1].items():
        for k, v in sub.items():
            assert np.array_equal(trees["params"][lname][k], v.numpy()), (lname, k)


def test_shards_partition_under_use_diff_seed(ranks):
    """Under use_diff_seed the ranks share the permutation's seed and offset
    only the augmentation's, so each epoch their shards partition the
    dataset.  Reference property (b): the JAX CLI adds the process index to
    its Loader's one seed, which also drives the permutation
    (f8net_tpu/data/pipeline.py:218-222, f8net_tpu/run.py:49-54, :82-91):
    its shards overlap and miss samples."""
    a, b = ranks[0]["cli"], ranks[1]["cli"]
    n = worker.CLI_FLAGS["synthetic_size"]
    assert (a["seed"], b["seed"]) == (7, 7) and (a["aug_seed"], b["aug_seed"]) == (7, 8)
    assert a["batch_size"] == b["batch_size"] == worker.CLI_FLAGS["batch_size"] // WORLD
    for epoch in (0, 1):
        sa, sb = set(a["shards"][epoch]), set(b["shards"][epoch])
        assert not sa & sb and sa | sb == set(range(n)), epoch
    assert a["shards"][0] != a["shards"][1]  # each epoch its own permutation
    ds = jax_data.SyntheticDataset(n, 32, 5)
    jax_shards = [set(int(i) for i in jax_data.Loader(ds, 4, shard=r, num_shards=WORLD,
                                                       seed=7 + r)._indices())
                  for r in range(WORLD)]
    assert jax_shards[0] & jax_shards[1] and jax_shards[0] | jax_shards[1] != set(range(n))
    assert len(SyntheticDataset(n, 32, 5)) == n


def test_reference_cli_never_joins_a_process_group():
    """Reference property (a): the JAX CLI never calls init_dist and feeds
    its jitted step process-local arrays (f8net_tpu/run.py:49-54, :82-91;
    train/loop.py:132-145), so its multi-process branch would train
    unsynchronised replicas.  The port's CLI joins the group torchrun
    describes when run as a script, and its steps reduce over it."""
    assert "init_dist" not in inspect.getsource(jax_run)
    assert hasattr(jax_dist, "init_dist")
    assert "init_dist()" in inspect.getsource(port_cli)
