"""One rank of tests/test_torch_dist.py's two-process run (gloo on the CPU).

    python tests/_torch_dist_worker.py <port> <rank> <world> <outdir>

Joins the group through `parallel.init_dist` and runs every scenario of the
port's data parallelism on this rank's shard of seeded global batches:
the process-group helpers, the global statistics (metric_fn,
fraclen_gridsearch, the BN moments), a floating_wo_clip and a QAT train
step of a ResNet-18 at 16 px (two steps each), a calib step, and the CLI
(`run.main`) under two ranks -- train, resume, int_op_only.  Each rank
writes what it computed to <outdir>/rank<r>.pt; the test holds the two
ranks against each other, against the port in one process and against the
JAX package.  Imports no JAX.
"""

import contextlib
import io
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from f8net_tpu_torch import run as cli  # noqa: E402
from f8net_tpu_torch.models import get_model  # noqa: E402
from f8net_tpu_torch.ops import fxp  # noqa: E402
from f8net_tpu_torch.parallel import (  # noqa: E402
    all_reduce_metrics, data_group, get_rank, get_world_size, init_dist, is_master,
    master_only, shard_batch,
)
from f8net_tpu_torch.quant import reset_bn_for_calib  # noqa: E402
from f8net_tpu_torch.train import loop as train_loop  # noqa: E402
from f8net_tpu_torch.train import checkpoint as train_ckpt  # noqa: E402
from f8net_tpu_torch.train import make_eval_step, make_train_step, sgd_init  # noqa: E402
from f8net_tpu_torch.utils import QuantConfig, TrainConfig  # noqa: E402
from f8net_tpu_torch.utils.flags import from_flags  # noqa: E402
import f8net_tpu_torch.export as export_mod  # noqa: E402

# shared with tests/test_torch_dist.py
GLOBAL_BATCH, SIZE, CLASSES = 16, 16, 10
FLOAT = dict(floating_wo_clip=True)
QAT = dict(format_from_metric=True, metric="std")
TRAIN_KW = dict(lr=0.01, weight_decay=4e-5, momentum=0.9, nesterov=True, topk=(1,))
METRICS = ("std", "mae", "rms")
CLI_FLAGS = dict(dataset="synthetic", synthetic_size=16, num_classes=5, image_size=32,
                 lr=0.01, lr_scheduler="constant", batch_size=8, data_loader_workers=1,
                 topk=[1], model="models.fix_resnet", depth=18, weight_format=[8, 7],
                 input_format=[8, 6], format_from_metric=True, metric="std", momentum=0.9,
                 weight_decay=0.0, nesterov=True, random_seed=7, experiment_subdir=False,
                 use_diff_seed=True)


def global_batch(seed, n=GLOBAL_BATCH, size=SIZE, classes=CLASSES):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, size, size, 3).astype(np.float32),
            rng.randint(0, classes, n).astype(np.int32))


def statistic_input(seed=5):
    """A global activation-like tensor (N, H, W, C) for the statistics."""
    rng = np.random.RandomState(seed)
    return (rng.randn(8, 5, 5, 6) * rng.rand(6) * 3).astype(np.float32)


def init(cfg, seed=0):
    model = get_model("resnet18", QuantConfig(**cfg), num_classes=CLASSES, image_size=SIZE)
    return model, model.init(torch.Generator().manual_seed(seed), device="cpu")


def _copy(tree):
    return {l: {k: v.detach().clone() for k, v in sub.items()} for l, sub in tree.items()}


def train_steps(cfg, group, rank, world, steps=2):
    """`steps` train steps from the shared init on this rank's shard of the
    global batch (seeded per step); (params, state, momentum, metrics)
    after each step."""
    model, (params, state) = init(cfg)
    step = make_train_step(model, model.cfg, TrainConfig(**TRAIN_KW), group)
    opt = sgd_init(params)
    out = []
    for i in range(steps):
        images, labels = global_batch(1 + i)
        x = torch.from_numpy(shard_batch(images, rank, world))
        y = torch.from_numpy(shard_batch(labels, rank, world))
        params, state, opt, m = step(params, state, opt, x, y, 0.01)
        out.append((_copy(params), _copy(state), _copy(opt.momentum),
                    {k: float(v) for k, v in m.items()}))
    return out


def calib_step(group, rank, world):
    """One calib-mode step of the QAT ResNet-18 on reset BN state."""
    model, (params, state) = init(QAT)
    step = make_eval_step(model, model.cfg, TrainConfig(**TRAIN_KW), mode="calib", group=group)
    images, labels = global_batch(9)
    state, m = step(params, reset_bn_for_calib(state),
                    torch.from_numpy(shard_batch(images, rank, world)),
                    torch.from_numpy(shard_batch(labels, rank, world)))
    return _copy(state), {k: float(v) for k, v in m.items()}


def statistics(group, rank, world):
    """metric_fn per metric, per layer and per channel, and
    fraclen_gridsearch, on this rank's shard of statistic_input()."""
    x = torch.from_numpy(shard_batch(statistic_input(), rank, world))
    out = {}
    for name in METRICS:
        for axes in ((0, 1, 2, 3), (0, 1, 2)):
            out[(name, axes)] = fxp.metric_fn(name, axes, group)(x)
    for signed in (True, False):
        out[("grid", signed)] = fxp.fraclen_gridsearch(x, 8, 3, signed, group)
    mean, var, count = fxp.global_moments(x, (0, 1, 2), group)
    out["moments"] = (mean, var, count)
    return out


def run_cli(tmp, name, argv_flags):
    """run.main on this rank with a YAML of CLI_FLAGS and `argv_flags`;
    returns (result, its standard output)."""
    import yaml

    path = os.path.join(tmp, f"{name}-rank{get_rank()}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(CLI_FLAGS, **argv_flags), f)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = cli.main([f"app:{path}", f"bs:{CLI_FLAGS['batch_size']}"], device="cpu")
    return result, buf.getvalue()


def cli_runs(outdir):
    """The CLI under the group: an epoch of training, a resumed epoch, and
    int_op_only on best_model; which files each rank wrote, what the resume
    loaded, each rank's params after each train epoch, its printed lines,
    and the train Loader's shard for epochs 0 and 1."""
    log_dir = os.path.join(outdir, "cli", "log")
    writes, loaded, trained = [], [], []
    write = train_ckpt._write
    run_epoch = train_loop.Trainer.run_epoch
    qat_from_numpy = export_mod.qat_from_numpy

    def recording_write(path, flat, meta):
        writes.append(os.path.basename(path))
        return write(path, flat, meta)

    def recording_epoch(self, *a, **kw):
        out = run_epoch(self, *a, **kw)
        if (a[6] if len(a) > 6 else kw.get("phase", "train")) == "train":
            trained.append(_copy(out[0]))
        return out

    def recording_load(*a, **kw):
        out = qat_from_numpy(*a, **kw)
        loaded.append(tuple(_copy(t) for t in out))
        return out

    train_ckpt._write = recording_write
    train_loop.Trainer.run_epoch = recording_epoch
    export_mod.qat_from_numpy = recording_load
    try:
        common = dict(log_dir=log_dir)
        r1, out1 = run_cli(outdir, "train", dict(common, num_epochs=1))
        r2, out2 = run_cli(outdir, "resume", dict(common, num_epochs=2))
        latest = os.path.join(log_dir, "latest_checkpoint.npz")
        r3, out3 = run_cli(outdir, "int", dict(
            common, int_op_only=True, pretrained_file=latest,
            int_op_only_file_path=os.path.join(outdir, "cli", "export")))
    finally:
        train_ckpt._write = write
        train_loop.Trainer.run_epoch = run_epoch
        export_mod.qat_from_numpy = qat_from_numpy
    cfg, tcfg, extras = from_flags(dict(CLI_FLAGS), CLI_FLAGS["batch_size"])
    loader = cli.make_loader(cli.datasets(tcfg, extras)[0], True, cfg, tcfg, extras,
                             get_rank(), get_world_size())
    shards = []
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        shards.append([int(i) for i in loader._indices()])
    return dict(writes=writes, loaded=loaded, trained=trained, results=(r1, r2, r3),
                printed=(out1, out2, out3), shards=shards, aug_seed=loader.aug_seed,
                seed=loader.seed, batch_size=loader.bs, log_dir=log_dir)


def main():
    port, rank, world, outdir = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    address = f"tcp://127.0.0.1:{port}"
    got = init_dist(address, rank, world, backend="gloo")
    again = init_dist(address, rank, world, backend="gloo")  # a second call: a no-op
    group = data_group()
    res = dict(
        rank=(got, again, get_rank(), get_world_size(), is_master()),
        master_only=master_only(lambda: "ran")(),
        metrics_sum={k: float(v) for k, v in all_reduce_metrics(
            {"x": float(rank + 1), "t": torch.tensor(2 * rank + 1)}, "sum").items()},
        metrics_mean={k: float(v) for k, v in all_reduce_metrics(
            {"x": float(rank + 1)}, "mean").items()},
        stats=statistics(group, rank, world),
        float_steps=train_steps(FLOAT, group, rank, world),
        qat_steps=train_steps(QAT, group, rank, world),
        calib=calib_step(group, rank, world),
    )
    res["cli"] = cli_runs(outdir)
    torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))
    print(f"rank {rank}: ok")


if __name__ == "__main__":
    main()
