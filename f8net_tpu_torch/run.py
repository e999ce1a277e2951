"""CLI entry point: `python -m f8net_tpu_torch.run app:<cfg.yml> bs:<batch>
[device:cpu]` (the port of `f8net_tpu/run.py`).

Loads a YAML experiment (the repository's `configs/`, unchanged), builds the
model, runs the requested phase -- train / tiny-finetune / test-only in the
QAT eval or the integer modes (integize, int_op_only) / bn-calibration --
with checkpoint auto-resume and the per-layer fraclen dump at the end.  It
runs on the card ("cuda", the default, raises without one) unless the
caller passes `device=` or a `device:` token.

Data parallelism: where the caller has joined a process group of more
than one process (`parallel.init_dist`; run as a script, this module
joins the one `torchrun` describes), each process is one rank.  Its
Loaders take shard `rank` of `world` at batch_size // world; every rank
starts from the same params (the base seed's init, or the same files);
the train and calib steps reduce over the global batch
(`train.make_train_step`); rank 0 alone writes checkpoints, the int
phases' files and the reports, and the printed errors are the reduced
ones.  `use_diff_seed` offsets each rank's augmentation stream alone: the
permutation is shared, so the ranks' shards partition every epoch.  (The
JAX CLI adds the process index to its one Loader seed, which also drives
the permutation, and to the init's key.)

    torchrun --nproc_per_node=<cards> -m f8net_tpu_torch.run app:<cfg.yml> bs:<global batch>

Dataset: `dataset_dir` with train/ and val/ ImageFolder trees, or
`dataset: synthetic` for smoke runs without data on disk.
"""

from __future__ import annotations

import os
import sys

import torch


def _load_trees(path, device):
    """(params, state) of a checkpoint npz either package wrote."""
    from .export import qat_from_numpy
    from .train import load_checkpoint

    trees, _ = load_checkpoint(path)
    return qat_from_numpy(trees["params"], trees["state"], device)


def datasets(tcfg, extras):
    """(train, val) datasets of an experiment: the `dataset_dir` ImageFolder
    trees (no train set under test_only), or `dataset: synthetic`."""
    from .data import ImageFolderDataset, SyntheticDataset

    if extras.get("dataset") == "synthetic":
        n = int(extras.get("synthetic_size", 512))
        return (SyntheticDataset(n, tcfg.image_size, tcfg.num_classes),
                SyntheticDataset(max(n // 4, 1), tcfg.image_size, tcfg.num_classes, seed=7))
    root = extras.get("dataset_dir", "data")
    train_ds = ImageFolderDataset(os.path.join(root, "train")) if not tcfg.test_only else None
    return train_ds, ImageFolderDataset(os.path.join(root, "val"))


def make_loader(ds, train, cfg, tcfg, extras, rank: int = 0, world: int = 1):
    """An experiment's Loader over `ds`: rank `rank`'s shard of `world` at
    batch_size // world, the permutation seeded alike on every rank, the
    augmentation stream offset by the rank under use_diff_seed
    (fix_train.py:807-817)."""
    from .data import Loader

    aug = tcfg.random_seed + (rank if extras.get("use_diff_seed") else 0)
    return Loader(
        ds, batch_size=max(tcfg.batch_size // world, 1), train=train, normalize=cfg.normalize,
        image_size=tcfg.image_size, shard=rank, num_shards=world,
        num_workers=int(extras.get("data_loader_workers", 4)), seed=tcfg.random_seed,
        aug_seed=aug,
    )


def main(argv=None, device="cuda"):
    """Runs one experiment; returns the last phase's results dict."""
    from .engine import IntEngine
    from .export import qat_from_numpy, tensors_from_numpy
    from .importers import load_reference_checkpoint
    from .models import get_model
    from .parallel import (
        all_reduce_metrics, barrier, data_group, get_rank, get_world_size,
        master_only, master_only_print,
    )
    from .quant import bake_plan, reset_bn_for_calib
    from .train import AsyncCheckpointer, SGDState, Trainer, load_checkpoint, save_checkpoint
    from .utils.device import resolve_device
    from .utils.flags import experiment_setting, from_flags, load_yaml, parse_argv
    from .utils.reporting import fraclen_report

    argv = argv if argv is not None else sys.argv[1:]
    app, bs, extra = parse_argv(argv)
    if app is None:
        print(__doc__)
        sys.exit(2)
    device = resolve_device(extra.get("device", device))
    flags = load_yaml(app)
    cfg, tcfg, extras = from_flags(flags, bs)
    rank, world, group = get_rank(), get_world_size(), data_group()
    master = rank == 0
    say, report = master_only_print, master_only(fraclen_report)

    model_name = str(extras.get("model", "fix_resnet")).split(".")[-1]
    if model_name == "fix_resnet":
        model_name = f"resnet{extras.get('depth', 18)}"
    model = get_model(model_name, cfg, num_classes=tcfg.num_classes, image_size=tcfg.image_size)
    say(f"model: {model.name}  layers: {len(model.graph.names())}")

    trainer = Trainer(model, cfg, tcfg, log=say, device=device, group=group)
    # the init is drawn on the host from the base seed, so the card and the
    # CPU, and every rank, start alike
    params, state, opt = trainer.init(torch.Generator().manual_seed(tcfg.random_seed))

    if extras.get("fp_pretrained_file"):
        # full-precision init from an npz checkpoint (the floating-model
        # training output), the analog of fp_pretrained_file (fix_train.py:840-862)
        params, state = _load_trees(extras["fp_pretrained_file"], device)
        say(f"Loaded full precision model {extras['fp_pretrained_file']}.")

    if extras.get("pretrained_file"):
        pf = extras["pretrained_file"]
        if pf.endswith(".npz") or os.path.exists(pf + ".npz"):
            params, state = _load_trees(pf, device)
        else:
            params, state = load_reference_checkpoint(model, pf, params, state)
        say(f"Loaded model {pf}.")

    train_ds, val_ds = datasets(tcfg, extras)
    val_loader = make_loader(val_ds, False, cfg, tcfg, extras, rank, world)
    train_loader = (make_loader(train_ds, True, cfg, tcfg, extras, rank, world)
                    if train_ds is not None else None)

    log_dir = extras.get("log_dir", "results")
    if extras.get("experiment_subdir", True):
        log_dir = os.path.join(log_dir, experiment_setting(cfg, tcfg, extras))
        say(f"log dir: {log_dir}")
    if master:
        os.makedirs(log_dir, exist_ok=True)
    latest = os.path.join(log_dir, "latest_checkpoint")

    # integer conversion / export phases
    if cfg.integize or cfg.int_op_only:
        plan, int_params = bake_plan(model, params, state)
        eng = IntEngine(model, plan, int_params, int_only=cfg.int_op_only, device=device)
        out_dir = extras.get(
            "int_op_only_file_path" if cfg.int_op_only else "integize_file_path", ""
        )
        if out_dir and master:
            os.makedirs(os.path.join(out_dir, "checkpoints"), exist_ok=True)
            save_checkpoint(
                os.path.join(
                    out_dir, "checkpoints",
                    "int_op_only_model" if cfg.int_op_only else "integized_model",
                ),
                {"int_params": int_params},
                meta={"plan": [
                    {"name": p.name, "input_fl": p.input_fl, "weight_fl": p.weight_fl,
                     "input_symmetric": p.input_symmetric}
                    for p in plan.layers
                ]},
            )
            print(f"Converted model saved to {out_dir}.")
        # test loop over this rank's val shard through the engine; counts
        # stay on the device until the end, then add up over the ranks
        total, correct = 0, torch.zeros((), dtype=torch.int64, device=device)
        for images, labels in val_loader:
            y = eng(eng.condition_input(images))
            correct += torch.sum(torch.argmax(y, -1) == torch.as_tensor(labels).to(device).long())
            total += labels.shape[0]
        counts = all_reduce_metrics({"correct": correct, "total": total}, "sum", group)
        correct, total = int(counts["correct"]), int(counts["total"])
        top1_error = 1 - correct / max(total, 1)
        say(f"test\t-1/{tcfg.num_epochs}: top1_error: {top1_error:.3f}")
        report(model, params, state, cfg)
        return {"top1_error": top1_error, "images": total}

    if tcfg.test_only:
        _, _, _, res = trainer.run_epoch(
            params, state, opt, val_loader, -1, max(len(val_loader), 1), "test"
        )
        report(model, params, state, cfg)
        return res

    # resume (the barrier: no rank looks for the checkpoint while rank 0
    # may still write it)
    barrier(group)
    last_epoch, best_val = 0, 1.0
    if os.path.exists(latest + ".npz"):
        trees, meta = load_checkpoint(latest)
        params, state = qat_from_numpy(trees["params"], trees["state"], device)
        opt = SGDState(momentum=tensors_from_numpy(trees["opt_momentum"], device, "momentum"))
        last_epoch = int(meta.get("last_epoch", 0))
        best_val = float(meta.get("best_val", 1.0))
        say(f"Loaded checkpoint {log_dir} at epoch {last_epoch}.")

    if tcfg.bn_calib_before_test:
        say("Start calibration.")
        state = reset_bn_for_calib(state)
        params, state, opt, _ = trainer.run_epoch(
            params, state, opt, train_loader, -1, max(len(train_loader), 1), "calib"
        )
        _, _, _, res = trainer.run_epoch(
            params, state, opt, val_loader, -1, max(len(val_loader), 1), "val"
        )
        if master:
            save_checkpoint(
                os.path.join(log_dir, "best_model_bn_calibrated"),
                {"params": params, "state": state},
                meta={"val_top1_error": res["top1_error"]},
            )
        barrier(group)
        return res

    say("Start training.")
    ckpt = AsyncCheckpointer()  # overlap checkpoint IO with the next epoch
    res = {}
    try:
        # the schedule's steps per epoch: the lockstep count, alike on every rank
        steps = max(trainer.lockstep_steps(train_loader), 1)
        for epoch in range(last_epoch, tcfg.num_epochs):
            train_loader.set_epoch(epoch)
            params, state, opt, _ = trainer.run_epoch(
                params, state, opt, train_loader, epoch, steps, "train"
            )
            _, _, _, res = trainer.run_epoch(params, state, opt, val_loader, epoch, steps, "val")
            if res["top1_error"] < best_val:  # the reduced error: alike on every rank
                best_val = res["top1_error"]
                if master:
                    ckpt.save(
                        os.path.join(log_dir, "best_model"),
                        {"params": params, "state": state},
                        meta={"best_val": best_val},
                    )
                say(f"New best validation top1 error: {best_val:.3f}")
            if master:
                ckpt.save(
                    latest,
                    {"params": params, "state": state, "opt_momentum": opt.momentum},
                    meta={"last_epoch": epoch + 1, "best_val": best_val},
                )
    finally:
        ckpt.close()  # make all queued checkpoints durable before reporting
    barrier(group)  # every checkpoint written before any rank goes on to read one
    report(model, params, state, cfg)
    return res


if __name__ == "__main__":
    from .parallel import init_dist

    init_dist()  # the process group torchrun describes, if any
    try:
        main()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
