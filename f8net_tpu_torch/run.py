"""CLI entry point: `python -m f8net_tpu_torch.run app:<cfg.yml> bs:<batch>
[device:cpu]` (the port of `f8net_tpu/run.py`).

Loads a YAML experiment (the repository's `configs/`, unchanged), builds the
model, runs the requested phase -- train / tiny-finetune / test-only in the
QAT eval or the integer modes (integize, int_op_only) / bn-calibration --
with checkpoint auto-resume and the per-layer fraclen dump at the end.  It
runs on the card ("cuda", the default, raises without one) unless the
caller passes `device=` or a `device:` token; one process, rank 0 of 1.

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


def make_loader(ds, train, cfg, tcfg, extras):
    """An experiment's Loader over `ds` (one process: shard 0 of 1)."""
    from .data import Loader

    return Loader(
        ds, batch_size=max(tcfg.batch_size, 1), train=train, normalize=cfg.normalize,
        image_size=tcfg.image_size, shard=0, num_shards=1,
        num_workers=int(extras.get("data_loader_workers", 4)), seed=tcfg.random_seed,
    )


def main(argv=None, device="cuda"):
    """Runs one experiment; returns the last phase's results dict."""
    from .engine import IntEngine
    from .export import qat_from_numpy, tensors_from_numpy
    from .importers import load_reference_checkpoint
    from .models import get_model
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

    model_name = str(extras.get("model", "fix_resnet")).split(".")[-1]
    if model_name == "fix_resnet":
        model_name = f"resnet{extras.get('depth', 18)}"
    model = get_model(model_name, cfg, num_classes=tcfg.num_classes, image_size=tcfg.image_size)
    print(f"model: {model.name}  layers: {len(model.graph.names())}")

    # one process (rank 0 of 1): use_diff_seed's per-process offset is 0
    seed = tcfg.random_seed
    trainer = Trainer(model, cfg, tcfg, device=device)
    # the init is drawn on the host, so the card and the CPU start alike
    params, state, opt = trainer.init(torch.Generator().manual_seed(seed))

    if extras.get("fp_pretrained_file"):
        # full-precision init from an npz checkpoint (the floating-model
        # training output), the analog of fp_pretrained_file (fix_train.py:840-862)
        params, state = _load_trees(extras["fp_pretrained_file"], device)
        print(f"Loaded full precision model {extras['fp_pretrained_file']}.")

    if extras.get("pretrained_file"):
        pf = extras["pretrained_file"]
        if pf.endswith(".npz") or os.path.exists(pf + ".npz"):
            params, state = _load_trees(pf, device)
        else:
            params, state = load_reference_checkpoint(model, pf, params, state)
        print(f"Loaded model {pf}.")

    train_ds, val_ds = datasets(tcfg, extras)
    val_loader = make_loader(val_ds, False, cfg, tcfg, extras)
    train_loader = make_loader(train_ds, True, cfg, tcfg, extras) if train_ds is not None else None

    log_dir = extras.get("log_dir", "results")
    if extras.get("experiment_subdir", True):
        log_dir = os.path.join(log_dir, experiment_setting(cfg, tcfg, extras))
        print(f"log dir: {log_dir}")
    os.makedirs(log_dir, exist_ok=True)
    latest = os.path.join(log_dir, "latest_checkpoint")

    # integer conversion / export phases
    if cfg.integize or cfg.int_op_only:
        plan, int_params = bake_plan(model, params, state)
        eng = IntEngine(model, plan, int_params, int_only=cfg.int_op_only, device=device)
        out_dir = extras.get(
            "int_op_only_file_path" if cfg.int_op_only else "integize_file_path", ""
        )
        if out_dir:
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
        # test loop over the val set through the engine; counts stay on the
        # device until the end
        total, correct = 0, torch.zeros((), dtype=torch.int64, device=device)
        for images, labels in val_loader:
            y = eng(eng.condition_input(images))
            correct += torch.sum(torch.argmax(y, -1) == torch.as_tensor(labels).to(device).long())
            total += labels.shape[0]
        top1_error = 1 - int(correct) / max(total, 1)
        print(f"test\t-1/{tcfg.num_epochs}: top1_error: {top1_error:.3f}")
        fraclen_report(model, params, state, cfg)
        return {"top1_error": top1_error, "images": total}

    if tcfg.test_only:
        _, _, _, res = trainer.run_epoch(
            params, state, opt, val_loader, -1, max(len(val_loader), 1), "test"
        )
        fraclen_report(model, params, state, cfg)
        return res

    # resume
    last_epoch, best_val = 0, 1.0
    if os.path.exists(latest + ".npz"):
        trees, meta = load_checkpoint(latest)
        params, state = qat_from_numpy(trees["params"], trees["state"], device)
        opt = SGDState(momentum=tensors_from_numpy(trees["opt_momentum"], device, "momentum"))
        last_epoch = int(meta.get("last_epoch", 0))
        best_val = float(meta.get("best_val", 1.0))
        print(f"Loaded checkpoint {log_dir} at epoch {last_epoch}.")

    if tcfg.bn_calib_before_test:
        print("Start calibration.")
        state = reset_bn_for_calib(state)
        params, state, opt, _ = trainer.run_epoch(
            params, state, opt, train_loader, -1, max(len(train_loader), 1), "calib"
        )
        _, _, _, res = trainer.run_epoch(
            params, state, opt, val_loader, -1, max(len(val_loader), 1), "val"
        )
        save_checkpoint(
            os.path.join(log_dir, "best_model_bn_calibrated"),
            {"params": params, "state": state},
            meta={"val_top1_error": res["top1_error"]},
        )
        return res

    print("Start training.")
    ckpt = AsyncCheckpointer()  # overlap checkpoint IO with the next epoch
    res = {}
    try:
        steps = max(len(train_loader), 1)
        for epoch in range(last_epoch, tcfg.num_epochs):
            train_loader.set_epoch(epoch)
            params, state, opt, _ = trainer.run_epoch(
                params, state, opt, train_loader, epoch, steps, "train"
            )
            _, _, _, res = trainer.run_epoch(params, state, opt, val_loader, epoch, steps, "val")
            if res["top1_error"] < best_val:
                best_val = res["top1_error"]
                ckpt.save(
                    os.path.join(log_dir, "best_model"),
                    {"params": params, "state": state},
                    meta={"best_val": best_val},
                )
                print(f"New best validation top1 error: {best_val:.3f}")
            ckpt.save(
                latest,
                {"params": params, "state": state, "opt_momentum": opt.momentum},
                meta={"last_epoch": epoch + 1, "best_val": best_val},
            )
    finally:
        ckpt.close()  # make all queued checkpoints durable before reporting
    fraclen_report(model, params, state, cfg)
    return res


if __name__ == "__main__":
    main()
