"""One-command accuracy-parity harness against the reference's Model Zoo
(the port of `f8net_tpu/parity.py`).

    python -m f8net_tpu_torch.parity model:resnet18 variant:tiny_finetuning \\
        pretrained_file:/path/Res18_8p.pt dataset_dir:/path/imagenet [bs:256]

evaluates the imported checkpoint through all four inference modes --
QAT-sim eval, int_infer, integize (float-simulated integer graph), and the
int_op_only integer engine -- over the ImageNet val set and prints the
README parity table (top-1/top-5 per mode, delta vs the published number,
reference README.md:90-113).

Without data/checkpoints, `dataset:synthetic` dry-runs the identical
plumbing on random weights + synthetic images and checks the four modes
agree with each other -- so the table is producible the moment artifacts
appear.  Everything runs on `device` ("cuda" by default; `device:cpu` on
the command line): the QAT forwards, and the int_op_only mode through the
integer engine's kernels.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

# Published 8-bit top-1 accuracies (reference README.md:96-112)
PUBLISHED = {
    ("resnet18", "conventional"): 71.0,
    ("resnet18", "tiny_finetuning"): 72.3,
    ("mobilenet_v1", "conventional"): 72.8,
    ("mobilenet_v2", "conventional"): 72.6,
    ("resnet50", "tiny_finetuning"): 77.6,
    ("resnet50", "nvidia"): 78.1,
}

MODES = ("qat_sim", "int_infer", "integize", "int_op_only")

# The reference bundles golden per-layer fraclen profiles of its trained
# models (fraclen_visual/*.out training logs, e.g. mbv2_fix_quant.out); they
# are not in this repository.  A caller that has one passes it as
# `fraclen_profile`, and the harness diffs the baked plan against it.


def _ref_layer_to_ours(name: str) -> str:
    # the reference names sequential wrappers head.0 / tail.0 / classifier.0
    for stem in ("head", "tail", "classifier"):
        if name == f"{stem}.0":
            return stem
    return name


def check_golden_fraclens(model, plan, profile_text: str):
    """Diff a baked QuantPlan against a reference per-layer fraclen profile
    (the fraclen_visual/*.out dump vocabulary, fix_train.py:971-991).

    Returns (rows, n_mismatch) where each row is
    (layer, want_input_fl, want_weight_fl, got_input_fl, got_weight_fl, ok).
    Weight-only layers consume fraclen-8 raw input regardless of their
    dormant EMA buffer (reference get_input_fraclen; nn/quant_layers.py
    input_fraclen), so their expected input_fl is pinned to 8."""
    from .utils.reporting import parse_fraclen_report

    parsed = parse_fraclen_report(profile_text)
    names = set(model.graph.names())
    rows = []
    for ref_name, d in parsed.items():
        ours = _ref_layer_to_ours(ref_name)
        if ours not in names:
            rows.append((ours, None, None, None, None, False))
            continue
        lp = plan[ours]
        if model.graph[ours].weight_only:
            want_in = 8
        else:
            want_in = (
                int(round(d["input_fraclen"][0])) if d.get("input_fraclen") else None
            )
        want_w = (
            int(round(d["weight_fraclen"][0])) if d.get("weight_fraclen") else None
        )
        ok = (want_in is None or lp.input_fl == want_in) and (
            want_w is None or lp.weight_fl == want_w
        )
        rows.append((ours, want_in, want_w, lp.input_fl, lp.weight_fl, ok))
    return rows, sum(1 for r in rows if not r[5])


def print_fraclen_table(rows, n_mismatch, profile_name=""):
    print(f"\n== golden fraclen check vs {profile_name or 'profile'} ==")
    print(
        f"{'layer':28s} {'want in_fl':>10s} {'want w_fl':>9s} "
        f"{'got in_fl':>9s} {'got w_fl':>8s} {'match':>6s}"
    )
    for name, wi, ww, gi, gw, ok in rows:
        fmt = lambda v: "-" if v is None else str(v)
        print(
            f"{name:28s} {fmt(wi):>10s} {fmt(ww):>9s} {fmt(gi):>9s} "
            f"{fmt(gw):>8s} {'ok' if ok else 'MISMATCH':>8s}"
        )
    print(f"fraclen mismatches: {n_mismatch}/{len(rows)}")


def _topk_counts(logits, labels, ks=(1, 5)):
    order = np.argsort(-np.asarray(logits), axis=-1)
    lab = np.asarray(labels)[:, None]
    return {k: int((order[:, :k] == lab).any(axis=1).sum()) for k in ks}


def evaluate_parity(
    model_name: str,
    variant: str = "conventional",
    pretrained_file: str = "",
    dataset_dir: str = "",
    synthetic: bool = False,
    batch_size: int = 64,
    limit_batches: Optional[int] = None,
    image_size: int = 224,
    num_classes: int = 1000,
    seed: int = 0,
    fraclen_profile: str = "",
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """Returns ({mode: {top1, top5}} accuracies (percent), total images,
    golden-fraclen diff rows or None)."""
    from .data import ImageFolderDataset, Loader, SyntheticDataset
    from .engine import IntEngine
    from .export import qat_from_numpy
    from .importers import load_reference_checkpoint
    from .models import get_model
    from .quant import bake_plan
    from .train import load_checkpoint
    from .utils.device import resolve_device
    from .utils.flags import from_flags, load_yaml

    device = resolve_device(device)
    cfg_path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "imagenet", model_name,
        "tiny_finetuning" if variant in ("tiny_finetuning", "nvidia") else variant,
        {
            "tiny_finetuning": "fix_quant_ptcv_pretrained_test.yml",
            "nvidia": "fix_quant_nvidia_pretrained_test.yml",
        }.get(variant, "fix_quant_test.yml"),
    )
    cfg, tcfg, extras = from_flags(load_yaml(cfg_path), batch_size)
    model = get_model(model_name, cfg, num_classes=num_classes, image_size=image_size)
    params, state = model.init(torch.Generator().manual_seed(seed), device=device)

    if pretrained_file:
        if pretrained_file.endswith(".npz") or os.path.exists(pretrained_file + ".npz"):
            trees, _ = load_checkpoint(pretrained_file.replace(".npz", ""))
            params, state = qat_from_numpy(trees["params"], trees["state"], device)
        else:
            params, state = load_reference_checkpoint(model, pretrained_file, params, state)
    elif synthetic:
        # exercise the full plumbing: one train-mode forward settles EMA fraclens
        g = torch.Generator().manual_seed(seed + 1)
        x0 = torch.round(255 * torch.rand((2, image_size, image_size, 3), generator=g)) / 256
        with torch.no_grad():
            _, state = model.apply(params, state, x0.to(device), mode="train")
    else:
        raise ValueError("need pretrained_file: or dataset:synthetic")

    if synthetic:
        val_ds = SyntheticDataset(
            max(batch_size * (limit_batches or 2), 1), image_size, num_classes, seed=7
        )
    else:
        val_ds = ImageFolderDataset(os.path.join(dataset_dir, "val"))
    loader = Loader(
        val_ds, batch_size, train=False, normalize=cfg.normalize,
        image_size=image_size, num_workers=4, seed=seed,
    )

    plan, int_params = bake_plan(model, params, state)

    fraclen_check = None
    if fraclen_profile:
        with open(fraclen_profile, errors="replace") as f:
            rows, n_bad = check_golden_fraclens(model, plan, f.read())
        fraclen_check = (rows, n_bad, os.path.basename(fraclen_profile))

    eng_int = IntEngine(model, plan, int_params, int_only=True, device=device)
    eng_sim = IntEngine(model, plan, int_params, int_only=False, device=device)
    cfg_ii = cfg.replace(int_infer=True)

    counts = {m: {1: 0, 5: 0} for m in MODES}
    total = 0
    with torch.no_grad():
        for bi, (images, labels) in enumerate(loader):
            if limit_batches is not None and bi >= limit_batches:
                break
            x = torch.from_numpy(images).to(device)
            if not cfg.normalize:
                x = torch.round(255.0 * x) / 256.0  # fix_train.py:694 conditioning
            outs = {
                "qat_sim": model.forward(params, state, x, "eval", cfg)[0],
                "int_infer": model.forward(params, state, x, "eval", cfg_ii)[0],
                "integize": eng_sim(eng_sim.condition_input(images)),
                "int_op_only": eng_int(eng_int.condition_input(images)),
            }
            for m, y in outs.items():
                for k, c in _topk_counts(y.cpu().numpy(), labels).items():
                    counts[m][k] += c
            total += labels.shape[0]

    return {
        m: {"top1": 100.0 * c[1] / max(total, 1), "top5": 100.0 * c[5] / max(total, 1)}
        for m, c in counts.items()
    }, total, fraclen_check


def print_table(model_name, variant, results, total):
    pub = PUBLISHED.get((model_name, variant))
    print(f"\n== accuracy parity: {model_name} ({variant}), {total} images ==")
    print(f"{'mode':14s} {'top1':>7s} {'top5':>7s} {'published':>10s} {'delta':>7s}")
    for m in MODES:
        r = results[m]
        if pub is not None:
            print(
                f"{m:14s} {r['top1']:7.2f} {r['top5']:7.2f} {pub:10.1f} "
                f"{r['top1'] - pub:+7.2f}"
            )
        else:
            print(f"{m:14s} {r['top1']:7.2f} {r['top5']:7.2f} {'-':>10s} {'-':>7s}")
    spread = max(results[m]["top1"] for m in MODES) - min(
        results[m]["top1"] for m in MODES
    )
    print(f"cross-mode top-1 spread: {spread:.2f} pp")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    kv = dict(a.split(":", 1) for a in argv if ":" in a)
    if not kv or "model" not in kv:
        print(__doc__)
        sys.exit(2)
    model_name = kv["model"]
    variant = kv.get("variant", "conventional")
    synthetic = kv.get("dataset") == "synthetic"
    results, total, fraclen_check = evaluate_parity(
        model_name,
        variant,
        pretrained_file=kv.get("pretrained_file", ""),
        dataset_dir=kv.get("dataset_dir", ""),
        synthetic=synthetic,
        batch_size=int(kv.get("bs", 64 if not synthetic else 16)),
        limit_batches=int(kv["limit"]) if "limit" in kv else (2 if synthetic else None),
        image_size=int(kv.get("image_size", 224)),
        num_classes=int(kv.get("num_classes", 1000 if not synthetic else 16)),
        fraclen_profile=kv.get("fraclen_profile", ""),
        device=kv.get("device", "cuda"),
    )
    print_table(model_name, variant, results, total)
    if fraclen_check is not None:
        print_fraclen_table(*fraclen_check)


if __name__ == "__main__":
    main()
