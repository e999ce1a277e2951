"""Deployment bundle I/O (the port of `f8net_tpu/export/bundle.py:22-97`).

A bundle is an npz of int8 weights and int32 biases (`<layer>/w`,
`<layer>/b`) plus a JSON topology with the static shift plan -- the same
files the JAX package writes and reads, so a model baked there serves here.

`params_from_numpy` is the one door through which integer weights enter the
port: plain `(name, input_fl, weight_fl, input_symmetric)` records and numpy
arrays, exactly what the JAX `bake_plan` produces after `np.asarray`, become
the port's `QuantPlan` and tensors on the chosen device.  `qat_from_numpy`
and `qat_to_numpy` carry the QAT forward's (params, state) across in both
directions, as the reference's pytrees of float32 arrays, and
`tensors_from_numpy` any other tree of them (a checkpoint's momentum).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from ..models import get_model
from ..nn.spec import ConvBNSpec, LinearSpec
from ..quant.plan import LayerPlan, QuantPlan
from ..utils.config import QuantConfig
from ..utils.device import resolve_device

_DTYPES = {"w": np.int8, "b": np.int32}


def params_from_numpy(
    plan_records: Iterable[Tuple[str, int, int, bool]],
    int_params_np: Dict[str, Dict[str, np.ndarray]],
    device="cuda",
) -> Tuple[QuantPlan, Dict[str, Dict[str, torch.Tensor]]]:
    """(name, input_fl, weight_fl, input_symmetric) records and
    {name: {'w': int8, 'b': int32}} numpy arrays -> (QuantPlan, tensors on
    `device`).  Weights keep the reference layouts: HWIO for convs,
    (in, out) for linear layers."""
    dev = resolve_device(device)
    plan = QuantPlan(
        tuple(
            LayerPlan(name=str(n), input_fl=int(i), weight_fl=int(w), input_symmetric=bool(s))
            for n, i, w, s in plan_records
        )
    )
    params = {}
    for p in plan.layers:
        entry = {}
        for key, arr in int_params_np[p.name].items():
            arr = np.asarray(arr)
            if key not in _DTYPES or arr.dtype != _DTYPES[key]:
                raise TypeError(f"{p.name}/{key}: expected {_DTYPES.get(key)}, got {arr.dtype}")
            entry[key] = torch.tensor(arr).to(dev)
        params[p.name] = entry
    return plan, params


def tensors_from_numpy(tree, device="cuda", what: str = "tree"):
    """{layer: {name: float32 numpy array}} -> the same dicts of tensors on
    `device`, values and shapes as given: a QAT params or state tree, or
    the SGD momentum tree that a checkpoint carries beside them."""
    dev = resolve_device(device)
    out = {}
    for lname, entry in tree.items():
        d = {}
        for key, arr in entry.items():
            arr = np.asarray(arr)
            if arr.dtype != np.float32:
                raise TypeError(f"{what} {lname}/{key}: expected float32, got {arr.dtype}")
            d[key] = torch.tensor(arr).to(dev)
        out[lname] = d
    return out


def qat_from_numpy(params_np, state_np, device="cuda"):
    """The reference's QAT pytrees as numpy -- {layer: {'w': HWIO conv or
    (in, out) linear, 'alpha', 'gamma', 'beta', 'bias'}} and {layer:
    {'bn_mean', 'bn_var', 'bn_count', 'input_fl_ema'}}, every leaf float32
    -- -> the port's (params, state) on `device`, values and shapes as
    given."""
    return (tensors_from_numpy(params_np, device, "params"),
            tensors_from_numpy(state_np, device, "state"))


def qat_to_numpy(params, state):
    """qat_from_numpy's inverse: (params, state) -> numpy float32 pytrees,
    each array a copy (the trainer updates its tensors in place)."""

    def convert(tree):
        return {
            lname: {key: t.detach().to("cpu", copy=True).numpy() for key, t in entry.items()}
            for lname, entry in tree.items()
        }

    return convert(params), convert(state)


def _block_entry(meta) -> dict:
    """A block's topology record, as the JAX writer makes it
    (`f8net_tpu/export/bundle.py:49-55`): ResNet blocks carry `shortcut`,
    MobileNetV2 blocks `residual`; each family's missing field is derived
    (MobileNetV1's blocks have neither: no shortcut, not residual)."""
    shortcut = getattr(meta, "shortcut", None)
    residual = getattr(meta, "residual", getattr(meta, "shortcut", 1) is None)
    return {"body": list(meta.body), "shortcut": shortcut, "residual": bool(residual)}


def save_deploy_bundle(path: str, model, plan: QuantPlan, int_params) -> str:
    """Write the npz + JSON pair; returns the npz path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    layers = []
    for p in plan.layers:
        spec = model.graph[p.name]
        entry = {
            "name": p.name,
            "input_fl": p.input_fl,
            "weight_fl": p.weight_fl,
            "input_symmetric": p.input_symmetric,
            "kind": "linear" if isinstance(spec, LinearSpec) else "conv",
        }
        if isinstance(spec, ConvBNSpec):
            entry.update(stride=list(spec.stride), padding=list(spec.padding), groups=spec.groups)
        layers.append(entry)
        for key in ("w", "b"):
            if key in int_params[p.name]:
                arrays[f"{p.name}/{key}"] = int_params[p.name][key].detach().cpu().numpy()
    topo = {
        "model": model.name,
        "num_classes": model.num_classes,
        "block_setting": model.block_setting,
        "blocks": [_block_entry(m) for m in model.blocks],
        "layers": layers,
        "cfg": {
            "normalize": model.cfg.normalize,
            "quant_avgpool": model.cfg.quant_avgpool,
            "pool_fusing": model.cfg.pool_fusing,
        },
    }
    npz = path if path.endswith(".npz") else path + ".npz"
    np.savez(npz, **arrays)
    with open(npz + ".json", "w") as f:
        json.dump(topo, f, indent=1)
    return npz


def load_deploy_bundle(path: str, device="cuda") -> Tuple[dict, QuantPlan, dict]:
    """Read a bundle -> (topology, QuantPlan, int params on `device`)."""
    npz = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz) as z:
        flat = {k: z[k] for k in z.files}
    with open(npz + ".json") as f:
        topo = json.load(f)
    records = [
        (e["name"], e["input_fl"], e["weight_fl"], e["input_symmetric"]) for e in topo["layers"]
    ]
    arrays = {
        e["name"]: {
            key: flat[f"{e['name']}/{key}"] for key in ("w", "b") if f"{e['name']}/{key}" in flat
        }
        for e in topo["layers"]
    }
    plan, params = params_from_numpy(records, arrays, device)
    return topo, plan, params


def model_from_topology(topo: dict, image_size: int = 224):
    """Rebuild a bundle's model graph (the bundle does not record the image
    size, which sets the average pool's extent).  Every block's body,
    shortcut and residual flag must match the graph's."""
    cfg = QuantConfig(**topo["cfg"])
    model = get_model(topo["model"], cfg, num_classes=topo["num_classes"], image_size=image_size)
    keys = ("body", "shortcut", "residual")
    blocks = [{k: b[k] for k in keys} for b in topo["blocks"]]
    if blocks != [_block_entry(m) for m in model.blocks]:
        raise ValueError(f"bundle topology does not match the {topo['model']} graph")
    return model
