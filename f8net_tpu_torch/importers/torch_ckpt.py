"""PyTorch checkpoint importers (the port of `f8net_tpu/importers/torch_ckpt.py`).

Three dialects, mirroring the reference's loaders so its Model Zoo and
pretrained-init workflows carry over (fix_train.py:56-255, 840-892):

  * reference F8Net checkpoints (best_model.pt / latest_checkpoint.pt):
    named quantized modules incl. alpha and input_fraclen buffers -- enables
    accuracy-parity evaluation without retraining;
  * pytorchcv-style plain CNN state dicts: (conv, bn)* fc tensors consumed in
    module order and shape-checked against our layer graph (ptcv_load);
  * NVIDIA DeepLearningExamples ResNet50: conv/bn/downsample/fc key patterns
    re-assembled into the same ordered list (nvidia_load).

Layout conversion: torch OIHW conv weights -> HWIO; torch (out,in) linear ->
(in,out).  The functions accept any mapping of numpy arrays or tensors and
fill the port's (params, state) dicts of tensors, on the device of the
params they are given (a fresh `Model.init` on `device` when none are).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..nn.spec import ConvBNSpec, LinearSpec


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _conv_w(x) -> np.ndarray:
    return np.transpose(_np(x), (2, 3, 1, 0)).astype(np.float32)  # OIHW -> HWIO


def _fc_w(x) -> np.ndarray:
    w = _np(x)
    if w.ndim == 4:  # 1x1-conv classifier variants (ptcv mobilenets)
        assert w.shape[-1] == 1 and w.shape[-2] == 1
        w = w[..., 0, 0]
    return np.transpose(w, (1, 0)).astype(np.float32)  # (out,in) -> (in,out)


def load_torch_file(path: str) -> Dict[str, np.ndarray]:
    """A .pt file's state dict as numpy arrays (a {'model': state dict}
    checkpoint unwrapped).  Read with `weights_only=True`: tensors and
    plain containers only, as the Model Zoo's files and plain state dicts
    are.  A file that pickles other objects beside its weights raises
    `pickle.UnpicklingError` (unpickling it would run the file's code):
    load such a file you trust with torch.load yourself and pass its state
    dict to the importers, which take any mapping."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    return {k: _np(v) for k, v in ckpt.items()}


def _fresh(model, params, state, device):
    """(plain dict copies of params and state, or a fresh init on `device`;
    their device)."""
    if params is None or state is None:
        params, state = model.init(torch.Generator().manual_seed(0), device=device)
    dev = next(iter(params["classifier"].values())).device
    return {k: dict(v) for k, v in params.items()}, {k: dict(v) for k, v in state.items()}, dev


def _to_tensors(tree, device):
    """numpy leaves -> tensors on `device`; tensor leaves stay."""
    return {
        k: {
            kk: torch.from_numpy(np.ascontiguousarray(vv)).to(device)
            if isinstance(vv, np.ndarray) else vv
            for kk, vv in v.items()
        }
        for k, v in tree.items()
    }


def load_reference_checkpoint(model, ckpt, params=None, state=None, device="cuda"):
    """Import a trained F8Net checkpoint into (params, state).

    `ckpt` is a state-dict mapping (or a path to a .pt file).  Handles
    optional 'module.' prefixes (DataParallel wrapping) and the reference's
    module naming: head.0.*, stage_i_layer_j.body.k.*, *.shortcut.0.*,
    tail.0.*, classifier.0.*.
    """
    if isinstance(ckpt, str):
        ckpt = load_torch_file(ckpt)
    ckpt = {k[len("module.") :] if k.startswith("module.") else k: v for k, v in ckpt.items()}

    params, state, dev = _fresh(model, params, state, device)

    def ref_name(lname: str) -> str:
        # our graph names drop the nn.Sequential index of head/tail/classifier
        if lname in ("head", "tail", "classifier"):
            return f"{lname}.0"
        return lname

    for lname in model.graph.names():
        spec = model.graph[lname]
        r = ref_name(lname)
        if isinstance(spec, ConvBNSpec):
            params[lname]["w"] = np.asarray(_conv_w(ckpt[f"{r}.conv.weight"]))
            params[lname]["gamma"] = _np(ckpt[f"{r}.bn.weight"]).astype(np.float32)
            params[lname]["beta"] = _np(ckpt[f"{r}.bn.bias"]).astype(np.float32)
            state[lname]["bn_mean"] = _np(ckpt[f"{r}.bn.running_mean"]).astype(np.float32)
            state[lname]["bn_var"] = _np(ckpt[f"{r}.bn.running_var"]).astype(np.float32)
            if f"{r}.alpha" in ckpt:
                params[lname]["alpha"] = _np(ckpt[f"{r}.alpha"]).astype(np.float32).reshape(())
            if f"{r}.input_fraclen" in ckpt:
                state[lname]["input_fl_ema"] = (
                    _np(ckpt[f"{r}.input_fraclen"]).astype(np.float32).reshape(-1)
                )
        elif isinstance(spec, LinearSpec):
            params[lname]["w"] = _fc_w(ckpt[f"{r}.weight"])
            if spec.bias and f"{r}.bias" in ckpt:
                params[lname]["bias"] = _np(ckpt[f"{r}.bias"]).astype(np.float32)
            if f"{r}.alpha" in ckpt:
                params[lname]["alpha"] = _np(ckpt[f"{r}.alpha"]).astype(np.float32).reshape(())
            if f"{r}.input_fraclen" in ckpt:
                state[lname]["input_fl_ema"] = (
                    _np(ckpt[f"{r}.input_fraclen"]).astype(np.float32).reshape(-1)
                )
        else:
            continue
    return _to_tensors(params, dev), _to_tensors(state, dev)


ConvBN = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]  # w,g,b,mean,var
FC = Tuple[np.ndarray, Optional[np.ndarray]]  # w, bias


def parse_plain_cnn_state_dict(sd: Dict[str, np.ndarray]) -> List[tuple]:
    """Walk a pytorchcv-style state dict in order, grouping conv->bn pairs and
    the final fc, like the reference's named_modules walk (fix_train.py:83-92).
    Returns a list of ('conv', w) / ('bn', g, b, mean, var) / ('fc', w, bias)
    entries in order."""
    entries: List[tuple] = []
    keys = list(sd.keys())
    i = 0
    while i < len(keys):
        k = keys[i]
        if k.endswith("num_batches_tracked"):
            i += 1
            continue
        base = k.rsplit(".", 1)[0]
        group = {kk.rsplit(".", 1)[1]: sd[kk] for kk in keys if kk.rsplit(".", 1)[0] == base}
        if "running_mean" in group:
            entries.append(
                ("bn", group["weight"], group["bias"], group["running_mean"], group["running_var"])
            )
        elif "weight" in group:
            w = group["weight"]
            if np.ndim(w) == 4 and not (w.shape[-1] == 1 and w.shape[-2] == 1 and "output" in base):
                entries.append(("conv", w, group.get("bias")))
            else:
                entries.append(("fc", w, group.get("bias")))
        i += len(group)
    return entries


def parse_nvidia_state_dict(sd: Dict[str, np.ndarray]) -> List[tuple]:
    """NVIDIA DeepLearningExamples ResNet50 key patterns -> ordered entries
    (conv/bn/downsample state machine of fix_train.py:137-210)."""
    entries: List[tuple] = []
    pend: List[np.ndarray] = []
    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[1]
        if "conv" in k and "weight" in leaf:
            entries.append(("conv", v, None))
        elif "bn" in k or ("downsample" in k and k.split(".")[-2] == "1"):
            if leaf == "weight":
                pend = [v]
            elif leaf == "bias":
                pend.append(v)
            elif leaf == "running_mean":
                pend.append(v)
            elif leaf == "running_var":
                pend.append(v)
            elif leaf == "num_batches_tracked":
                entries.append(("bn", *pend))
                pend = []
        elif "downsample" in k and k.split(".")[-2] == "0":
            if leaf == "weight":
                entries.append(("conv", v, None))
        elif "fc" in k:
            if leaf == "weight":
                pend = [v]
            elif leaf == "bias":
                entries.append(("fc", pend[0], v))
                pend = []
    return entries


def load_ordered_conv_bn_fc(model, entries: Sequence[tuple], params=None, state=None,
                            device="cuda"):
    """Fill (params, state) from ordered ('conv', ...)/('bn', ...)/('fc', ...)
    entries against model.conv_order with shape asserts (ptcv_load semantics,
    fix_train.py:93-133)."""
    params, state, dev = _fresh(model, params, state, device)

    it = iter(entries)
    for lname in model.conv_order:
        spec = model.graph[lname]
        if isinstance(spec, ConvBNSpec):
            kind, w, _bias = next(it)
            assert kind == "conv", (lname, kind)
            w = _conv_w(w)
            assert w.shape == tuple(spec.weight_shape()), (lname, w.shape)
            params[lname]["w"] = w
            kind, g, b, mean, var = next(it)
            assert kind == "bn", (lname, kind)
            assert _np(g).shape == (spec.out_ch,)
            params[lname]["gamma"] = _np(g).astype(np.float32)
            params[lname]["beta"] = _np(b).astype(np.float32)
            state[lname]["bn_mean"] = _np(mean).astype(np.float32)
            state[lname]["bn_var"] = _np(var).astype(np.float32)
        elif isinstance(spec, LinearSpec):
            kind, w, bias = next(it)
            assert kind == "fc", (lname, kind)
            w = _fc_w(w)
            assert w.shape == tuple(spec.weight_shape()), (lname, w.shape)
            params[lname]["w"] = w
            if spec.bias and bias is not None:
                params[lname]["bias"] = _np(bias).astype(np.float32)
    leftover = sum(1 for _ in it)
    assert leftover == 0, f"{leftover} unconsumed checkpoint entries"
    return _to_tensors(params, dev), _to_tensors(state, dev)


def load_hawq_checkpoint(model, hawq_sd, params=None, state=None, device="cuda"):
    """HAWQ checkpoints store quant-wrapped keys; the reference filters the
    scaling/min/max/integer-weight entries and maps the remainder onto the
    plain CNN ordering (fix_train.py:67-82).  Same here: filter, then reuse
    the ordered conv/bn/fc walk."""
    drop = ("scaling_factor", "num_batches_tracked", "weight_integer", "min", "max")
    filtered = {
        k: v for k, v in hawq_sd.items() if not any(t in k for t in drop)
    }
    entries = parse_plain_cnn_state_dict(filtered)
    return load_ordered_conv_bn_fc(model, entries, params, state, device)
