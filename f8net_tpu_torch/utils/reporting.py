"""Per-layer quantization state report (the port of
`f8net_tpu/utils/reporting.py`).

Prints the same `layer name:` / `input_fraclen:` / `weight_fraclen:` triplet
stream the reference dumps after test/training (fix_train.py:971-991,
1135-1156).  These dumps are load-bearing there: the fraclen_visual tooling
parses them into per-layer fraclen profiles -- ours emits the identical
vocabulary so that tooling (and golden-fixture comparison against the bundled
.out logs) keeps working.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.quant_layers import fix_scaling, input_fraclen
from ..nn.spec import ConvBNSpec
from ..quant.plan import folded_weight_bias, _weight_fl_of, _weight_metric_axes_conv


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@torch.no_grad()
def fraclen_report(model, params, state, cfg=None, print_fn=print):
    """Dump alpha/format/fraclen state for every quantized layer."""
    cfg = cfg or model.cfg
    g = model.graph
    for name in g.names():
        spec = g[name]
        print_fn(f"layer name: {name}.")
        print_fn(f"alpha: {float(_np(params[name]['alpha'])):.6f}.")
        if spec.master is not None:
            print_fn(f"master layer alpha: {float(_np(params[spec.master]['alpha'])):.6f}.")
        else:
            print_fn("master layer: None.")
        print_fn(f"weight format: {g.weight_format(name, cfg)}.")
        print_fn(f"input format: {g.input_format(name, cfg)}.")
        fs = _np(fix_scaling(g, cfg, name, params, state))
        print_fn(f"fix scaling: {fs}.")
        if isinstance(spec, ConvBNSpec) and spec.following is not None:
            fs_n = _np(fix_scaling(g, cfg, spec.following, params, state))
            print_fn(f"following layer fix scaling: {fs_n}.")
        if cfg.format_from_metric or cfg.format_grid_search:
            in_fl = _np(input_fraclen(g, cfg, name, state))
            print_fn(f"input_fraclen: {in_fl}.")
            w_wl, _ = g.weight_format(name, cfg)
            if isinstance(spec, ConvBNSpec):
                w_eff, _ = folded_weight_bias(g, cfg, name, params, state)
                w_fl = _weight_fl_of(cfg, w_eff, w_wl, _weight_metric_axes_conv(cfg))
            else:
                axes = (0,) if cfg.format_type == "per_channel" else (0, 1)
                w_fl = _weight_fl_of(cfg, params[name]["w"], w_wl, axes)
            print_fn(f"weight_fraclen: {_np(w_fl)}.")


def parse_fraclen_report(text: str):
    """Parse a report (ours or the reference's .out logs) into
    {layer: {'input_fraclen': [...], 'weight_fraclen': [...]}} -- the inverse
    used by the fraclen_visual-style tooling and golden-fixture tests."""
    out = {}
    cur = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("layer name:"):
            cur = line.split("layer name:")[1].strip().rstrip(".")
            out[cur] = {}
        elif cur is not None and line.startswith(("input_fraclen:", "weight_fraclen:")):
            key, val = line.split(":", 1)
            nums = [
                float(t)
                for t in val.replace("[", " ").replace("]", " ").replace(",", " ").rstrip(".").split()
                if _is_float(t)
            ]
            out[cur][key.strip()] = nums
    return out


def _is_float(t: str) -> bool:
    try:
        float(t)
        return True
    except ValueError:
        return False
