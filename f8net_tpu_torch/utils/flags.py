"""YAML experiment configs with the reference's flag vocabulary (copy of
`f8net_tpu/utils/flags.py`).

Loads the same YAML schema as the reference's apps/*.yml (myutils/config.py):
`!include` composition, `app:<path>` / `bs:<n>` argv tokens, and the LR
linear-scaling rule (lr *= batch/256 with 5 warmup epochs when batch > 256,
config.py:166-172).  The flat YAML dict is split into the typed QuantConfig /
TrainConfig plus an extras dict for trainer-level toggles.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import yaml

from .config import QuantConfig, TrainConfig


class _IncludeLoader(yaml.SafeLoader):
    pass


def _include(loader: _IncludeLoader, node):
    base = os.path.dirname(loader.name)
    with open(os.path.join(base, loader.construct_scalar(node))) as f:
        return yaml.load(f, _IncludeLoader)


_IncludeLoader.add_constructor("!include", _include)


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.load(f, _IncludeLoader) or {}


def parse_argv(argv) -> Tuple[Optional[str], Optional[int], Dict[str, str]]:
    """app:<yml> and bs:<batch> tokens (config.py:152-163)."""
    app, bs, extra = None, None, {}
    for tok in argv:
        if tok.startswith("app:"):
            app = tok[4:]
        elif tok.startswith("bs:"):
            bs = int(tok[3:])
        elif ":" in tok:
            k, v = tok.split(":", 1)
            extra[k] = v
    return app, bs, extra


_QUANT_KEYS = {f.name for f in dataclasses.fields(QuantConfig)}
_TRAIN_KEYS = {f.name for f in dataclasses.fields(TrainConfig)}


def from_flags(flags: Dict[str, Any], batch_size: Optional[int] = None):
    """(QuantConfig, TrainConfig, extras) from a flat reference-style dict."""
    flags = dict(flags)
    if batch_size is not None:
        flags["batch_size"] = batch_size

    # LR linear-scaling rule lives in the config loader, like the reference
    if flags.get("batch_size", 256) > 256 and flags.get("lr") is not None:
        flags["lr"] = flags["lr"] * flags["batch_size"] / 256.0
        flags.setdefault("warmup_epochs", 5)
    flags.setdefault("warmup_epochs", 0)

    qkw = {}
    for k in list(flags.keys()):
        if k in _QUANT_KEYS:
            v = flags[k]
            if k in ("weight_format", "input_format"):
                v = tuple(v)
            qkw[k] = v
    # reference spells the floating flag 'floating_model'; metric may be None
    if qkw.get("metric") is None:
        qkw.pop("metric", None)
    if qkw.get("format_type") is None:
        qkw.pop("format_type", None)
    qcfg = QuantConfig(**qkw)

    tkw = {}
    for k in _TRAIN_KEYS:
        if k in flags and flags[k] is not None:
            v = flags[k]
            if k in ("topk", "multistep_lr_milestones"):
                v = tuple(v)
            tkw[k] = v
    if flags.get("finetune_iters") is not None:
        tkw["finetune_iters"] = int(flags["finetune_iters"])
    tcfg = TrainConfig(**tkw)

    extras = {k: v for k, v in flags.items() if k not in _QUANT_KEYS | _TRAIN_KEYS}
    return qcfg, tcfg, extras


def load_experiment(path: str, batch_size: Optional[int] = None):
    return from_flags(load_yaml(path), batch_size)


def experiment_setting(qcfg, tcfg, extras) -> str:
    """Config-dims identity string used as the log/checkpoint subdirectory
    (the reference's poor-man's experiment tracking, fix_train.py:608-673)."""
    parts = [
        f"ptcv_pretrained_{bool(extras.get('ptcv_pretrained', False))}",
        f"nvidia_pretrained_{bool(extras.get('nvidia_pretrained', False))}",
        f"finetune_iters_{tcfg.finetune_iters if tcfg.finetune_iters is not None else 'inf'}",
        f"bn_calib_before_test_{tcfg.bn_calib_before_test}",
        f"quant_avgpool_{qcfg.quant_avgpool}",
        f"pool_fusing_{qcfg.pool_fusing}",
        f"weight_format_wl_{qcfg.weight_format[0]}_fl_{qcfg.weight_format[1]}",
        f"input_format_wl_{qcfg.input_format[0]}_fl_{qcfg.input_format[1]}",
        f"rescale_forward_{qcfg.rescale_forward}",
        f"rescale_type_{qcfg.rescale_type}",
        f"input_fraclen_sharing_{qcfg.input_fraclen_sharing}",
        f"floating_model_{qcfg.floating_model}",
        f"no_clipping_{qcfg.no_clipping}",
        f"format_type_{qcfg.format_type}",
        f"format_from_metric_{qcfg.format_from_metric}",
        f"metric_{qcfg.metric}",
        f"format_grid_search_{qcfg.format_grid_search}",
        f"lr_{tcfg.lr}",
        f"weight_decay_scheme_{tcfg.weight_decay_scheme}",
        f"normalize_{qcfg.normalize}",
        f"weight_decay_{tcfg.weight_decay}",
    ]
    return os.path.join(*parts)
