"""Bake-time channel padding (the port of `f8net_tpu/quant/pad_channels.py`):
narrow channel dimensions grow to a multiple with ZERO weights, bit-exact by
construction.  `IntEngine(..., pad_channels_to=N)` applies it before it
packs its weights.

Why it is bit-exact: a padded output channel has zero weights and a zero
bias, so its accumulator is exactly 0; ReLU and requantization map 0 to 0
(an unsigned int8 operand packs it to -128, and the zero-point bias derived
from the PADDED weights adds 128 * 0 for a padded input channel).  A padded
input channel meets zero weights and adds exactly 0 to every real
accumulator.  Residual adds see both sides padded alike (padding is a
function of the channel count, so equal counts pad equally).  The
classifier reads the padded rows through zero weights: the logits are the
unpadded engine's.

The padded model is an engine artifact: its graph and int params agree with
each other, not with the float params and state, so QAT training and the
QAT eval modes are never padded.  The plan is unchanged (a per-layer format
has no channel dimension).  On the card the padded engine sends its kernels
channel counts the unpadded one never does (MobileNetV2's 24-, 40- and
80-wide layers at 64 or 128, ResNet's 64-wide stem and stage 0 at 128).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..nn.spec import ConvBNSpec, LayerGraph, LinearSpec


def _pad_to(c: int, multiple: int, threshold: int) -> int:
    """Channel padding policy: channels below `threshold` round up to the
    next multiple of `multiple`; image inputs (c <= 4) and already-wide
    dims stay."""
    if c <= 4 or c >= threshold:
        return c
    return int(-(-c // multiple) * multiple)


def pad_channels(
    model,
    int_params: Dict[str, Dict[str, torch.Tensor]],
    multiple: int = 128,
    threshold: int = 128,
) -> Tuple[object, Dict[str, Dict[str, torch.Tensor]]]:
    """(padded model, padded int params) for the integer engine.

    `int_params` is bake_plan's output (int8 weights 'w', int32 biases
    'b'); a precomputed 'b_zp' is dropped, and the engine derives it again
    from the padded weights.  Depthwise layers keep groups = in = out
    channels."""
    pad = lambda c: _pad_to(c, multiple, threshold)

    new_specs, new_params = {}, {}
    for name in model.graph.names():
        spec = model.graph[name]
        entry = {k: v for k, v in int_params[name].items() if k != "b_zp"}
        if isinstance(spec, ConvBNSpec):
            ci, co = spec.in_ch, spec.out_ch
            pci, pco = pad(ci), pad(co)
            if spec.is_depthwise:  # weights (kh, kw, 1, C): the group count is C
                if not ci == co == spec.groups:
                    raise ValueError(f"{name}: depthwise with in {ci}, out {co}, "
                                     f"groups {spec.groups}")
                new_specs[name] = dataclasses.replace(spec, in_ch=pci, out_ch=pco, groups=pci)
                entry["w"] = F.pad(entry["w"], (0, pco - co))
            else:
                if spec.groups != 1:
                    raise ValueError(f"{name}: grouped conv (groups {spec.groups})")
                new_specs[name] = dataclasses.replace(spec, in_ch=pci, out_ch=pco)
                entry["w"] = F.pad(entry["w"], (0, pco - co, 0, pci - ci))
            if "b" in entry:
                entry["b"] = F.pad(entry["b"], (0, pco - co))
        elif isinstance(spec, LinearSpec):
            fi = spec.in_features
            pfi = pad(fi)
            new_specs[name] = dataclasses.replace(spec, in_features=pfi)
            entry["w"] = F.pad(entry["w"], (0, 0, 0, pfi - fi))
        else:
            raise TypeError(f"{name}: {type(spec).__name__}")
        new_params[name] = entry

    return dataclasses.replace(model, graph=LayerGraph(new_specs)), new_params
