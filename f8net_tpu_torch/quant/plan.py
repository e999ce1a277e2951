"""QuantPlan: a trained model frozen into static integer constants (the
port of `f8net_tpu/quant/plan.py`).

A plan holds, per conv/linear layer, the static fraclens as Python ints:
every requantization in the engine is a shift by an amount known when the
plan is loaded.  `bake_plan` makes one from the QAT forward's trained
(params, state), with int8 weights and int32 biases at each layer's
accumulator scale; plans also come from a deploy bundle or from
`export.bundle.params_from_numpy`.  Baking runs once, outside the hot path,
on whatever device the params are on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from ..nn.pool import avgpool_scale_for, avgpool_shift_for
from ..nn.quant_layers import fix_scaling, input_fraclen
from ..nn.spec import ConvBNSpec, LinearSpec
from ..ops.fxp import fix_quant, fraclen_gridsearch, metric2fraclen, metric_fn, sqrt_rn


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Static quantization facts for one conv/linear layer."""

    name: str
    input_fl: int
    weight_fl: int
    input_symmetric: bool  # double_side: signed (two's-complement) input

    @property
    def out_fl(self) -> int:
        return self.input_fl + self.weight_fl


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    layers: Tuple[LayerPlan, ...]

    def __getitem__(self, name: str) -> LayerPlan:
        return self._index()[name]

    def _index(self) -> Dict[str, LayerPlan]:
        if not hasattr(self, "_idx"):
            object.__setattr__(self, "_idx", {p.name: p for p in self.layers})
        return self._idx


def _weight_metric_axes_conv(cfg):
    return (0, 1, 2) if cfg.format_type == "per_channel" else (0, 1, 2, 3)


def folded_weight_bias(graph, cfg, name, params, state):
    """Eval-time effective float weight and bias of a ConvBN layer, before
    quantization and before any pool-fusing scale (BN and both PACT scales
    folded in)."""
    spec = graph[name]
    p = params[name]
    w = p["w"]
    if cfg.rescale_forward_conv:
        kh, kw = spec.kernel
        sd = torch.std(w.detach(), correction=1)
        if cfg.rescale_type == "constant":
            w = w * ((1.0 / math.sqrt(spec.out_ch * kh * kw)) / sd)
        elif cfg.rescale_type == "stddev":
            w = w * (torch.std(w.detach(), correction=1) / sd)
        else:
            raise NotImplementedError(cfg.rescale_type)
    bn_mean = state[name]["bn_mean"]
    bn_std = sqrt_rn(state[name]["bn_var"] + cfg.bn_eps)
    bn_scale = p["gamma"] / bn_std
    fs_self = fix_scaling(graph, cfg, name, params, state)
    fs_next = fix_scaling(graph, cfg, spec.following, params, state)
    if spec.groups == 1:
        w_eff = w * bn_scale * fs_self[None, None, :, None] / fs_next
    elif spec.is_depthwise:
        w_eff = w * bn_scale * fs_self / fs_next
    else:
        raise NotImplementedError("grouped conv with 1 < groups < in_ch")
    return w_eff, (p["beta"] - bn_scale * bn_mean) / fs_next


def _rounded_input_fl(graph, cfg, name, state) -> torch.Tensor:
    spec = graph[name]
    x_wl, _ = graph.input_format(name, cfg)
    fl = input_fraclen(graph, cfg, name, state)
    return torch.clamp(torch.round(fl), 0, x_wl - int(spec.double_side))


def _weight_fl_of(cfg, w_eff, wl, axes) -> torch.Tensor:
    if cfg.format_grid_search:
        return fraclen_gridsearch(w_eff, wl, w_eff.ndim - 1, True).reshape(1)
    m = metric_fn(cfg.metric, axes)(w_eff)
    return torch.clamp(metric2fraclen(m, cfg.metric, 1.0, True), 0, wl - 1).reshape(-1)


def _to_int(v: torch.Tensor, wl: int, fl: float, axis: int, dtype) -> torch.Tensor:
    """v quantized to wl bits at fraclen fl, as integers of `dtype`."""
    q, _ = fix_quant(v, wl, fl, axis, True)
    return torch.round(q * 2.0**fl).to(dtype)


@torch.no_grad()
def bake_plan(model, params, state, cfg=None):
    """Trained (params, state) -> (QuantPlan, int_params) on the params'
    device.  int_params[name] = {'w': int8 HWIO (conv) / (in, out)
    (linear), 'b': int32} at scale 2^(input_fl + weight_fl).  Pool fusing:
    the conversion-time scale 2^shift / k^2 is folded into
    model.pool_fuse_layer's weights and bias."""
    cfg = cfg or model.cfg
    graph = model.graph
    pool_k = model.pool_kernel
    plans, int_params = [], {}
    for name in graph.names():
        spec = graph[name]
        w_wl, _ = graph.weight_format(name, cfg)
        int_b = None
        if isinstance(spec, ConvBNSpec):
            conv_scale = avgpool_scale_for(pool_k) if name == model.pool_fuse_layer else 1.0
            w_eff, bias = folded_weight_bias(graph, cfg, name, params, state)
            w_eff, bias = w_eff * conv_scale, bias * conv_scale
            w_fl = _weight_fl_of(cfg, w_eff, w_wl, _weight_metric_axes_conv(cfg))
            in_fl = _rounded_input_fl(graph, cfg, name, state)
            if w_fl.numel() != 1 or in_fl.numel() != 1:
                raise ValueError("integer conversion requires per_layer formats")
            wf, acc_fl = float(w_fl[0]), float(in_fl[0] + w_fl[0])
            int_w = _to_int(w_eff, w_wl, wf, 3, torch.int8)
            int_b = _to_int(bias, 32, acc_fl, 0, torch.int32)
        elif isinstance(spec, LinearSpec):
            p = params[name]
            w = p["w"]
            axes = (0,) if cfg.format_type == "per_channel" else (0, 1)
            w_fl = _weight_fl_of(cfg, w, w_wl, axes)
            in_fl = _rounded_input_fl(graph, cfg, name, state)
            if w_fl.numel() != 1 or in_fl.numel() != 1:
                raise ValueError("integer conversion requires per_layer formats")
            wf, acc_fl = float(w_fl[0]), float(in_fl[0] + w_fl[0])
            w_q, _ = fix_quant(w, w_wl, wf, 1, True)
            int_w = torch.round(w_q * 2.0**wf).to(torch.int8)
            if spec.bias:
                fs = fix_scaling(graph, cfg, name, params, state)
                ws = 1.0
                if cfg.rescale_forward:
                    sd = float(torch.std(w_q, correction=1))
                    if cfg.rescale_type == "stddev":
                        ws = float(torch.std(w, correction=1)) / sd
                    else:
                        ws = (1.0 / math.sqrt(spec.out_features)) / sd
                int_b = _to_int(p["bias"] / fs / ws, 32, acc_fl, 0, torch.int32)
        else:
            continue
        plans.append(LayerPlan(
            name=name, input_fl=int(in_fl[0]), weight_fl=int(w_fl[0]),
            input_symmetric=bool(spec.double_side),
        ))
        int_params[name] = {"w": int_w} if int_b is None else {"w": int_w, "b": int_b}

    if cfg.quant_avgpool:
        # static form of the reference's runtime int-avgpool overflow checks:
        # the pool's input fraclen is at most the largest conv out_fl (adds
        # align on the max), its output's at most 32, and every sum that
        # does not saturate the classifier's 8-bit grid fits in int32
        shift = avgpool_shift_for(pool_k)
        max_out_fl = max(p.out_fl for p in plans)
        if max_out_fl + shift > 32:
            raise ValueError(f"avgpool output fraclen {max_out_fl + shift} > 32 "
                             f"(pool {pool_k}x{pool_k}, shift {shift})")
        sum_bound = 256 * 2 ** max(max_out_fl + shift - plans[-1].input_fl, 0)
        if sum_bound >= 1 << 31:
            raise ValueError(f"avgpool over {pool_k}x{pool_k} can overflow the int32 "
                             f"accumulator (meaningful-sum bound {sum_bound} >= 2^31)")
    return QuantPlan(tuple(plans)), int_params
