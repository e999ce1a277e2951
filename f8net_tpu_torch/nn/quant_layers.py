"""Quantized layer semantics for QAT: fused ConvBN and Linear with F8Net's
fixed-point formats (the port of `f8net_tpu/nn/quant_layers.py`).

Plain functions on dicts of tensors that mirror the reference's pytrees:
per layer, params {'w', 'alpha', 'gamma', 'beta'} (conv, HWIO) or {'w',
'alpha', 'bias'} (linear, (in, out)), and state {'bn_mean', 'bn_var',
'bn_count', 'input_fl_ema'} (conv) or {'input_fl_ema'} (linear).  Each
layer application returns its output and a dict of state updates; nothing
is mutated in place.  Activations are NHWC.

The scheme: activations and weights are quantized to 8-bit fixed point with
per-tensor fraclens chosen from statistics (`ops.fxp.metric2fraclen`), and
the PACT clipping level alpha is reformulated as the scale
    fix_scaling = 2^fl * |alpha| / (2^(8 - signed) - 1),
folded with BatchNorm into the weights, so the integer graph needs no
clipping and no float scale.

Float32 convolutions and matmuls run in full float32 on the card (TF32 off,
`utils.float32_exact`): the batch-statistics conv reads fix_scaling * x,
which lies on no grid, and TF32 would move sigma and so the fraclens.
`cfg.train_conv_bf16` (the reference's `_conv2d_bf16`) is the one
exception, opted into: in train and calib mode, outside floating_wo_clip,
both the batch-statistics conv and the output conv round their operands to
bfloat16 and accumulate in float32 (`conv2d_bf16`).  On the card that conv
runs on TF32 tensor cores, which hold bfloat16 values exactly, so every
product is exact; its backward stays in full float32 on the unrounded
operands, as the reference's custom VJP does.

Data parallelism: given a process group, the training forward's batch
statistics span the global batch that the group's processes hold in
shards -- the input fraclen's metric (or grid search), BatchNorm's batch
mean, variance and count -- as in the JAX package's jitted step over
Mesh('data'), where GSPMD inserts the collectives.  The gradient flows
through those all-reduces (`parallel.AllReduceSum`).  Weight statistics
need none: every process holds the same weights.

Tensor parallelism (`parallel/tp_train.py`): given a layer's Cut (`tp`),
its params are this rank's out-channel slice; the layer computes only
those channels -- both convs, the BN statistics, the output -- from its
whole input through f, reads its weight statistics over the whole weight
(the model line), all-gathers its BN running-statistic updates, and its
output leaves through g, whole.  Given none (or `WHOLE`) it computes
everything, as above.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops.fxp import (
    fix_quant, fraclen_gridsearch, global_moments, metric2fraclen, metric_fn, sqrt_rn,
    ste_quant,
)
from ..parallel.tp_train import WHOLE
from ..utils.device import float32_exact, tf32_conv
from .pool import avgpool_shift_for
from .spec import ConvBNSpec, LayerGraph, LinearSpec

INT32_BOUND = float((1 << 31) - 1)


class Act(NamedTuple):
    """An activation and, in the integer-simulation eval mode, its output
    fraclen (None elsewhere)."""

    x: torch.Tensor
    fl: Optional[torch.Tensor] = None


def as_act(v) -> Act:
    return v if isinstance(v, Act) else Act(v, None)


# -- initialization -----------------------------------------------------------


def init_conv_params(generator: torch.Generator, spec: ConvBNSpec, device) -> Dict[str, torch.Tensor]:
    """He-normal weight (std sqrt(2 / (kh * kw * out_ch))), BN gamma 1 and
    beta 0, PACT alpha 8 -- the reference's distributions, drawn from
    `generator` (on its own device) and moved to `device`."""
    kh, kw = spec.kernel
    n = kh * kw * spec.out_ch
    w = torch.randn(spec.weight_shape(), generator=generator, device=generator.device)
    return {
        "w": (w * math.sqrt(2.0 / n)).to(device),
        "alpha": torch.tensor(8.0, device=device),
        "gamma": torch.ones(spec.out_ch, device=device),
        "beta": torch.zeros(spec.out_ch, device=device),
    }


def init_linear_params(generator: torch.Generator, spec: LinearSpec, device) -> Dict[str, torch.Tensor]:
    w = torch.randn(spec.weight_shape(), generator=generator, device=generator.device)
    p = {"w": (w * 0.01).to(device), "alpha": torch.tensor(8.0, device=device)}
    if spec.bias:
        p["bias"] = torch.zeros(spec.out_features, device=device)
    return p


def _ema_shape(cfg, in_ch: int):
    return (in_ch,) if cfg.format_type == "per_channel" else (1,)


def init_conv_state(cfg, spec: ConvBNSpec, device) -> Dict[str, torch.Tensor]:
    _, x_fl = cfg.input_format
    return {
        "bn_mean": torch.zeros(spec.out_ch, device=device),
        "bn_var": torch.ones(spec.out_ch, device=device),
        "bn_count": torch.zeros((), device=device),
        "input_fl_ema": torch.full(_ema_shape(cfg, spec.in_ch), float(x_fl), device=device),
    }


def init_linear_state(cfg, spec: LinearSpec, device) -> Dict[str, torch.Tensor]:
    """A scalar input fraclen: per-channel formats are not supported for
    linear layers (the reference falls back to a scalar too)."""
    _, x_fl = cfg.input_format
    return {"input_fl_ema": torch.full((1,), float(x_fl), device=device)}


# -- fix_scaling: the PACT clipping level as a fixed-point scale ----------------


def _alpha_of(graph: LayerGraph, name: str, params) -> torch.Tensor:
    """alpha with master delegation: the master's first, then 1 for
    weight-only layers."""
    spec = graph[name]
    if spec.master is not None:
        return _alpha_of(graph, spec.master, params)
    if spec.weight_only:
        return torch.ones_like(params[name]["alpha"])
    return params[name]["alpha"]


def ema_owner(graph: LayerGraph, cfg, name: str) -> str:
    """The layer whose input_fl_ema buffer `name` reads and writes."""
    spec = graph[name]
    if (not spec.weight_only) and cfg.input_fraclen_sharing and spec.master is not None:
        return spec.master
    return name


def input_fraclen(graph: LayerGraph, cfg, name: str, state) -> torch.Tensor:
    """8 for weight-only layers, else the (possibly the master's) EMA."""
    spec = graph[name]
    if spec.weight_only:
        return torch.full((1,), 8.0, device=state[name]["input_fl_ema"].device)
    return state[ema_owner(graph, cfg, name)]["input_fl_ema"]


def fix_scaling(graph: LayerGraph, cfg, name: str, params, state) -> torch.Tensor:
    """2^fl * |alpha| / (2^(wl - signed) - 1) with the EMA-rounded fraclen;
    shape (1,) or (in_ch,) per channel."""
    spec = graph[name]
    alpha = torch.abs(_alpha_of(graph, name, params))
    if cfg.no_clipping:
        return torch.ones_like(alpha).reshape(-1)
    if spec.weight_only:
        return alpha.reshape(-1)
    x_wl, x_fl = graph.input_format(name, cfg)
    denom = float(2 ** (x_wl - int(spec.double_side)) - 1)
    if cfg.floating_model and not cfg.floating_wo_clip:
        return (2.0 ** float(x_fl) * alpha / denom).reshape(-1)
    fl = input_fraclen(graph, cfg, name, state)
    fl = torch.clamp(torch.round(fl), 0.0, float(x_wl - int(spec.double_side)))
    return torch.exp2(fl) * alpha / denom


def all_fix_scalings(graph: LayerGraph, cfg, params, state) -> Dict[str, torch.Tensor]:
    return {name: fix_scaling(graph, cfg, name, params, state) for name in graph.names()}


# -- input quantization (conv and linear) -----------------------------------------


def _input_metric_axes(cfg, ndim: int):
    if cfg.format_type == "per_channel":
        return tuple(range(ndim - 1))  # all but the channel axis
    return tuple(range(ndim))


def _quantize_input(graph, cfg, name, state, x, training: bool, group=None):
    """(x quantized, the fraclen used, state updates): the fresh metric's
    fraclen (over the group's global batch, given a group) and an EMA
    update in training, the rounded EMA at eval."""
    spec = graph[name]
    ds = spec.double_side
    updates = {}
    caxis = x.ndim - 1

    if spec.weight_only:
        x_val = x if ds else F.relu(x)
        return x_val, torch.full((1,), 8.0, device=x.device), updates
    if cfg.floating_wo_clip:
        return (x if ds else F.relu(x)), None, updates

    x_wl, x_fl_default = graph.input_format(name, cfg)
    if cfg.floating_model:
        fl = torch.full((1,), float(x_fl_default), device=x.device)
        return ste_quant(x, fl, x_wl, caxis, ds, True), fl, updates

    if not (cfg.format_grid_search or cfg.format_from_metric):
        raise NotImplementedError("need format_from_metric or format_grid_search")

    owner = ema_owner(graph, cfg, name)
    ema = state[owner]["input_fl_ema"]
    if training:
        if cfg.format_grid_search:
            fl = fraclen_gridsearch(x, x_wl, caxis, ds, group).reshape(1)
        else:
            if x_wl != 8:
                raise NotImplementedError("word lengths other than 8 bit")
            m = metric_fn(cfg.metric, _input_metric_axes(cfg, x.ndim), group)(x)
            fl = metric2fraclen(m, cfg.metric, 1.0, ds)
            fl = torch.clamp(fl, 0.0, float(x_wl - int(ds))).reshape(-1)
        x_val = ste_quant(x, fl, x_wl, caxis, ds, False)
        mom = cfg.momentum_for_metric
        updates[owner] = {"input_fl_ema": mom * fl + (1.0 - mom) * ema}
        return x_val, fl, updates
    fl = torch.clamp(torch.round(ema), 0.0, float(x_wl - int(ds)))
    return ste_quant(x, fl, x_wl, caxis, ds, False), fl, updates


# -- ConvBN -----------------------------------------------------------------------


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, spec: ConvBNSpec) -> torch.Tensor:
    y = F.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=spec.stride,
        padding=spec.padding, groups=spec.groups,
    )
    return y.permute(0, 2, 3, 1)


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, spec: ConvBNSpec) -> torch.Tensor:
    """NHWC x HWIO -> NHWC float conv (the reference's lax conv), in full
    float32 on the card."""
    with float32_exact():
        return _conv_nhwc(x, w, spec)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest-even onto bfloat16's grid and
    carried in float32 (XLA's convert to bf16)."""
    return t.to(torch.bfloat16).to(torch.float32)


def _require_tf32(device: torch.device) -> None:
    """The flagged conv's contract on a card: TF32 tensor cores (sm_80 and
    up); without them it raises rather than run the float32 conv."""
    if torch.cuda.get_device_capability(device) < (8, 0):
        raise RuntimeError(
            f"train_conv_bf16: {torch.cuda.get_device_name(device)} has no TF32 tensor cores"
        )


class Conv2dBF16Operands(torch.autograd.Function):
    """The reference's `_conv2d_bf16` (f8net_tpu/nn/quant_layers.py:255-291):
    x and w rounded to bfloat16, products accumulated in float32, a float32
    output.  The rounded operands are exact in TF32 (10 mantissa bits
    against bfloat16's 7), so on a card the conv runs on TF32 tensor cores
    (`utils.device.tf32_conv`) and forms every product exactly; on the CPU it is
    the plain float32 conv of the rounded operands.  Backward: the float32
    conv's gradients (TF32 off) from the unrounded x and w, as the
    reference's `_conv2d_bf16_bwd`."""

    @staticmethod
    def forward(ctx, x, w, spec):
        ctx.spec = spec
        ctx.save_for_backward(x, w)
        if x.device.type == "cuda":
            _require_tf32(x.device)
        with tf32_conv():
            return _conv_nhwc(bf16_round(x), bf16_round(w), spec)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        spec = ctx.spec
        need_x, need_w = ctx.needs_input_grad[:2]
        with float32_exact():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
                list(spec.stride), list(spec.padding), [1, 1], False, [0, 0], spec.groups,
                [need_x, need_w, False],
            )
        return (None if gx is None else gx.permute(0, 2, 3, 1),
                None if gw is None else gw.permute(2, 3, 1, 0), None)


def conv2d_bf16(x: torch.Tensor, w: torch.Tensor, spec: ConvBNSpec) -> torch.Tensor:
    """NHWC x HWIO -> NHWC conv of bfloat16-rounded operands with float32
    accumulation and a float32 backward (Conv2dBF16Operands)."""
    return Conv2dBF16Operands.apply(x, w, spec)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    with float32_exact():
        return x @ w


def _weight_metric_axes(cfg):
    # HWIO: per-channel statistics are per output channel
    return (0, 1, 2) if cfg.format_type == "per_channel" else (0, 1, 2, 3)


def _std(w, group=None):
    """The sample standard deviation of the whole (detached) weight; with
    a group, of the weight whose slices its ranks hold."""
    if group is None:
        return torch.std(w.detach(), correction=1)
    return metric_fn("std", range(w.ndim), group)(w).reshape(())


def _conv_weight_rescale(cfg, spec: ConvBNSpec, w, group=None):
    """Forward weight standardization before the fold (detached std, of
    the whole weight)."""
    if not cfg.rescale_forward_conv:
        return w
    kh, kw = spec.kernel
    sd = _std(w, group)
    if cfg.rescale_type == "stddev":
        scale = _std(w, group) / sd
    elif cfg.rescale_type == "constant":
        scale = (1.0 / math.sqrt(spec.out_ch * kh * kw)) / sd
    else:
        raise NotImplementedError(cfg.rescale_type)
    return w * scale


def _fold_scales(spec: ConvBNSpec, w, bn_scale, fs_self, fs_next):
    """BN fold and cross-layer PACT scaling of HWIO weights: bn_scale and
    fs_next align to O, fs_self to I (dense) or to the channel (depthwise)."""
    if spec.groups == 1:
        return w * bn_scale * fs_self[None, None, :, None] / fs_next
    if spec.is_depthwise:
        return w * bn_scale * fs_self / fs_next
    raise NotImplementedError("grouped conv with 1 < groups < in_ch")


def _merged_view(state, updates):
    """State with this step's updates overlaid, so a layer sees the EMA
    buffers already advanced in this batch."""
    if not updates:
        return state
    merged = dict(state)
    for k, upd in updates.items():
        d = dict(merged[k])
        d.update(upd)
        merged[k] = d
    return merged


def conv_bn_apply(graph: LayerGraph, cfg, name: str, params, state, x_act, mode: str = "eval",
                  group=None, tp=WHOLE):
    """One fused quantized ConvBN forward (`conv_bn_apply`,
    f8net_tpu/nn/quant_layers.py:346-482); mode 'train', 'eval' or 'calib';
    `group`: the process group whose global batch the statistics span;
    `tp`: the layer's Cut on a model line (module docstring) or WHOLE.
    Returns (Act, state updates).  In training, the BN statistics come from
    a second conv on the clip-scaled input, and the output conv uses them
    folded into the quantized weights; fix_scaling of this layer and of the
    following one read the state after this layer's EMA update."""
    spec = graph[name]
    if not isinstance(spec, ConvBNSpec):
        raise TypeError(f"{name} is not a ConvBN layer")
    training = mode in ("train", "calib")
    # the reference's selection: never the plain-float32 baseline, whose
    # operands lie on no quantization grid and whose contract is float32
    conv = (conv2d_bf16 if training and cfg.train_conv_bf16 and not cfg.floating_wo_clip
            else conv2d_nhwc)
    x = as_act(x_act).x
    p, eps = params[name], cfg.bn_eps
    gamma, beta = p["gamma"], p["beta"]

    x_val, in_fl, updates = _quantize_input(graph, cfg, name, state, x, training, group)
    live = _merged_view(state, updates)
    fs_self = fix_scaling(graph, cfg, name, params, live)
    following = graph.following_of(name)
    fs_next = None if following is None else fix_scaling(graph, cfg, following, params, live)
    if fs_next is None:
        x_val, fs_self = tp.copy(x_val, fs_self)
    else:  # fs_next aligned to O: this rank's channels
        x_val, fs_self, fs_next = tp.copy(x_val, fs_self, fs_next)
        fs_next = tp.local(fs_next)

    w = _conv_weight_rescale(cfg, spec, p["w"], tp.group) * spec.avgpool_scale

    # -- BatchNorm statistics
    if training:
        y0 = conv(x_val if cfg.floating_wo_clip else fs_self * x_val, w, spec)
        if group is None:
            bn_mean = torch.mean(y0, (0, 1, 2))
            var_b = torch.var(y0, (0, 1, 2), correction=0)
            n = y0.numel() / y0.shape[-1]  # rows per channel
            var_u = var_b * (n / max(n - 1.0, 1.0))
        else:
            mean64, var64, n = global_moments(y0, (0, 1, 2), group)
            bn_mean, var_b = mean64.to(y0.dtype), var64.to(y0.dtype)
            var_u = var_b * (n / torch.clamp(n - 1.0, min=1.0)).to(y0.dtype)
        bn_std = sqrt_rn(var_b + eps)
        st = state[name]
        st_mean, st_var = tp.local(st["bn_mean"]), tp.local(st["bn_var"])
        if mode == "calib":
            cnt = st["bn_count"] + 1.0
            upd = {
                "bn_mean": st_mean + (bn_mean - st_mean) / cnt,
                "bn_var": st_var + (var_u - st_var) / cnt,
                "bn_count": cnt,
            }
        else:
            m = cfg.bn_momentum
            upd = {
                "bn_mean": (1 - m) * st_mean + m * bn_mean,
                "bn_var": (1 - m) * st_var + m * var_u,
            }
        if tp is not WHOLE:  # the whole running statistics on every rank
            upd["bn_mean"], upd["bn_var"] = tp.gather_state(
                torch.stack([upd["bn_mean"], upd["bn_var"]])).unbind(0)
        updates.setdefault(name, {}).update(upd)
    else:
        bn_mean = tp.local(state[name]["bn_mean"])
        bn_std = sqrt_rn(tp.local(state[name]["bn_var"]) + eps)

    bn_scale = gamma / bn_std

    if cfg.floating_wo_clip:
        if training:  # the plain baseline: one conv, batch-stat normalization
            y = bn_scale * (y0 - bn_mean) + beta
        else:
            y = conv2d_nhwc(x_val, w * bn_scale, spec) + (beta - bn_scale * bn_mean)
        return Act(tp.gather(y, 3), None), updates

    # -- fold, quantize weight, bias
    w_eff = _fold_scales(spec, w, bn_scale, fs_self, fs_next)
    w_wl, w_fl_default = graph.weight_format(name, cfg)
    if cfg.floating_model:
        w_fl = torch.full((1,), float(w_fl_default), device=w.device)
    elif cfg.format_grid_search:
        w_fl = fraclen_gridsearch(w_eff, w_wl, 3, True, tp.group).reshape(1)
    elif cfg.format_from_metric:
        if w_wl != 8:
            raise NotImplementedError("word lengths other than 8 bit")
        m = metric_fn(cfg.metric, _weight_metric_axes(cfg), _weight_group(cfg, tp))(w_eff)
        w_fl = torch.clamp(metric2fraclen(m, cfg.metric, 1.0, True), 0.0, float(w_wl - 1))
        w_fl = w_fl.reshape(-1)
    else:
        raise NotImplementedError("need format_from_metric or format_grid_search")
    w_q = ste_quant(w_eff, w_fl, w_wl, 3, True, cfg.floating_model)

    bias = (beta - bn_scale * bn_mean) / fs_next
    if (not training) and cfg.quant_bias:
        bias, _ = fix_quant(bias, 32, in_fl + w_fl, 0, True)

    if cfg.int_infer and not training:
        # integer-valued float simulation
        if cfg.format_type == "per_channel":
            raise NotImplementedError(
                "int_infer requires format_type='per_layer': per-channel fraclens have no "
                "integer-inference scale contract"
            )
        int_w = torch.round(w_q * torch.exp2(w_fl))
        int_x = torch.round(x_val * torch.exp2(in_fl))
        int_b = torch.round(bias * torch.exp2(in_fl + w_fl))
        y = conv2d_nhwc(int_x, int_w, spec) + int_b
        y = torch.clamp(y, -INT32_BOUND, INT32_BOUND)
        out_fl = (w_fl + in_fl).reshape(-1)[:1]
        return Act(tp.gather(y / torch.exp2(out_fl), 3), out_fl), updates

    return Act(tp.gather(conv(x_val, w_q, spec) + bias, 3), None), updates


def _weight_group(cfg, tp):
    """Where a weight's fraclen metric reduces: per layer over the whole
    weight (the model line of a cut layer); per channel within each
    out-channel, which a rank holds whole."""
    return None if cfg.format_type == "per_channel" else tp.group


# -- Linear -----------------------------------------------------------------------


def _linear_scale(cfg, spec: LinearSpec, w_ref, w_q, group=None):
    """The forward standardization scale of a linear weight (detached, of
    the whole weight)."""
    sd = _std(w_q, group)
    if cfg.rescale_type == "stddev":
        return _std(w_ref, group) / sd
    if cfg.rescale_type == "constant":
        return (1.0 / math.sqrt(spec.out_features)) / sd
    raise NotImplementedError(cfg.rescale_type)


def linear_apply(graph: LayerGraph, cfg, name: str, params, state, x_act, mode: str = "eval",
                 group=None, tp=WHOLE):
    """Quantized fully-connected forward (`linear_apply`,
    f8net_tpu/nn/quant_layers.py:490-583).  The raw weight is quantized
    first, then standardized (training) or the scale divided into the bias
    (eval); the clip scale multiplies the quantized input in training and
    is folded into the bias at eval.  BN calibration leaves it in eval.
    `group` and `tp` as in conv_bn_apply."""
    spec = graph[name]
    if not isinstance(spec, LinearSpec):
        raise TypeError(f"{name} is not a Linear layer")
    training = mode == "train"
    x = as_act(x_act).x
    p = params[name]

    x_val, in_fl, updates = _quantize_input(graph, cfg, name, state, x, training, group)
    fs_self = fix_scaling(graph, cfg, name, params, _merged_view(state, updates))
    x_val, fs_self = tp.copy(x_val, fs_self)

    rescale = cfg.rescale_forward
    if cfg.floating_wo_clip:
        w = p["w"]
        if rescale:
            w = w * _linear_scale(cfg, spec, w, w, tp.group)
        y = matmul_f32(x_val, w)
        if "bias" in p:
            y = y + p["bias"]
        return Act(tp.gather(y, 1), None), updates

    w = p["w"]
    w_wl, w_fl_default = graph.weight_format(name, cfg)
    if cfg.floating_model:
        w_fl = torch.full((1,), float(w_fl_default), device=w.device)
    elif cfg.format_grid_search:
        w_fl = fraclen_gridsearch(w, w_wl, 1, True, tp.group).reshape(1)
    elif cfg.format_from_metric:
        if w_wl != 8:
            raise NotImplementedError("word lengths other than 8 bit")
        axes = (0,) if cfg.format_type == "per_channel" else (0, 1)
        m = metric_fn(cfg.metric, axes, _weight_group(cfg, tp))(w)
        w_fl = torch.clamp(metric2fraclen(m, cfg.metric, 1.0, True), 0.0, float(w_wl - 1))
        w_fl = w_fl.reshape(-1)
    else:
        raise NotImplementedError("need format_from_metric or format_grid_search")
    w_q = ste_quant(w, w_fl, w_wl, 1, True, cfg.floating_model)
    ws = (_linear_scale(cfg, spec, p["w"], w_q, tp.group) if rescale
          else torch.tensor(1.0, device=w.device))

    has_bias = "bias" in p
    if training:
        y = matmul_f32(x_val * fs_self, w_q * ws)
        if has_bias:
            y = y + p["bias"]
        return Act(tp.gather(y, 1), None), updates

    bias = None
    if has_bias:
        bias = p["bias"] / fs_self / ws
        if cfg.quant_bias:
            bias, _ = fix_quant(bias, 32, in_fl + w_fl, 0, True)

    if cfg.int_infer:
        int_w = torch.round(w_q * torch.exp2(w_fl))
        int_x = torch.round(x_val * torch.exp2(in_fl))
        y = matmul_f32(int_x, int_w)
        if bias is not None:
            y = y + torch.round(bias * torch.exp2(in_fl + w_fl))
        y = torch.clamp(y, -INT32_BOUND, INT32_BOUND)
        # logits have no downstream fraclen consumer: a per-channel w_fl
        # broadcasts over (N, out) as well as a per-layer one
        return Act(tp.gather(y / torch.exp2(w_fl + in_fl), 1), None), updates

    y = matmul_f32(x_val, w_q)
    if bias is not None:
        y = y + bias
    return Act(tp.gather(y, 1), None), updates


# -- pools and residual adds ------------------------------------------------------


def adaptive_avgpool(act) -> Act:
    a = as_act(act)
    return Act(torch.mean(a.x, (1, 2)), a.fl)


def fxq_avgpool(act, kernel: int = 7) -> Act:
    """Global average pool as sum / 2^round(log2(k^2)); the divisor's
    residue is pool-fused into the previous conv."""
    a = as_act(act)
    if a.x.shape[1] != kernel or a.x.shape[2] != kernel:
        raise ValueError(
            f"fxq_avgpool built for a {kernel}x{kernel} extent got "
            f"{a.x.shape[1]}x{a.x.shape[2]}; build the model with the matching image_size"
        )
    shift = avgpool_shift_for(kernel)
    y = torch.sum(a.x, (1, 2)) / (2.0**shift)
    return Act(y, None if a.fl is None else a.fl + shift)


def _window_max(x: torch.Tensor, kernel: int, stride: int, padding: int, fill) -> torch.Tensor:
    """k x k / stride max over NHWC `x` padded with `fill` (any dtype)."""
    if padding:
        x = F.pad(x.permute(0, 3, 1, 2), (padding,) * 4, value=fill).permute(0, 2, 3, 1)
    _, h, w, _ = x.shape
    oh, ow = (h - kernel) // stride + 1, (w - kernel) // stride + 1
    out = None
    for dy in range(kernel):
        for dx in range(kernel):
            v = x[:, dy:dy + (oh - 1) * stride + 1:stride, dx:dx + (ow - 1) * stride + 1:stride]
            out = v if out is None else torch.maximum(out, v)
    return out


def maxpool(act, kernel: int, stride: int, padding: int) -> Act:
    """Stock max pool (pads with -inf)."""
    a = as_act(act)
    return Act(_window_max(a.x, kernel, stride, padding, float("-inf")), a.fl)


def fxq_maxpool(act, kernel: int, stride: int, padding: int) -> Act:
    """Fraclen-preserving max pool that pads with zeros: the stock pool's
    values on non-negative (post-ReLU) inputs, any dtype."""
    a = as_act(act)
    return Act(_window_max(a.x, kernel, stride, padding, 0), a.fl)


def residual_add_int_sim(res: Act, x: Act) -> Act:
    """Integer-simulated residual add: both operands on the larger fraclen's
    grid, added, saturated to the int32 range, back to real scale."""
    out_fl = torch.maximum(res.fl, x.fl)
    scale = torch.exp2(out_fl)
    s = torch.clamp(res.x * scale + x.x * scale, -INT32_BOUND, INT32_BOUND)
    return Act(s / scale, out_fl)
