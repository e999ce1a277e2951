"""TorchScript export of the integer-only model (the port of
`f8net_tpu/export/torch_export.py:20-192`).

The artifact is a traced TorchScript module that runs the strict int32
graph on the **CPU**, for a runtime outside this package: torch has integer
`F.conv2d` on the CPU and none on CUDA.  It is neither the serving path
(that is `engine.IntEngine` behind `engine.ServingEngine`, on the card) nor
a fallback for it, and it takes no device.  Its input is the reference's
exported int model's: int32 (or uint8/int8) NCHW at the head's input
fraclen, `condition_input_torch` of float [0, 1] images; its output the
logits as float32 integers, bit for bit the engine's strict rung.

The reference's int32 arithmetic is kept as it is, wrap-around included:
`x + half` of the requant, the shifts and `r + v` before the clamp of the
residual add, and the shift-sum pool summed in int64 and truncated to
int32.  One place differs: the reference takes the stem's maxpool in
float32 (`F.max_pool2d(x.float(), ...)`, exact only while |x| < 2^24); here
it is taken in float64, exact at every int32 value, as the engine's K3 is.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.pool import avgpool_shift_for
from ..nn.spec import ConvBNSpec

INT32_MAX = 2**31 - 1


def _requant(x, wl: int, fl: int, input_fl: int, signed: bool):
    """int32 shift requant from `input_fl` to `fl` with round-half-to-even
    and the clamp of a `wl`-bit grid, computed in int32 as the reference's
    `_requant_torch` does (`x + half` wraps)."""
    net = input_fl - fl
    if net > 0:
        half = 1 << (net - 1)
        res = x + half
        tie = (x % (1 << net)) == half
        res = torch.where(tie, (res >> (net + 1)) << 1, res >> net)
    else:
        res = x << (-net)
    bound = (1 << (wl - 1)) - 1 if signed else (1 << wl) - 1
    return torch.clamp(res, -bound if signed else 0, bound)


def _key(name: str) -> str:
    return name.replace(".", "__")


class TorchIntModel(nn.Module):
    """The int_op_only graph of a ResNet, MobileNetV1 or MobileNetV2 on int32
    NCHW tensors, weights as int32 buffers (OIHW convs, (out, in) linear)."""

    def __init__(self, model, plan, int_params, cfg=None):
        super().__init__()
        self.model, self.plan = model, plan
        self.cfg = cfg or model.cfg
        self.pool_shift = avgpool_shift_for(model.pool_kernel)
        for p in plan.layers:
            entry = {k: v.detach().cpu() for k, v in int_params[p.name].items()}
            w = entry["w"].to(torch.int32)
            if isinstance(model.graph[p.name], ConvBNSpec):
                w = w.permute(3, 2, 0, 1)  # HWIO -> OIHW
            else:
                w = w.t()  # (in, out) -> (out, in)
            self.register_buffer(_key(p.name) + "_w", w.contiguous())
            if "b" in entry:
                self.register_buffer(_key(p.name) + "_b", entry["b"].to(torch.int32).clone())

    def _conv(self, name: str, x, cur_fl: int):
        p, spec = self.plan[name], self.model.graph[name]
        x = _requant(x, 8, p.input_fl, cur_fl, p.input_symmetric)
        y = F.conv2d(x, getattr(self, _key(name) + "_w"), stride=spec.stride,
                     padding=spec.padding, groups=spec.groups)
        return y + getattr(self, _key(name) + "_b").view(1, -1, 1, 1), p.out_fl

    def _add(self, r, rf: int, v, vf: int):
        """Residual add on the larger fraclen's grid: int32 shifts and sum
        (both wrap), then the clip to +-INT32_MAX."""
        if rf >= vf:
            v, out_fl = v << (rf - vf), rf
        else:
            r, out_fl = r << (vf - rf), vf
        return torch.clamp(r + v, -INT32_MAX, INT32_MAX), out_fl

    def _body_chain(self, meta, x, fl: int):
        """A block's body convs, a ReLU before each but the first."""
        for i, name in enumerate(meta.body):
            if i > 0:
                x = torch.relu(x)
            x, fl = self._conv(name, x, fl)
        return x, fl

    def stem(self, x, fl: int):
        """ResNet's head conv, ReLU and 3x3/s2/p1 maxpool, exact in float64."""
        x, fl = self._conv("head", x, fl)
        return F.max_pool2d(torch.relu(x).double(), 3, 2, 1).int(), fl

    def forward(self, x):
        x = x.int()  # accept the uint8/int8 wire dtypes
        fl = self.plan["head"].input_fl
        name = self.model.name
        if name.startswith("resnet"):
            x, fl = self.stem(x, fl)
            for meta in self.model.blocks:
                v, vf = self._body_chain(meta, x, fl)
                if meta.shortcut is None:
                    s, sf = x, fl
                else:
                    s, sf = self._conv(meta.shortcut, x, fl)
                x, fl = self._add(v, vf, s, sf)
                x = torch.relu(x)
        elif name == "mobilenet_v1":
            x, fl = self._conv("head", x, fl)
            for meta in self.model.blocks:
                x, fl = self._body_chain(meta, torch.relu(x), fl)
            x = torch.relu(x)
        else:
            x, fl = self._conv("head", x, fl)
            x = torch.relu(x)
            for meta in self.model.blocks:
                v, vf = self._body_chain(meta, x, fl)
                x, fl = self._add(v, vf, x, fl) if meta.residual else (v, vf)
            x, fl = self._conv("tail", x, fl)
            x = torch.relu(x)
        p = self.plan["classifier"]
        if self.cfg.quant_avgpool:
            # torch sums int32 in int64; truncated back to int32 as the
            # reference's (fix_quant_ops.py:130-133)
            x, fl = x.sum(dim=(2, 3)).int(), fl + self.pool_shift
        else:
            m = x.float().mean(dim=(2, 3)) / (2.0**fl)
            q = torch.round(m * 2.0**p.input_fl)
            lo, hi = (-127.0, 127.0) if p.input_symmetric else (0.0, 255.0)
            x, fl = torch.clamp(q, lo, hi).int(), p.input_fl
        x = _requant(x, 8, p.input_fl, fl, p.input_symmetric)
        y = x @ self.classifier_w.t()
        if hasattr(self, "classifier_b"):
            y = y + self.classifier_b
        return y.float()


def build_torch_int_model(model, plan, int_params, cfg=None) -> TorchIntModel:
    """The port's model, plan and int params (torch tensors on any device)
    -> TorchIntModel on the CPU, in eval mode."""
    return TorchIntModel(model, plan, int_params, cfg).eval()


def condition_input_torch(images_nchw, plan, cfg):
    """float [0, 1] NCHW images -> the module's int32 input
    (`fix_train.py:676-694`): the head's signed 8-bit grid when normalized,
    round(255 x) otherwise."""
    if cfg.normalize:
        q = torch.round(images_nchw * 2.0 ** plan["head"].input_fl)
        return torch.clamp(q, -127.0, 127.0).int()
    return torch.round(255.0 * images_nchw).int()


def export_torchscript(model, plan, int_params, path: str, cfg=None,
                       image_size: int = 224) -> str:
    """Trace TorchIntModel on the CPU at batch 1 and `image_size` and save
    it to `path`; returns the path."""
    m = build_torch_int_model(model, plan, int_params, cfg)
    example = torch.zeros((1, 3, image_size, image_size), dtype=torch.int32)
    with torch.no_grad():
        traced = torch.jit.trace(m, example)
    traced.save(path)
    return path
