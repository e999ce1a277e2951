"""The integer forward of F8Net's engine in plain PyTorch, for every family
under benchmark/families/ and every rung under reference/rungs/.

A frozen copy of the port's plain semantics (f8net_tpu_torch/ops/fxp.py
`requant_net`, `wrap_i32`; engine/int_engine.py's dataflow), written from
the layer table on the values themselves rather than on the program's
packed layouts:

  * an activation is an integer tensor on the grid of fraclen `fl`;
  * a conv's operand is the activation requantized onto the conv's 8-bit
    input grid (`requant`: one right shift by fl - input_fl, rounding half
    to even, then the clamp -127..127 for a signed input or 0..255 for an
    unsigned one, which absorbs a ReLU);
  * a conv is the exact integer sum of operand x int8 weight over its
    window, zero padding, plus the int32 bias, wrapping in int32, at fraclen
    input_fl + 7.  The sums run in float64, exact: every partial sum is an
    integer below 2^53 (|sum| <= k*k*C * 255 * 127).  TF32 never touches a
    float64 product;
  * a residual add shifts the lower-fraclen operand onto the higher grid,
    adds wrapping in int32 and clamps to +-(2^31 - 1);
  * a ReLU is a clamp at 0, and one that the next conv's unsigned operand
    absorbs is skipped; a max pool is taken over the int32 values;
  * the global pool is the int32 (wrapping) sum over the image shifted by
    round(log2(k*k)) fraclens; the classifier is a conv of 1x1 over the
    pooled vector; logits are its int32 output as float32.

The family's walk (benchmark/families/<family>.py) orders these steps; the
rung's rule (reference/rungs/<rung>.py) says what a block's output carries.

`operand_bits=4` is the control: every 8-bit operand and weight rounded to
its 4 high bits (the nearest precision below int8).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import families
from . import rungs

INT32_MAX = (1 << 31) - 1


def wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> the int32 two's-complement wrap of it, as int64."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def requant(x: torch.Tensor, net: int, signed: bool) -> torch.Tensor:
    """int64 values at fraclen f -> the 8-bit grid at fraclen f - net:
    right shift by net rounding half to even (x + 2^(net-1) wraps in int32
    first), or left shift by -net (wrapping), then the clamp."""
    if net > 0:
        half = 1 << (net - 1)
        res = wrap(x + half)
        tie = torch.remainder(x, 1 << net) == half
        res = torch.where(tie, (res >> (net + 1)) << 1, res >> net)
    else:
        res = wrap(x << (-net))
    return res.clamp(-127, 127) if signed else res.clamp(0, 255)


def _q4(v: torch.Tensor, signed: bool) -> torch.Tensor:
    """An 8-bit value kept to its 4 high bits (the control's operands)."""
    q = torch.round(v.to(torch.float64) / 16.0)
    q = q.clamp(-7, 7) if signed else q.clamp(0, 15)
    return (q * 16).to(v.dtype)


class IntNet:
    """cfg: the configuration (its layer table, blocks and family); params:
    {layer: {"w": int8 HWIO (or (in, out)), "b": int32}}; plan: {layer:
    (input_fl, weight_fl, signed)}; rung: a file of reference/rungs/.  It is
    the `ops` of its family's walk (benchmark/families/)."""

    def __init__(self, cfg, params, plan, rung: str = "strict", operand_bits: int = 8):
        self.family = families.load(cfg["family"])
        self.rule = rungs.load(rung)
        self.cfg, self.rung, self.bits = cfg, rung, operand_bits
        self.layers = {l["name"]: l for l in cfg["layers"]}
        self.plan = {k: (int(v[0]), int(v[1]), bool(v[2])) for k, v in plan.items()}
        dev = params["head"]["w"].device
        self.w, self.b = {}, {}
        for name, p in params.items():
            w = p["w"].to(dev, torch.float64)
            if operand_bits == 4:
                w = _q4(w, True)
            l = self.layers[name]
            self.w[name] = w if l.get("linear") else w.permute(3, 2, 0, 1).contiguous()
            self.b[name] = p["b"].to(dev, torch.int64)
        self.device = dev
        self.clamped, self.zero = 0.0, 0.0  # the largest operand shares seen

    # -- pieces --------------------------------------------------------------

    def operand(self, a, name: str) -> torch.Tensor:
        """Activation (int64 values, fl) -> conv `name`'s 8-bit operand."""
        x, fl = a
        in_fl, _, signed = self.plan[name]
        v = requant(x, fl - in_fl, signed)
        if self.bits == 4:
            v = _q4(v, signed)
        top = 127 if signed else 255
        self.clamped = max(self.clamped, float((v.abs() == top).double().mean()))
        self.zero = max(self.zero, float((v == 0).double().mean()))
        return v

    def conv(self, name: str, a):
        """int32 output (as int64 values) of conv `name` on activation a
        (NCHW), at its output fraclen."""
        l = self.layers[name]
        v = self.operand(a, name).to(torch.float64)
        in_fl, w_fl, _ = self.plan[name]
        if l.get("linear"):
            acc = v @ self.w[name]
            return wrap(acc.to(torch.int64) + self.b[name]), in_fl + w_fl
        acc = F.conv2d(v, self.w[name], stride=l["s"], padding=l["p"], groups=l["g"])
        return wrap(acc.to(torch.int64) + self.b[name].reshape(1, -1, 1, 1)), in_fl + w_fl

    @staticmethod
    def add(r, s):
        (x, fx), (y, fy) = r, s
        if fx >= fy:
            y, out = wrap(y << (fx - fy)), fx
        else:
            x, out = wrap(x << (fy - fx)), fy
        return wrap(x + y).clamp(-INT32_MAX, INT32_MAX), out

    @staticmethod
    def relu(a):
        return a[0].clamp_min(0), a[1]

    @staticmethod
    def relu_into_conv(a):
        return a

    @staticmethod
    def max_pool(a, kernel: int, stride: int, padding: int):
        y = F.max_pool2d(a[0].to(torch.float64), kernel, stride, padding)
        return y.to(torch.int64), a[1]

    def carry(self, a, target):
        return self.rule.carry(self, a, target)

    @torch.no_grad()
    def logits(self, x_u8: torch.Tensor, rows: int = 16) -> torch.Tensor:
        """uint8 NHWC images -> float32 logits, `rows` images at a time."""
        out = []
        for part in x_u8.split(rows):
            x = part.to(self.device).permute(0, 3, 1, 2).to(torch.int64)
            v, fl = self.family.forward(self, self.cfg, (x, 8))
            k = v.shape[2]
            shift = max(int(round(math.log2(float(k * k)))), 0)
            pooled = (wrap(v.sum((2, 3))), fl + shift)
            y, _ = self.conv("classifier", pooled)
            out.append(y.to(torch.float32))
        return torch.cat(out)
