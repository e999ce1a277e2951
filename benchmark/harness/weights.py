"""Weights, biases and fraclens of a configuration, made on the device from
the seed: the rule of chip_smoke.py's `synthetic_bundle` (frozen copy; origin
`chip_smoke.py:630-667`, `fraclen_for` `:566-570`, `float_forward`
`:587-627`), rewritten to draw every weight in two large calls of a
`torch.Generator` on the run's device instead of leaf by leaf on the host.

  * int8 weights at fraclen 7: N(0, 1) x He's std sqrt(gain / fan_in) x 2^7,
    rounded and clipped to -127..127, gain 2, or 1 for each block's last
    body conv (it feeds the residual stream with no ReLU of its own, as a
    trained network's folded BatchNorm keeps that stream from growing);
  * real biases 0.05 N(0, 1);
  * each layer's input fraclen floor(log2(c / std)) (F8Net's rule, c = 40
    for a signed input and 70 for an unsigned one, clipped to the 8-bit
    format) from the std of that layer's input in one float32 pass of the
    real-valued network over a few images; the head reads the wire's
    uint8 at fraclen 8;
  * int32 biases round(real bias x 2^(input fraclen + 7)).

The same seed gives the same weights and plan on the same device.  Both the
program and the plain reference receive exactly these tensors.
"""

from __future__ import annotations

import hashlib
import math

import torch
import torch.nn.functional as F

from .. import families


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one purpose (`what`) of a run's seed: any whole
    number, however large, maps to a seed a torch.Generator takes."""
    digest = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, what: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(sub_seed(seed, what))
    return g


def weight_shape(layer) -> tuple:
    if layer.get("linear"):
        return (layer["in"], layer["out"])
    return (layer["k"], layer["k"], layer["in"] // layer["g"], layer["out"])


def linear_out(cfg) -> set:
    """Each block's last body conv: no ReLU of its own before the residual
    stream (He gain 1)."""
    return {b["body"][-1] for b in cfg["blocks"]}


def make_weights(cfg, seed: int, device):
    """{layer: int8 weights (HWIO, or (in, out) for the classifier)} and
    {layer: float32 real biases}, drawn on `device` in two calls."""
    fl = cfg["quant"]["weight_fraclen"]
    g = generator(seed, "weights", device)
    layers = cfg["layers"]
    sizes = [math.prod(weight_shape(l)) for l in layers]
    z = torch.randn(sum(sizes), generator=g, device=device)
    zb = torch.randn(sum(l["out"] for l in layers), generator=g, device=device)
    gain1 = linear_out(cfg)
    w_int, b_real = {}, {}
    for l, part, bpart in zip(layers, z.split(sizes), zb.split([l["out"] for l in layers])):
        shape = weight_shape(l)
        fan_in = math.prod(shape[:-1])
        std = math.sqrt((1.0 if l["name"] in gain1 else 2.0) / fan_in) * 2.0**fl
        w_int[l["name"]] = torch.clamp(torch.round(part * std), -127, 127).to(torch.int8).reshape(shape)
        b_real[l["name"]] = 0.05 * bpart
    return w_int, b_real


class FloatPass:
    """The `ops` of a family's walk (benchmark/families/) over the
    real-valued network in float32: each conv records the std of its input;
    every ReLU is taken, none is absorbed."""

    def __init__(self, cfg, w_real, b_real):
        self.layers = {l["name"]: l for l in cfg["layers"]}
        self.w, self.b, self.sigma = w_real, b_real, {}

    def conv(self, name, x):
        self.sigma[name] = float(x.std())
        l = self.layers[name]
        return F.conv2d(x, self.w[name].permute(3, 2, 0, 1), self.b[name], stride=l["s"],
                        padding=l["p"], groups=l["g"])

    @staticmethod
    def relu(x):
        return F.relu(x)

    relu_into_conv = relu

    @staticmethod
    def add(r, s):
        return r + s

    @staticmethod
    def max_pool(x, kernel, stride, padding):
        return F.max_pool2d(x, kernel, stride, padding)

    @staticmethod
    def carry(x, target):
        return x


def float_sigmas(cfg, w_real, b_real, x):
    """{layer: std of its input} in one float32 pass of the real-valued
    network over `x` (NCHW, the head's input value), walked by the
    configuration's family."""
    ops = FloatPass(cfg, w_real, b_real)
    a = families.load(cfg["family"]).forward(ops, cfg, x)
    pooled = a.sum((2, 3)) / 2.0**pool_shift(a.shape[2])
    ops.sigma["classifier"] = float(pooled.std())
    return ops.sigma


def pool_shift(kernel: int) -> int:
    """shiftnum = round(log2(k * k)) of F8Net's quantized average pool."""
    return max(int(round(math.log2(float(kernel * kernel)))), 0)


def fraclen_for(sigma: float, signed: bool, q) -> int:
    coeff = q["signed_std_coeff"] if signed else q["unsigned_std_coeff"]
    return int(min(max(math.floor(math.log2(coeff / sigma)), 0), 8 - int(signed)))


def make_plan(cfg, seed: int, calib_u8: torch.Tensor):
    """(records [(layer, input fraclen, weight fraclen, signed)], params
    {layer: {"w": int8, "b": int32}}) on calib_u8's device; calib_u8 is
    NHWC uint8, the images of the float pass."""
    q = cfg["quant"]
    device = calib_u8.device
    w_int, b_real = make_weights(cfg, seed, device)
    wfl = q["weight_fraclen"]
    w_real = {k: v.to(torch.float32) / 2.0**wfl for k, v in w_int.items()}
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        x = (calib_u8.to(torch.float32) / 256.0).permute(0, 3, 1, 2)
        sig = float_sigmas(cfg, w_real, b_real, x)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    records, params = [], {}
    for l in cfg["layers"]:
        name, signed = l["name"], bool(l["signed"])
        in_fl = 8 if name == "head" and not q["normalize"] else fraclen_for(sig[name], signed, q)
        b = torch.round(b_real[name].to(torch.float64) * 2.0 ** (in_fl + wfl))
        records.append((name, in_fl, wfl, signed))
        params[name] = {"w": w_int[name], "b": b.to(torch.int32)}
    return records, params
