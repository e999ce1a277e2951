"""The speed baseline: the same topology as an ordinary bf16 CNN in torch --
the port of `f8net_tpu/engine/baseline.py` (`plain_params`,
`plain_forward`).

The reference publishes no throughput numbers, so the integer engine's
speed is held against the same network run the way a user would deploy it
without this framework: bf16 convolutions through cuDNN (channels_last
inside, NHWC at the API boundary), bias, ReLU, max pool, residual adds, a
mean pool and the classifier.  It is the baseline, not a port of a Pallas
kernel: `F.conv2d` is the point.  A ratio > 1 means the integer engine beats
bf16 on the same card.  The engine's users feed it `(x / 256)` of the
conditioned input as bf16, as `bench.py:289` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn.spec import ConvBNSpec


def plain_params(model, int_params, dtype=torch.bfloat16):
    """Dense float weights with the engine's values (their magnitudes do not
    matter for throughput; shapes do), laid out once for torch: conv
    weights OIHW in channels_last, the classifier's (in, out)."""
    out = {}
    for name, entry in int_params.items():
        w = entry["w"].to(dtype)
        if isinstance(model.graph[name], ConvBNSpec):
            w = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        e = {"w": w}
        if "b" in entry:
            e["b"] = entry["b"].to(dtype)
        out[name] = e
    return out


def plain_forward(model, fparams, x, dtype=torch.bfloat16):
    """Conv + bias + ReLU of the same graph in `dtype` (no quant op
    anywhere); x NHWC -> float32 logits.  The block structure is the JAX
    baseline's: a ReLU ends every block that has neither shortcut nor
    residual add (MobileNetV1's, MobileNetV2's non-residual ones)."""
    g = model.graph
    v = x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    def conv(name, v):
        spec, p = g[name], fparams[name]
        return F.conv2d(v, p["w"], p["b"], stride=spec.stride, padding=spec.padding,
                        groups=spec.groups)

    v = F.relu(conv("head", v))
    if model.name.startswith("resnet"):
        v = F.max_pool2d(v, 3, 2, 1)
    for meta in model.blocks:
        v_in = v
        for i, name in enumerate(meta.body):
            if i > 0:
                v = F.relu(v)
            v = conv(name, v)
        if hasattr(meta, "shortcut"):
            s = v_in if meta.shortcut is None else conv(meta.shortcut, v_in)
            v = F.relu(v + s)
        elif getattr(meta, "residual", False):
            v = v + v_in
        else:
            v = F.relu(v)
    if model.name == "mobilenet_v2":
        v = F.relu(conv("tail", v))
    v = v.mean((2, 3))
    p = fparams["classifier"]
    v = v @ p["w"]
    if "b" in p:
        v = v + p["b"]
    return v.to(torch.float32)
