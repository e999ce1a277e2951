"""MobileNetV1 (the port of `f8net_tpu/models/mobilenet_v1.py`).

The graph is the reference's: a 3x3/2 quantized head to 32 channels, then
depthwise-separable blocks [c, n, s] as `BLOCK_SETTING`, each a depthwise
3x3 and a pointwise 1x1, in a straight following-layer chain without
residuals (so no master sharing), the average pool and a linear
classifier.  Each block ends in an explicit ReLU after the pointwise conv;
the last block's pointwise conv carries the pool-fusing scale.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

from ..nn.quant_layers import Act, adaptive_avgpool, fxq_avgpool
from ..nn.runner import Runner
from ..nn.spec import ConvBNSpec, LayerGraph, LinearSpec
from .base import Model

BLOCK_SETTING = [  # c, n, s
    [64, 1, 1],
    [128, 2, 2],
    [256, 2, 2],
    [512, 6, 2],
    [1024, 2, 2],
]


class BlockMeta(NamedTuple):
    body: List[str]  # [depthwise, pointwise]


def build_mobilenet_v1(cfg, num_classes: int = 1000, pool_kernel: int = 7) -> Model:
    specs = {}
    conv_order: List[str] = []
    blocks: List[BlockMeta] = []

    specs["head"] = ConvBNSpec(
        name="head", in_ch=3, out_ch=32, kernel=(3, 3), stride=(2, 2), padding=(1, 1),
        bita_min=8, weight_only=not cfg.normalize, double_side=cfg.normalize,
    )
    conv_order.append("head")

    channels = 32
    prev_tail = ["head"]
    for idx, (c, n, s) in enumerate(BLOCK_SETTING):
        for i in range(n):
            stride = s if i == 0 else 1
            prefix = f"stage_{idx}_layer_{i}"
            dw, pw = f"{prefix}.body.0", f"{prefix}.body.1"
            specs[dw] = ConvBNSpec(
                name=dw, in_ch=channels, out_ch=channels, kernel=(3, 3),
                stride=(stride, stride), padding=(1, 1), groups=channels, following=pw,
            )
            specs[pw] = ConvBNSpec(name=pw, in_ch=channels, out_ch=c, kernel=(1, 1))
            for t in prev_tail:
                specs[t] = dataclasses.replace(specs[t], following=dw)
            prev_tail = [pw]
            blocks.append(BlockMeta([dw, pw]))
            conv_order.extend([dw, pw])
            channels = c

    specs["classifier"] = LinearSpec(
        name="classifier", in_features=channels, out_features=num_classes, bias=True
    )
    conv_order.append("classifier")
    for t in prev_tail:
        specs[t] = dataclasses.replace(specs[t], following="classifier")

    graph = LayerGraph(specs)

    def forward(params, state, x, mode="eval", run_cfg=None, group=None, mesh=None):
        c = run_cfg or cfg
        r = Runner(graph, c, params, state, mode, group, mesh)
        a = r.relu(r.conv("head", Act(x)))
        for meta in blocks:
            a = r.conv(meta.body[0], a)
            a = r.relu(r.conv(meta.body[1], a))
        a = fxq_avgpool(a, pool_kernel) if c.quant_avgpool else adaptive_avgpool(a)
        a = r.linear("classifier", a)
        return a.x, r.finalize()

    return Model(
        name="mobilenet_v1",
        graph=graph,
        cfg=cfg,
        block_setting=BLOCK_SETTING,
        conv_order=conv_order,
        num_classes=num_classes,
        blocks=blocks,
        pool_fuse_layer=blocks[-1].body[-1] if (cfg.quant_avgpool and cfg.pool_fusing) else None,
        pool_kernel=pool_kernel,
        forward=forward,
    )
