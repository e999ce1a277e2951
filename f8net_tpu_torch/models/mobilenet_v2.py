"""MobileNetV2 (the port of `f8net_tpu/models/mobilenet_v2.py`).

The graph is the reference's: a 3x3/2 quantized head to 32 channels,
inverted-residual blocks [t, c, n, s] as `BLOCK_SETTING`, where the first
conv of every block past stage 0 takes a signed (double-side) input because
project outputs are not ReLU'd, master linkage across residual chains, a 1x1
tail conv to 1280 channels that carries the pool-fusing scale (in QAT too,
unlike ResNet), and a linear classifier.  Blocks have no post-add ReLU.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

from ..nn.pool import avgpool_scale_for
from ..nn.quant_layers import Act, adaptive_avgpool, fxq_avgpool, residual_add_int_sim
from ..nn.runner import Runner
from ..nn.spec import ConvBNSpec, LayerGraph, LinearSpec
from .base import Model

BLOCK_SETTING = [  # t, c, n, s
    [1, 16, 1, 1],
    [6, 24, 2, 2],
    [6, 32, 3, 2],
    [6, 64, 4, 2],
    [6, 96, 3, 1],
    [6, 160, 3, 2],
    [6, 320, 1, 1],
]


class BlockMeta(NamedTuple):
    body: List[str]
    residual: bool


def build_mobilenet_v2(cfg, num_classes: int = 1000, pool_kernel: int = 7) -> Model:
    specs = {}
    conv_order: List[str] = []
    blocks: List[BlockMeta] = []

    specs["head"] = ConvBNSpec(
        name="head", in_ch=3, out_ch=32, kernel=(3, 3), stride=(2, 2), padding=(1, 1),
        bita_min=8, weight_only=not cfg.normalize, double_side=cfg.normalize,
    )
    conv_order.append("head")

    channels = 32
    master: Optional[str] = None
    prev_tail = ["head"]
    for idx, (t, c, n, s) in enumerate(BLOCK_SETTING):
        for i in range(n):
            stride = s if i == 0 else 1
            ds = (idx != 0) if i == 0 else True
            prefix = f"stage_{idx}_layer_{i}"
            residual = stride == 1 and channels == c
            expand = channels * t
            if t != 1:
                body = [f"{prefix}.body.0", f"{prefix}.body.1", f"{prefix}.body.2"]
                specs[body[0]] = ConvBNSpec(
                    name=body[0], in_ch=channels, out_ch=expand, kernel=(1, 1),
                    double_side=ds, master=master,
                )
                specs[body[1]] = ConvBNSpec(
                    name=body[1], in_ch=expand, out_ch=expand, kernel=(3, 3),
                    stride=(stride, stride), padding=(1, 1), groups=expand,
                )
                specs[body[2]] = ConvBNSpec(name=body[2], in_ch=expand, out_ch=c, kernel=(1, 1))
            else:
                body = [f"{prefix}.body.0", f"{prefix}.body.1"]
                specs[body[0]] = ConvBNSpec(
                    name=body[0], in_ch=channels, out_ch=channels, kernel=(3, 3),
                    stride=(stride, stride), padding=(1, 1), groups=channels,
                    double_side=ds, master=master,
                )
                specs[body[1]] = ConvBNSpec(name=body[1], in_ch=channels, out_ch=c, kernel=(1, 1))
            for a, b in zip(body[:-1], body[1:]):
                specs[a] = dataclasses.replace(specs[a], following=b)
            for tl in prev_tail:
                specs[tl] = dataclasses.replace(specs[tl], following=body[0])
            master = body[0] if residual else None
            prev_tail = [body[-1]]
            blocks.append(BlockMeta(body, residual))
            conv_order.extend(body)
            channels = c

    pool_fuse = cfg.quant_avgpool and cfg.pool_fusing
    specs["tail"] = ConvBNSpec(
        name="tail", in_ch=channels, out_ch=1280, kernel=(1, 1), double_side=True,
        master=master, avgpool_scale=avgpool_scale_for(pool_kernel) if pool_fuse else 1.0,
    )
    conv_order.append("tail")
    for tl in prev_tail:
        specs[tl] = dataclasses.replace(specs[tl], following="tail")

    specs["classifier"] = LinearSpec(
        name="classifier", in_features=1280, out_features=num_classes, bias=True
    )
    conv_order.append("classifier")
    specs["tail"] = dataclasses.replace(specs["tail"], following="classifier")

    graph = LayerGraph(specs)

    def forward(params, state, x, mode="eval", run_cfg=None, group=None, mesh=None):
        c = run_cfg or cfg
        r = Runner(graph, c, params, state, mode, group, mesh)
        a = r.relu(r.conv("head", Act(x)))
        for meta in blocks:
            if meta.residual and c.qat_boundary == "int8" and not r.int_sim:
                # deployment-aware QAT: the residual carry lives on the block's
                # first conv's 8-bit grid, as the int8-boundary engine's does
                a = r.boundary_quant(meta.body[0], a)
            a_in = a
            for cname in meta.body:
                a = r.conv(cname, a)
            if meta.residual:
                a = residual_add_int_sim(a, a_in) if r.int_sim else Act(a.x + a_in.x, None)
        a = r.relu(r.conv("tail", a))
        a = fxq_avgpool(a, pool_kernel) if c.quant_avgpool else adaptive_avgpool(a)
        a = r.linear("classifier", a)
        return a.x, r.finalize()

    return Model(
        name="mobilenet_v2",
        graph=graph,
        cfg=cfg,
        block_setting=BLOCK_SETTING,
        conv_order=conv_order,
        num_classes=num_classes,
        blocks=blocks,
        pool_fuse_layer="tail" if pool_fuse else None,
        pool_kernel=pool_kernel,
        forward=forward,
    )
