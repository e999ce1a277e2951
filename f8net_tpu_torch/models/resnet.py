"""ResNet-18/34/50/101/152 (the port of `f8net_tpu/models/resnet.py`).

The graph is the reference's: a 7x7/2 quantized head (weight-only when
inputs are unnormalized, signed double-side when normalized), Basic or
Bottleneck residual stages with master linkage across each residual chain,
following-layer wiring for the cross-layer BN-fold scale, and a linear
classifier.  The pool-fusing scale is applied at integer conversion to the
last block's last body conv (`Model.pool_fuse_layer`), not during QAT.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

from ..nn.quant_layers import (
    Act, adaptive_avgpool, fxq_avgpool, fxq_maxpool, maxpool, residual_add_int_sim,
)
from ..nn.runner import Runner
from ..nn.spec import ConvBNSpec, LayerGraph, LinearSpec
from .base import Model

BLOCK_SETTING = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}
EXPANSION = {18: 1, 34: 1, 50: 4, 101: 4, 152: 4}
FEATS = [64, 128, 256, 512]


class BlockMeta(NamedTuple):
    body: List[str]
    shortcut: Optional[str]


def _conv(name, inp, outp, k, stride=1, pad=0, groups=1, **kw):
    return ConvBNSpec(
        name=name,
        in_ch=inp,
        out_ch=outp,
        kernel=(k, k),
        stride=(stride, stride),
        padding=(pad, pad),
        groups=groups,
        **kw,
    )


def build_resnet(
    cfg, depth: int = 18, num_classes: int = 1000, pool_kernel: int = 7
) -> Model:
    bottleneck = EXPANSION[depth] == 4
    setting = BLOCK_SETTING[depth]

    specs = {}
    conv_order: List[str] = []
    blocks: List[BlockMeta] = []

    specs["head"] = _conv(
        "head",
        3,
        64,
        7,
        2,
        3,
        bita_min=8,
        weight_only=not cfg.normalize,
        double_side=cfg.normalize,
    )
    conv_order.append("head")

    channels = 64
    master: Optional[str] = None  # running master across residual chains
    prev_tail: List[str] = ["head"]  # layers whose `following` points at next block
    last_block: Optional[BlockMeta] = None

    for idx, n in enumerate(setting):
        outp = FEATS[idx] * EXPANSION[depth]
        for i in range(n):
            stride = 2 if (i == 0 and idx != 0) else 1
            prefix = f"stage_{idx}_layer_{i}"
            residual = stride == 1 and channels == outp
            if bottleneck:
                midp = outp // 4
                body = [f"{prefix}.body.0", f"{prefix}.body.1", f"{prefix}.body.2"]
                specs[body[0]] = _conv(body[0], channels, midp, 1, 1, 0, master=master)
                specs[body[1]] = _conv(body[1], midp, midp, 3, stride, 1)
                specs[body[2]] = _conv(body[2], midp, outp, 1, 1, 0)
            else:
                body = [f"{prefix}.body.0", f"{prefix}.body.1"]
                specs[body[0]] = _conv(body[0], channels, outp, 3, stride, 1, master=master)
                specs[body[1]] = _conv(body[1], outp, outp, 3, 1, 1)
            shortcut = None
            if not residual:
                shortcut = f"{prefix}.shortcut.0"
                specs[shortcut] = _conv(shortcut, channels, outp, 1, stride, 0, master=master)
            meta = BlockMeta(body, shortcut)
            blocks.append(meta)
            conv_order.extend(body)
            if shortcut:
                conv_order.append(shortcut)

            # a block with an identity shortcut exposes its first conv as the
            # chain master; a downsample block resets the chain
            master = None if shortcut else body[0]

            # the previous block's tail layers (last body conv + shortcut)
            # point at this block's first conv; intra-block convs chain
            for t in prev_tail:
                specs[t] = dataclasses.replace(specs[t], following=body[0])
            for a, b in zip(body[:-1], body[1:]):
                specs[a] = dataclasses.replace(specs[a], following=b)
            prev_tail = [body[-1]] + ([shortcut] if shortcut else [])
            channels = outp
            last_block = meta

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
        # quant_maxpool: the reference's zero-padding pool, the same values on
        # the non-negative post-ReLU input
        a = fxq_maxpool(a, 3, 2, 1) if c.quant_maxpool else maxpool(a, 3, 2, 1)
        for meta in blocks:
            a = _block_forward(r, meta, a)
        a = fxq_avgpool(a, pool_kernel) if c.quant_avgpool else adaptive_avgpool(a)
        a = r.linear("classifier", a)
        return a.x, r.finalize()

    return Model(
        name=f"resnet{depth}",
        graph=graph,
        cfg=cfg,
        block_setting=setting,
        conv_order=conv_order,
        num_classes=num_classes,
        blocks=blocks,
        pool_fuse_layer=(
            last_block.body[-1] if (cfg.quant_avgpool and cfg.pool_fusing) else None
        ),
        pool_kernel=pool_kernel,
        forward=forward,
    )


def _block_forward(r: Runner, meta: BlockMeta, a_in: Act) -> Act:
    """Basic or Bottleneck block: no explicit ReLU between body convs (the
    next conv's unsigned input quantization is the ReLU), one after the
    residual add."""
    if r.cfg.qat_boundary == "int8" and not r.int_sim:
        # deployment-aware QAT: the block input lives on body.0's 8-bit grid,
        # as the int8-boundary engine's 1-byte carry does
        a_in = r.boundary_quant(meta.body[0], a_in)
    a = a_in
    for cname in meta.body:
        a = r.conv(cname, a)
    s = a_in if meta.shortcut is None else r.conv(meta.shortcut, a_in)
    a = residual_add_int_sim(a, s) if r.int_sim else Act(a.x + s.x, None)
    return r.relu(a)
