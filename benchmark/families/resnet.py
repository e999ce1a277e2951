"""ResNets (He et al. 2016): a 7x7 head with ReLU and a 3x3 max pool, then
blocks whose body and shortcut (the identity, or a strided 1x1 conv) meet
in a residual add followed by a ReLU."""

from . import body, first_convs


def forward(ops, cfg, x):
    p = cfg["stem_pool"]
    blocks = cfg["blocks"]
    a = ops.max_pool(ops.relu(ops.conv("head", x)), p["kernel"], p["stride"], p["padding"])
    a = ops.carry(a, blocks[0]["body"][0])
    for block, target in zip(blocks, first_convs(cfg, None)):
        r = body(ops, block, a)
        s = a if block["shortcut"] is None else ops.conv(block["shortcut"], a)
        a = ops.carry(ops.relu(ops.add(r, s)), target)
    return a
