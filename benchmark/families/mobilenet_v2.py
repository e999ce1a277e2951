"""MobileNetV2 (Sandler et al. 2018): a 3x3 head with ReLU, inverted
residual blocks (expand, depthwise, linear project; a residual add with no
ReLU where the shapes match), and a 1x1 tail with ReLU."""

from . import body, first_convs


def forward(ops, cfg, x):
    a = ops.relu_into_conv(ops.conv("head", x))
    for block, target in zip(cfg["blocks"], first_convs(cfg, "tail")):
        r = body(ops, block, a)
        a = ops.carry(ops.add(r, a) if block["residual"] else r, target)
    return ops.relu(ops.conv("tail", a))
