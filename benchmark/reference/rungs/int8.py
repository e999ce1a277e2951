"""The int8-boundary rung: each block output (and the ResNet stem's) is
requantized onto the 8-bit grid of the conv it feeds, so a residual add
then adds that 8-bit value; the last ResNet block keeps int32 for the
pool."""


def carry(net, a, target):
    if target is None:
        return a
    return net.operand(a, target).to(a[0].dtype), net.plan[target][0]
