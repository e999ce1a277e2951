"""The walk of each model family's layer table, one file per family
(`families/<family>.py`, named by a configuration's `family`).

A family's `forward(ops, cfg, x)` walks the network from its head's input
`x` to the activation that the global pool reads, and leaves every
operation to `ops`, so that one walk serves three readings of the same
table: the plain integer reference (reference/intnet.py), the float pass
that sets the fraclens (harness/weights.py) and the shape walk that counts
operations and bytes (harness/counts.py).  `ops` offers:

  conv(name, a)              the table's layer `name` applied to a
  relu(a)                    a ReLU the integer engine computes
  relu_into_conv(a)          a ReLU that the next conv's unsigned 8-bit
                             operand absorbs (the integer side skips it)
  add(r, s)                  a residual add
  max_pool(a, k, stride, p)  a max pool
  carry(a, target)           a block's output carried to the conv `target`
                             (None after the last block): the rung's rule

A later PR adds a family as a file here and a configuration that names it."""

import importlib


def load(family: str):
    return importlib.import_module(f"{__name__}.{family}")


def body(ops, block, a):
    """A block's body convs in turn, a ReLU between each two."""
    names = block["body"]
    for k, name in enumerate(names):
        a = ops.conv(name, a)
        if k < len(names) - 1:
            a = ops.relu_into_conv(a)
    return a


def first_convs(cfg, last):
    """The conv each block's output is carried to: the next block's first,
    and `last` after the last block."""
    return [b["body"][0] for b in cfg["blocks"][1:]] + [last]
