"""The carry rule of each rung, one file per rung (`rungs/<rung>.py`,
named by a cell's `rung`): `carry(net, a, target)` takes a block's output
activation `a` (int64 values, fraclen) and returns what the next block
reads, `target` being the conv it feeds (None after the last ResNet
block, whose output the pool reads as it is)."""

import importlib


def load(rung: str):
    return importlib.import_module(f"{__name__}.{rung}")
