"""Holds the program's layer graph against the configuration's table."""

from __future__ import annotations


def table_of(model) -> tuple:
    """(layers, blocks) of a port model (`f8net_tpu_torch.models.Model`) in
    the configuration file's vocabulary."""
    layers = []
    for name in model.graph.names():
        spec = model.graph[name]
        if hasattr(spec, "in_features"):
            layers.append({"name": name, "in": spec.in_features, "out": spec.out_features,
                           "linear": True, "signed": bool(spec.double_side)})
            continue
        if spec.kernel[0] != spec.kernel[1] or spec.stride[0] != spec.stride[1] \
                or spec.padding[0] != spec.padding[1]:
            raise AssertionError(f"{name}: a non-square conv is not in any table")
        layers.append({"name": name, "in": spec.in_ch, "out": spec.out_ch, "k": spec.kernel[0],
                       "s": spec.stride[0], "p": spec.padding[0], "g": spec.groups,
                       "signed": bool(spec.double_side)})
    blocks = []
    for meta in model.blocks:
        b = {"body": list(meta.body)}
        if hasattr(meta, "shortcut"):
            b["shortcut"] = meta.shortcut
        else:
            b["residual"] = bool(meta.residual)
        blocks.append(b)
    return layers, blocks


def check_graph(cfg, model) -> None:
    """Raises unless the model's graph is the configuration's table, layer
    for layer (names, channels, kernel, stride, padding, groups, signed
    input) and block for block."""
    layers, blocks = table_of(model)
    want = cfg["layers"]
    if [l["name"] for l in layers] != [l["name"] for l in want]:
        raise AssertionError(f"{cfg['name']}: the program's layers are not the table's")
    for got, exp in zip(layers, want):
        if got != exp:
            raise AssertionError(f"{cfg['name']}: layer {exp['name']} is {got} in the program, "
                                 f"{exp} in the table")
    if blocks != cfg["blocks"]:
        raise AssertionError(f"{cfg['name']}: the program's blocks are not the table's")
