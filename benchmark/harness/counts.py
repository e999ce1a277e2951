"""Operations and bytes of a configuration's convs and GEMMs, from the
table's shapes, and the H100's published peaks.

`macs` is the arithmetic of f8net_tpu_torch/utils/profiling.py
`model_flops` (frozen copy: each conv's MACs at its output size, the
classifier's in x out), and `PEAK` that file's `H100_PEAK_OPS` and
`H100_HBM_BYTES_PER_S` (NVIDIA's data sheet, H100 SXM, dense, at its full
700 W power limit).  A layer's bytes are its int8 input read once, its int8
weights read once and its output written once as int8, whatever a kernel
re-reads, keeps in int32 or fuses: the work the layer needs, the same for
any routing or fusion that computes it."""

from __future__ import annotations

from .. import families

PEAK = {"int8": 1979e12, "bf16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


class ShapeWalk:
    """The `ops` of a family's walk (benchmark/families/) over square sides:
    each conv records its (input side, output side)."""

    def __init__(self, cfg):
        self.layers = {l["name"]: l for l in cfg["layers"]}
        self.sides = {}

    def conv(self, name, side):
        l = self.layers[name]
        out = (side + 2 * l["p"] - l["k"]) // l["s"] + 1
        self.sides[name] = (side, out)
        return out

    @staticmethod
    def max_pool(side, kernel, stride, padding):
        return (side + 2 * padding - kernel) // stride + 1

    @staticmethod
    def add(r, s):
        return r

    @staticmethod
    def relu(side):
        return side

    relu_into_conv = relu

    @staticmethod
    def carry(side, target):
        return side


def layer_shapes(cfg, image_size: int) -> dict:
    """{layer: (input side, output side)} of every conv at a square input
    of `image_size`; the classifier's are (1, 1)."""
    walk = ShapeWalk(cfg)
    families.load(cfg["family"]).forward(walk, cfg, image_size)
    for l in cfg["layers"]:
        if l.get("linear"):
            walk.sides[l["name"]] = (1, 1)
    return walk.sides


def layer_work(cfg, image_size: int, batch: int) -> dict:
    """{layer: (MACs, bytes)} for a batch."""
    shapes = layer_shapes(cfg, image_size)
    work = {}
    for l in cfg["layers"]:
        i, o = shapes[l["name"]]
        if l.get("linear"):
            macs = batch * l["in"] * l["out"]
            nbytes = batch * l["in"] + l["in"] * l["out"] + batch * l["out"]
        else:
            taps = l["k"] * l["k"] * (l["in"] // l["g"])
            macs = batch * o * o * l["out"] * taps
            nbytes = batch * i * i * l["in"] + taps * l["out"] + batch * o * o * l["out"]
        work[l["name"]] = (macs, nbytes)
    return work


def macs(cfg, image_size: int, batch: int = 1) -> int:
    return sum(m for m, _ in layer_work(cfg, image_size, batch).values())


def bound_s(cfg, image_size: int, batch: int, peak: str = "int8") -> float:
    """Least device seconds for the batch's convs and GEMMs: the sum over
    layers of max(2 MACs / peak, bytes / HBM bandwidth)."""
    return sum(max(2.0 * m / PEAK[peak], b / HBM_BYTES_PER_S)
               for m, b in layer_work(cfg, image_size, batch).values())
