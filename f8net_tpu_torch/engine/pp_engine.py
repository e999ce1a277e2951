"""GPipe pipeline-parallel integer inference over a mesh's pipe axis -- the
port of `f8net_tpu/engine/pp_engine.py`.

The single engine's walk is factored into an ordered list of units
(`build_units`, `:57-177`) over the port's IntEngine methods -- the head
(with the ResNet pool), one unit per block, MobileNetV2's tail, then the
average pool and the classifier -- with the single engine's own pack
targets, so every value a unit hands on is the single engine's, bit for
bit.  Units are grouped into S contiguous stages (`stage_bounds`), one per
rank of the pipe axis; each rank builds an IntEngine over its stage's
layers alone, packs their weights once, and runs them in the port's
kernels at the microbatch size.

The schedule is GPipe's: M microbatches over S stages in M + S - 1 ticks;
at tick t stage s runs microbatch t - s.  A boundary crosses from stage s
to s + 1 by send/recv in its own dtype -- a packed operand at 1 B/elt, a
bf16 value at 2, an int32 accumulator at 4 -- with a small int64 header
(shape, dtype, fraclen, pack target, rung flag) once per forward, for the
first microbatch.  Sends are asynchronous (isend): a stage goes on to its
next microbatch while the last one travels.  The last stage's logits reach
every rank of the pipe by one broadcast, as the JAX engine's final psum
(`:431`) does.  With a data axis (mesh.axes[0] of more than one row),
each row pipelines its own batch (parallel.shard_batch's slice); the
pipe's collectives stay within the row.

`sent` lists (dtype, shape) of each boundary payload this rank sent in its
last forward; `wire_bytes` their bytes.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..parallel.mesh import Mesh
from .int_engine import IAct, IntEngine

_DTYPES = (torch.int8, torch.bfloat16, torch.int32)
_HEADER = 9  # dtype, ndim, 4 dims, fl, pack target (-1: none), scaled


def build_units(model):
    """The single engine's walk as an ordered unit list.  Returns (units,
    layer_sets): units[i] is fn(engine, act) -> act (the first takes the
    conditioned input, the last returns float32 logits); layer_sets[i] the
    layers unit i reads."""
    fam = model.name
    blocks = model.blocks
    units, layer_sets = [], []
    if fam.startswith("resnet"):
        units.append(lambda e, x: e.head(x))
        layer_sets.append({"head"})
        for meta, pt in zip(blocks, [m.body[0] for m in blocks[1:]] + [None]):
            units.append(lambda e, a, meta=meta, pt=pt: e.block(meta, a, pt))
            layer_sets.append(set(meta.body) | ({meta.shortcut} if meta.shortcut else set()))
    elif fam == "mobilenet_v1":
        units.append(lambda e, x: e.head_conv(x, blocks[0].body[0]))
        layer_sets.append({"head"})
        for meta, nxt in zip(blocks, [m.body[0] for m in blocks[1:]] + [None]):
            units.append(lambda e, a, meta=meta, nxt=nxt: e.block_mbv1(meta, a, nxt))
            layer_sets.append(set(meta.body))
    elif fam == "mobilenet_v2":
        first = blocks[0]
        units.append(lambda e, x: e.head_conv(x, None if first.residual else first.body[0]))
        layer_sets.append({"head"})
        consumers = [None if nxt.residual else nxt.body[0] for nxt in blocks[1:]] + ["tail"]
        ptargets = [nxt.body[0] for nxt in blocks[1:]] + ["tail"]
        for meta, nxt, pt in zip(blocks, consumers, ptargets):
            units.append(lambda e, a, meta=meta, nxt=nxt, pt=pt: e.block_mbv2(meta, a, nxt, pt))
            layer_sets.append(set(meta.body))
        units.append(lambda e, a: e.conv_int("tail", a, relu=True))
        layer_sets.append({"tail"})
    else:
        raise NotImplementedError(f"{fam}: no pipeline units for this family")
    units.append(lambda e, a: e.classifier(e.avgpool(a)))
    layer_sets.append({"classifier"})
    return units, layer_sets


def stage_bounds(n_units: int, n_stages: int):
    """Contiguous unit ranges per stage: [start, end) pairs, near-even."""
    if not 2 <= n_stages <= n_units:
        raise ValueError(f"{n_stages} stages over {n_units} units")
    cuts = np.linspace(0, n_units, n_stages + 1).round().astype(int)
    return [(int(a), int(b)) for a, b in zip(cuts[:-1], cuts[1:])]


def make_pipe_mesh(n_stages: int, data: int = 1, device="cuda") -> Mesh:
    """A Mesh('data', 'pipe') of `data` rows of `n_stages` stages over the
    default group's first data * n_stages ranks.  Every process of the
    group must call it."""
    return Mesh((data, n_stages), ("data", "pipe"), device)


class PPEngine:
    """This rank's stage of a pipeline-parallel integer forward over
    mesh.axes[1] (the pipe axis).

    Built on every rank of the mesh from the whole baked params (tensors or
    numpy arrays): the rank keeps and packs only its stage's layers.
    Called on this data row's conditioned input (its batch a multiple of
    `microbatches`; stage 0 reads it, the other stages only its shape), it
    returns the row's float32 logits on every rank, bitwise the single
    engine's in the same rung."""

    def __init__(self, model, plan, int_params, mesh: Mesh, microbatches: int, cfg=None,
                 bounds=None, data_axis: Optional[str] = None, device="cuda",
                 int8_boundary: bool = False, bf16_boundary: bool = False):
        if not mesh.member:
            raise ValueError("this process is not a rank of the mesh")
        if data_axis is not None and data_axis != mesh.axes[0]:
            raise ValueError(f"data axis {data_axis!r}: the mesh's is {mesh.axes[0]!r}")
        self.model, self.mesh = model, mesh
        self.axis = mesh.axes[1]
        self.S, self.s = mesh.size(self.axis), mesh.index(self.axis)
        self.M = int(microbatches)
        units, layer_sets = build_units(model)
        self.bounds = bounds or stage_bounds(len(units), self.S)
        if len(self.bounds) != self.S:
            raise ValueError(f"{len(self.bounds)} stage bounds for {self.S} stages")
        a, b = self.bounds[self.s]
        self.units = units[a:b]
        self.layers = sorted(set().union(*layer_sets[a:b]))
        params = {name: {k: torch.as_tensor(v) for k, v in int_params[name].items()}
                  for name in self.layers}
        self.engine = IntEngine(model, plan, params, cfg=cfg, device=device,
                                int8_boundary=int8_boundary, bf16_boundary=bf16_boundary)
        self.device = self.engine.device
        self._names = list(model.graph.names())
        self.sent: List[tuple] = []

    # -- the wire -------------------------------------------------------------

    def _header(self, act: IAct) -> torch.Tensor:
        shape = list(act.x.shape) + [0] * (4 - act.x.ndim)
        pf = -1 if act.packed_for is None else self._names.index(act.packed_for)
        return torch.tensor([_DTYPES.index(act.x.dtype), act.x.ndim, *shape, act.fl, pf,
                             int(act.scaled)], dtype=torch.int64, device=self.device)

    def _meta(self, h: torch.Tensor):
        dt, nd, *rest = h.tolist()
        shape, (fl, pf, scaled) = rest[:4][:nd], rest[4:]
        return _DTYPES[dt], tuple(shape), fl, None if pf < 0 else self._names[pf], bool(scaled)

    # -- the schedule -----------------------------------------------------------

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        if b % self.M:
            raise ValueError(f"a batch of {b} does not split into {self.M} microbatches")
        mb = b // self.M
        S, s, axis = self.S, self.s, self.axis
        if s == 0:
            x = x.to(self.device)
        outs, works, meta, self.sent = [], [], None, []
        for t in range(self.M + S - 1):  # GPipe: stage s runs microbatch t - s at tick t
            m = t - s
            if not 0 <= m < self.M:
                continue
            if s == 0:
                act = x[m * mb:(m + 1) * mb]
            else:
                if meta is None:
                    meta = self._meta(self.mesh.recv((_HEADER,), torch.int64, axis, s - 1))
                dtype, shape, fl, pf, scaled = meta
                act = IAct(self.mesh.recv(shape, dtype, axis, s - 1), fl, packed_for=pf,
                           scaled=scaled)
            for unit in self.units:
                act = unit(self.engine, act)
            if s == S - 1:
                outs.append(act)
                continue
            if m == 0:
                works.append(self.mesh.isend(self._header(act), axis, s + 1))
            works.append(self.mesh.isend(act.x, axis, s + 1))
            self.sent.append((act.x.dtype, tuple(act.x.shape)))
        for work in works:
            work.wait()
        ncls = self.model.num_classes
        logits = torch.cat(outs) if s == S - 1 else torch.empty((b, ncls), dtype=torch.float32,
                                                                device=self.device)
        return self.mesh.broadcast(logits, axis, S - 1)

    @property
    def wire_bytes(self) -> int:
        """Bytes of the boundary payloads this rank sent in its last forward."""
        return sum(int(np.prod(shape)) * torch.empty(0, dtype=dt).element_size()
                   for dt, shape in self.sent)
