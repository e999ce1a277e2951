"""Tensor-parallel integer inference over a mesh's model axis -- the port of
`f8net_tpu/engine/tp_engine.py` (the Megatron pairing at model level).

Every layer gets a parallel mode (`tp_modes`, `:47-79`):

  rep    replicated: the ResNet stem, whole in K3 on every rank
  col    out-channels sharded; the input whole; the output stays sharded
  shard  depthwise on the sharded activation (K4)
  row    in-channels sharded (the producer's shard, or sliced here from a
         whole input); each rank's int32 partial, one all-reduce, then the
         requant, pack or bf16 conversion of the total

so a forward issues one all-reduce per row layer and no all-gather:
MobileNetV2 expand -> depthwise -> project runs col -> shard -> row,
MobileNetV1 depthwise -> pointwise shard -> row, a ResNet block body.0 col
and the rest of its body and its shortcut row; the classifier is row.

Each rank is an `IntEngine` over its own slice of the model
(`tp_local_params`): the same graph with each layer's sharded channel axis
cut to this rank's share, its weights packed once at construction in the
kernels' layouts, its products in the port's kernels at these shard shapes
-- K2 and K7 or K1 on a col layer's O/tp columns, K4 on C/tp channels, K2,
K7 or K1 with the int32 epilogue on a row layer's K/tp rows.  A MobileNetV2
block that the single engine runs whole in K5 runs its col -> shard -> row
as one K5 call on the rank's Ce/tp slice, int32 out with no carry; the
all-reduce, the carry add and the rung's conversion follow.

Exactness (`:19-24`): int32 additions wrap, and a wrapping sum of the
ranks' partials is the single engine's accumulator; clips and requants run
only on the total.  The zero-point compensation 128*colsum(w) splits with
the rows: each rank's row layer folds 128*colsum of its own rows into its
bias, and the layer's bias b is added once, by rank 0 (the others' b is
zero), so the partials' biases sum to the single engine's b_zp.  A col or
shard layer's bias is its slice of b_zp.  So every rung's logits are the
single engine's, bit for bit.

Shard shapes: where a sharded channel count C/tp outside a K5 block is not
a multiple of 16 (K4 takes C % 16 == 0; K2 reads its input in 16-byte
chunks), the rank's shard is padded with zero channels to the next multiple
of 16, at construction: zero weights and zero bias in the col or shard
layer that makes them, zero rows in the row layer that reads them -- the
head's pad to 16 input channels (int_engine.py) over again.  The known
cases: MobileNetV1's and MobileNetV2's head and first depthwise at C = 32/4,
MobileNetV2's stride-2 expansions 96/4, 144/2 and 144/4.  K5 takes every
Ce/tp (multiples of 4) as it is.  Every other shape is the single engine's
routing at the shard shape (IntEngine.on_k7: K7 where ops.gemm_v2.takes,
K1 otherwise).

Not ported (TPU exactness workarounds): f32_requant, requant_bounds,
mxu_bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..nn.spec import LayerGraph, LinearSpec
from ..parallel.mesh import Mesh, shard_batch
from .int_engine import IAct, IntEngine, fuses_ir

SHARD_ALIGN = 16  # a sharded channel count outside K5 is padded to a multiple of this


def tp_modes(model) -> dict:
    """Layer name -> parallel mode for the Megatron pairing."""
    fam = model.name
    modes = {}
    if fam.startswith("resnet"):
        modes["head"] = "rep"
        for meta in model.blocks:
            modes[meta.body[0]] = "col"
            for nm in meta.body[1:]:
                modes[nm] = "row"
            if meta.shortcut is not None:
                modes[meta.shortcut] = "row"
    elif fam == "mobilenet_v1":
        modes["head"] = "col"
        for meta in model.blocks:
            modes[meta.body[0]] = "shard"  # depthwise
            modes[meta.body[1]] = "row"
    elif fam == "mobilenet_v2":
        modes["head"] = "col"
        for meta in model.blocks:
            if len(meta.body) == 3:
                modes[meta.body[0]] = "col"
                modes[meta.body[1]] = "shard"
                modes[meta.body[2]] = "row"
            else:  # the t=1 first block: dw -> pw, never residual (32 -> 16)
                if meta.residual:
                    raise NotImplementedError(f"a residual two-layer block: {meta}")
                modes[meta.body[0]] = "shard"
                modes[meta.body[1]] = "row"
        modes["tail"] = "col"
    else:
        raise NotImplementedError(f"{fam}: no tensor-parallel modes for this family")
    modes["classifier"] = "row"
    return modes


def tp_param_specs(model, modes) -> dict:
    """{layer: {"w": the weight axis cut across the ranks, or None; "b": 0
    where the bias is cut, else None}}: the port's form of the JAX
    PartitionSpecs (`:82-100`).  A row layer's b is whole and added once."""
    specs = {}
    for name in model.graph.names():
        entry, mode = model.graph[name], modes[name]
        if isinstance(entry, LinearSpec):
            w = 0 if mode == "row" else 1
        elif mode in ("col", "shard"):
            w = 3  # HWIO out-channels (depthwise: O == C)
        elif mode == "row":
            w = 2  # HWIO in-channels
        else:
            w = None
        specs[name] = {"w": w, "b": 0 if mode in ("col", "shard") else None}
    return specs


def tp_input_sharded(model, modes) -> Dict[str, bool]:
    """{layer: whether its input arrives sharded}: the output of a col or
    shard layer is sharded, of a row or rep layer (and a residual add)
    whole."""
    sharded = lambda name: modes[name] in ("col", "shard")
    out, s = {"head": False}, sharded("head")
    for meta in model.blocks:
        v = s
        for name in meta.body:
            out[name], v = v, sharded(name)
        if getattr(meta, "shortcut", None) is not None:
            out[meta.shortcut] = s
        s = v  # every body ends in a row layer: a block's output (and its sum) is whole
    if "tail" in modes:
        out["tail"], s = s, sharded("tail")
    out["classifier"] = s
    return out


def shard_widths(model, modes, tp: int) -> Dict[str, tuple]:
    """{layer: (C, cs, cp)} for the channel axis each col, shard and row
    layer cuts: its whole count C, the share cs = C / tp of one rank, and
    the width cp that share is padded to (SHARD_ALIGN outside K5 blocks)."""
    g = model.graph
    in_k5 = {n for m in model.blocks if model.name == "mobilenet_v2" and fuses_ir(g, m)
             for n in m.body}
    out = {}
    for name in g.names():
        spec, mode = g[name], modes[name]
        if mode == "rep":
            continue
        if isinstance(spec, LinearSpec):
            c = spec.out_features if mode == "col" else spec.in_features
        else:
            c = spec.out_ch if mode in ("col", "shard") else spec.in_ch
        if c % tp:
            raise ValueError(f"{name}: {c} channels do not split over {tp} ranks")
        cs = c // tp
        cp = cs if name in in_k5 else -(-cs // SHARD_ALIGN) * SHARD_ALIGN
        out[name] = (c, cs, cp)
    return out


def _index(c: int, cs: int, cp: int, rank: int) -> torch.Tensor:
    """This rank's channels of an axis of c, padded with -1 (a zero) to cp."""
    idx = torch.arange(rank * cs, (rank + 1) * cs)
    return torch.cat([idx, torch.full((cp - cs,), -1, dtype=torch.long)])


def _take(t: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """t's entries at idx along dim, zeros where idx is -1."""
    z = torch.zeros_like(t.narrow(dim, 0, 1))
    return torch.cat([t, z], dim).index_select(dim, torch.where(idx < 0, t.shape[dim], idx))


def tp_local_params(model, int_params, tp: int, rank: int, modes=None):
    """This rank's share of the whole baked int params (numpy arrays or
    tensors, {layer: {"w", "b"}}) and the graph it computes: (LayerGraph,
    {layer: {"w": int8, "b": int32}} as CPU tensors).  col and shard layers
    take their slice of w's out-channels and of b; row layers their slice
    of w's in-channels (rows), with b on rank 0 and zeros elsewhere; rep
    layers all of it; shards padded with zero channels to shard_widths'
    cp.  The zero-point bias is not folded here: IntEngine folds
    128*colsum of the rank's own rows."""
    modes = modes or tp_modes(model)
    specs = tp_param_specs(model, modes)
    widths = shard_widths(model, modes, tp)
    local, graph = {}, {}
    for name in model.graph.names():
        spec, mode = model.graph[name], modes[name]
        entry = {k: torch.as_tensor(v).cpu() for k, v in int_params[name].items()}
        w = entry["w"]
        b = entry.get("b", torch.zeros(w.shape[-1], dtype=torch.int32))
        if mode == "rep":
            local[name], graph[name] = {"w": w, "b": b}, spec
            continue
        c, cs, cp = widths[name]
        idx = _index(c, cs, cp, rank)
        w = _take(w, specs[name]["w"], idx)
        if mode == "row":
            b = b if rank == 0 else torch.zeros_like(b)
        else:
            b = _take(b, 0, idx)
        local[name] = {"w": w, "b": b}
        if isinstance(spec, LinearSpec):
            graph[name] = dataclasses.replace(
                spec, **({"in_features": cp} if mode == "row" else {"out_features": cp}))
        elif mode == "col":
            graph[name] = dataclasses.replace(spec, out_ch=cp)
        elif mode == "shard":
            graph[name] = dataclasses.replace(spec, in_ch=cp, out_ch=cp, groups=cp)
        else:
            graph[name] = dataclasses.replace(spec, in_ch=cp)
    return LayerGraph(graph), local


class TPEngine(IntEngine):
    """This rank's part of a tensor-parallel integer forward over
    mesh.axes[1] (the model axis) of `mesh`.

    Built on every rank of the mesh from the whole baked params (numpy
    arrays or tensors): the rank keeps and packs only its share
    (tp_local_params).  Called on this data row's conditioned input (every
    rank of the row the same; parallel.shard_batch gives the row's slice of
    a global batch), it returns the row's float32 logits on every rank.
    The rungs are IntEngine's (strict, int8_boundary, bf16_boundary), and
    each equals the single engine's bit for bit.  `mesh.counts` counts the
    all-reduces (one per row layer per forward)."""

    def __init__(self, model, plan, int_params, mesh: Mesh, cfg=None, device="cuda",
                 int8_boundary: bool = False, bf16_boundary: bool = False):
        if not mesh.member:
            raise ValueError("this process is not a rank of the mesh")
        self.mesh = mesh
        self.axis = mesh.axes[1]
        self.tp, self.rank = mesh.size(self.axis), mesh.index(self.axis)
        self.modes = tp_modes(model)
        self.widths = shard_widths(model, self.modes, self.tp)
        self._in_sharded = tp_input_sharded(model, self.modes)
        graph, local = tp_local_params(model, int_params, self.tp, self.rank, self.modes)
        super().__init__(dataclasses.replace(model, graph=graph), plan, local, cfg=cfg or model.cfg,
                         device=device, int8_boundary=int8_boundary, bf16_boundary=bf16_boundary)

    # -- sharding glue ------------------------------------------------------

    def _local(self, act: IAct, name: str) -> IAct:
        """A whole activation -> this rank's channels of it for layer `name`
        (padded with zeros to the layer's shard width)."""
        _, cs, cp = self.widths[name]
        x = act.x[..., self.rank * cs:(self.rank + 1) * cs]
        x = F.pad(x, (0, cp - cs)) if cp > cs else x.contiguous()
        return act._replace(x=x)

    def _sliced(self, act: IAct, name: str) -> IAct:
        if self.modes[name] in ("row", "shard") and not self._in_sharded[name]:
            return self._local(act, name)
        return act

    def _reduce(self, y: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(y, self.axis)

    # -- layers ---------------------------------------------------------------

    def conv_int(self, name: str, act: IAct, pack_output_for: Optional[str] = None,
                 relu: bool = False) -> IAct:
        return super().conv_int(name, self._sliced(act, name), pack_output_for, relu)

    def _product(self, name, x8, w, pack_output_for, relu=False) -> IAct:
        """A col, shard or rep layer: IntEngine's product on the rank's
        shard.  A row layer: the rank's int32 partial (its rows, its share
        of the bias), the all-reduce, then ReLU and the requant8 pack or
        the int32 (bf16) emission on the total."""
        if self.modes[name] != "row":
            return super()._product(name, x8, w, pack_output_for, relu)
        total = self._reduce(self._run(name, x8, w, epilogue="int32"))
        if relu:
            total = total.clamp_min(0)
        a = IAct(total, self.plan[name].out_fl)
        if pack_output_for is not None:
            return self.pack_for(a, pack_output_for)
        return self._emit(a)

    def fused_ir(self, meta, a: IAct, next_consumer: Optional[str],
                 pack_target: Optional[str] = None) -> IAct:
        """A block the single engine runs whole in K5: K5 on the rank's Ce
        slice with its share of the project's bias, int32 out, no carry;
        the all-reduce; then the single engine's ending on the total -- the
        carry added on the common grid (strict: int32; int8 rung: the
        1-byte carry widened, then packed for `pack_target`; bf16 rung: the
        total converted, then the bf16 add), or the pack for the unique
        consumer, or the int32 (bf16) emission."""
        en, dn, pn = meta.body
        ple, pld, plp = self.plan[en], self.plan[dn], self.plan[pn]
        ap = self.pack_for(a, en)
        y = self._irk(ap.x, *self._fused[en], out="int32",
                      net1=ple.out_fl - pld.input_fl, dw_in_signed=pld.input_symmetric,
                      net2=pld.out_fl - plp.input_fl, proj_in_signed=plp.input_symmetric)
        y = IAct(self._reduce(y), plp.out_fl)
        if meta.residual:
            out = self.add_int(self._emit(y), a)
            if self.int8_boundary and pack_target is not None:
                return self.pack_for(out, pack_target)
            return out
        if next_consumer is None and self.int8_boundary and pack_target is not None:
            next_consumer = pack_target
        if next_consumer is not None:
            return self.pack_for(y, next_consumer)
        return self._emit(y)

    def classifier(self, a: IAct) -> torch.Tensor:
        """The rank's rows of the classifier in K1, int32, all-reduced."""
        a = self.pack_for(self._sliced(a, "classifier"), "classifier")
        p = self.params["classifier"]
        b = p["b"] if self.plan["classifier"].input_symmetric else p["b_zp"]
        y = self._gemm(a.x, self._packed["classifier"], b, epilogue="int32")
        return self._reduce(y).to(torch.float32)


def int_forward_tp(model, plan, int_params, x, mesh: Mesh, cfg=None, device="cuda",
                   int8_boundary: bool = False, bf16_boundary: bool = False) -> torch.Tensor:
    """TPEngine(...) on this rank's data row of the conditioned global
    batch x: the row's logits (`f8net_tpu/engine/tp_engine.py:
    int_forward_tp` returns the global batch's; here each row holds its
    own)."""
    eng = TPEngine(model, plan, int_params, mesh, cfg=cfg, device=device,
                   int8_boundary=int8_boundary, bf16_boundary=bf16_boundary)
    return eng(shard_batch(mesh, x))
