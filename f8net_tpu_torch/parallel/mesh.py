"""A grid of ranks over torch.distributed and the tensor-parallel layout
of the QAT params (the port of `f8net_tpu/parallel/mesh.py`).

The JAX package lays its devices out as Mesh('data', 'model') and lets
shard_map name an axis in each collective.  Here each process is one rank
of the default process group, and a `Mesh` arranges the group's ranks as a
grid: rank = data_index * model + model_index (data-major, as
`jax.make_mesh` reshapes its device list), with one torch.distributed
subgroup per row and per column.  Every process of the default group
creates every subgroup, in the same order, as `new_group` requires; a
process outside the mesh's ranks (a smaller mesh on a larger group) joins
none and is not a member.

The mesh's collectives count themselves (`counts`: calls and payload bytes
per kind), which is how the engines' tests and chip_smoke.py hold a forward
to its all-reduces and its wire bytes.  NCCL moves card tensors device to
device; gloo takes CPU tensors, and a card tensor on a gloo group (ranks
that share one card: NCCL refuses two ranks on one device) is staged
through pinned host memory both ways -- a transport, the same collective.

The layout (`param_shardings`, `:55-94`): the JAX package hands GSPMD a
PartitionSpec per leaf; here a leaf's spec is the axis cut over 'model'
(this rank holds its slice: `shard_params`), or None where every rank
holds the leaf whole -- the form `engine/tp_engine.py:tp_param_specs`
uses.  `parallel/tp_train.py` computes a step on such shards.

PR 11's `parallel/dist.py` stays what joins the default group
(`init_dist`); the mesh builds on it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..nn.spec import ConvBNSpec
from ..utils.device import resolve_device
from . import dist as pdist


class Mesh:
    """A (rows x columns) grid of the default process group's first
    rows * columns ranks, axes named `axes` (("data", "model") or
    ("data", "pipe")).

    coords[axis]: this rank's index on the axis; groups[axis]: the
    subgroup of this rank's line along the axis (None where the axis has
    one rank); ranks[axis]: that line's global ranks; device: where this
    rank computes."""

    def __init__(self, shape: Tuple[int, int], axes: Tuple[str, str] = ("data", "model"),
                 device="cuda"):
        rows, cols = shape
        if rows < 1 or cols < 1:
            raise ValueError(f"mesh shape {shape}")
        self.axes = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axes, (rows, cols)))
        world = dist.get_world_size() if dist.is_initialized() else 1
        me = dist.get_rank() if dist.is_initialized() else 0
        if rows * cols > world:
            raise ValueError(f"mesh {shape} over a group of {world}")
        ranks = list(range(rows * cols))
        self.member = me in ranks
        self.backend = dist.get_backend() if dist.is_initialized() else None
        grid = [ranks[i * cols:(i + 1) * cols] for i in range(rows)]
        lines = {self.axes[0]: [[grid[i][j] for i in range(rows)] for j in range(cols)],
                 self.axes[1]: grid}
        self.groups: Dict[str, Optional[object]] = {}
        self.ranks: Dict[str, list] = {}
        self.coords: Dict[str, int] = {}
        for axis in self.axes:
            for line in lines[axis]:
                # every process creates every subgroup, in this order
                group = dist.new_group(line) if len(line) > 1 else None
                if me in line:
                    self.groups[axis], self.ranks[axis] = group, line
                    self.coords[axis] = line.index(me)
        self.device = resolve_device(device) if self.member else None
        if self.member and self.device.type == "cuda" and self.backend == "nccl":
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.counts: Dict[str, int] = {}
        self._staging: Dict[Tuple, torch.Tensor] = {}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def reset_counts(self) -> None:
        self.counts = {}

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1
        key = f"{kind}_bytes"
        self.counts[key] = self.counts.get(key, 0) + t.numel() * t.element_size()

    def _staged(self, t: torch.Tensor) -> bool:
        return t.device.type == "cuda" and self.backend != "nccl"

    def _host(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        """A pinned host buffer of t's shape and dtype (one per slot, shape
        and dtype, reused across calls)."""
        key = (slot, tuple(t.shape), t.dtype)
        buf = self._staging.get(key)
        if buf is None:
            buf = self._staging[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of t over the axis's ranks, in place (int32 sums wrap as
        int32 additions do); returns t.  One collective, or none on an
        axis of one rank."""
        group = self.groups.get(axis)
        if group is None:
            return t
        self._count("all_reduce", t)
        if self._staged(t):
            h = self._host(t, "all_reduce")
            h.copy_(t)
            dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group)
            t.copy_(h)
        else:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """Every rank's t along the axis, concatenated on `dim` in the
        line's order (a new tensor on t's device; t itself on an axis of
        one rank).  Counted with the bytes of this rank's t."""
        group = self.groups.get(axis)
        if group is None:
            return t
        self._count("all_gather", t)
        src = t.contiguous()
        if self._staged(t):
            h = self._host(src, "all_gather")
            h.copy_(src)
            parts = [torch.empty_like(h) for _ in range(self.shape[axis])]
            dist.all_gather(parts, h, group=group)
            return torch.cat(parts, dim).to(t.device)
        if self.backend == "nccl":
            out = torch.empty((self.shape[axis], *src.shape), dtype=src.dtype, device=src.device)
            dist.all_gather_into_tensor(out, src, group=group)
            return torch.cat(out.unbind(0), dim)
        parts = [torch.empty_like(src) for _ in range(self.shape[axis])]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim)

    def line(self, axis: str) -> Optional["MeshLine"]:
        """This rank's line along the axis as a `group` for the statistics
        of ops.fxp and parallel.dist (their sums then go through the mesh
        and are counted); None on an axis of one rank."""
        return MeshLine(self, axis) if self.groups.get(axis) is not None else None

    def broadcast(self, t: torch.Tensor, axis: str, src: int) -> torch.Tensor:
        """t from the rank at index `src` of the axis to every rank of it, in
        place; returns t."""
        group = self.groups.get(axis)
        if group is None:
            return t
        self._count("broadcast", t)
        root = self.ranks[axis][src]
        if self._staged(t):
            h = t.cpu()
            dist.broadcast(h, root, group=group)
            t.copy_(h)
        else:
            dist.broadcast(t, root, group=group)
        return t

    def isend(self, t: torch.Tensor, axis: str, dst: int):
        """Starts sending t to the rank at index `dst` of the axis; returns
        the work (wait on it before t is written again)."""
        self._count("send", t)
        peer = self.ranks[axis][dst]
        if self._staged(t):
            t = t.cpu()
        return _Sent(dist.isend(t.contiguous(), peer, group=self.groups[axis]), t)

    def recv(self, shape, dtype, axis: str, src: int, device=None) -> torch.Tensor:
        """A tensor of `shape` and `dtype` from the rank at index `src` of the
        axis, on `device` (default: this rank's device; NCCL receives on the
        card only)."""
        peer = self.ranks[axis][src]
        dev = self.device if device is None else torch.device(device)
        staged = dev.type == "cuda" and self.backend != "nccl"
        buf = torch.empty(shape, dtype=dtype, device="cpu" if staged else dev)
        dist.recv(buf, peer, group=self.groups[axis])
        self._count("recv", buf)
        return buf.to(dev) if staged else buf

    def ring(self, t: torch.Tensor, axis: str):
        """Starts passing t one step around the axis's ring: sends it to
        index + 1 and receives the tensor index - 1 holds (same shape and
        dtype), both in one batch_isend_irecv.  Returns a function that
        waits and gives the received tensor, on t's device."""
        n, i = self.shape[axis], self.coords[axis]
        group, line = self.groups[axis], self.ranks[axis]
        staged = self._staged(t)
        src = t.cpu() if staged else t.contiguous()
        got = torch.empty_like(src)
        self._count("send", src)
        self._count("recv", got)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, line[(i + 1) % n], group),
            dist.P2POp(dist.irecv, got, line[(i - 1) % n], group),
        ])

        def wait() -> torch.Tensor:
            for w in works:
                w.wait()
            return got.to(t.device) if staged else got

        return wait


class MeshLine:
    """One line of a mesh, standing where a process group would: its
    `all_reduce` is the mesh's, counted (parallel.dist.all_reduce_sum_
    takes it)."""

    def __init__(self, mesh: Mesh, axis: str):
        self.mesh, self.axis = mesh, axis

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(t, self.axis)


class _Sent:
    """An isend's work, holding its buffer alive until it is waited on."""

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        self.work.wait()
        self.buf = None


def make_mesh(data: int = -1, model: int = 1, device="cuda") -> Mesh:
    """A Mesh('data', 'model') over the default group's first data * model
    ranks; data=-1 means all of them.  Every process of the group must call
    it."""
    if data == -1:
        n = dist.get_world_size() if dist.is_initialized() else 1
        if n % model:
            raise ValueError(f"{n} ranks do not split into model axes of {model}")
        data = n // model
    return Mesh((data, model), ("data", "model"), device)


def batch_sharding(mesh: Mesh):
    """The batch's layout: a function giving this rank's data row's
    contiguous slice of a global batch (batch axis first), the
    counterpart of the JAX NamedSharding(mesh, P('data'))."""
    axis = mesh.axes[0]
    return lambda x: pdist.shard_batch(x, mesh.index(axis), mesh.size(axis))


def shard_batch(mesh: Mesh, x):
    """This rank's data row's slice of a global batch (batch_sharding)."""
    return batch_sharding(mesh)(x)


# -- the tensor-parallel layout of the QAT params ------------------------------

CHANNEL_LEAVES = ("gamma", "beta", "bias", "b", "bn_mean", "bn_var")


def _tp_spec_for(pname: str, shape, model_axis_size: int) -> Optional[int]:
    """A leaf's cut axis (`:55-68`): conv HWIO and linear (in, out)
    weights on their last (out-channel) axis, the vectors that follow the
    channel on axis 0; a scalar, any other leaf (alpha), and a leaf whose
    out-channels do not divide by the model axis stay whole (None)."""
    if len(shape) == 0 or shape[-1] % model_axis_size != 0:
        return None
    if pname == "w":
        return len(shape) - 1
    if pname in CHANNEL_LEAVES:
        return 0
    return None


def _layer_spec_for(spec, pname: str, shape, model_axis_size: int) -> Optional[int]:
    """_tp_spec_for within a layer: a depthwise layer stays whole
    (`:82-83`)."""
    if model_axis_size == 1 or (isinstance(spec, ConvBNSpec) and spec.is_depthwise):
        return None
    return _tp_spec_for(pname, shape, model_axis_size)


def param_shardings(graph, params, mesh: Mesh, tensor_parallel: bool = False) -> dict:
    """{layer: {leaf: its cut axis over 'model', or None}} for whole QAT
    params (`:71-89`): all None for pure data parallelism (or a model axis
    of one rank); out-channel cuts under tensor_parallel, depthwise layers
    kept whole."""
    msize = mesh.size("model") if tensor_parallel else 1
    return {lname: {pname: _layer_spec_for(graph[lname], pname, tuple(leaf.shape), msize)
                    for pname, leaf in sub.items()} for lname, sub in params.items()}


def int_param_shardings(graph, int_params, mesh: Mesh, tensor_parallel: bool = True) -> dict:
    """The same layout for the integer engine's {w: int8, b: int32} params
    (`:92-94`)."""
    return param_shardings(graph, int_params, mesh, tensor_parallel)


def tp_layers(graph, model_axis_size: int) -> frozenset:
    """The layers whose params param_shardings cuts: those whose weight it
    cuts (every leaf of a layer but alpha ends in its out-channel axis, so
    the weight's shape from the graph decides for all of them)."""
    return frozenset(spec.name for spec in graph
                     if _layer_spec_for(spec, "w", spec.weight_shape(), model_axis_size)
                     is not None)


def shard_params(tree, specs, mesh: Mesh) -> dict:
    """This rank's slice of every cut leaf of a whole tree ({layer: {leaf:
    tensor}}; whole leaves as they are), by `specs` from param_shardings:
    the counterpart of a device_put with the param shardings."""
    n, i = mesh.size("model"), mesh.index("model")

    def take(t, axis):
        if axis is None:
            return t
        per = t.shape[axis] // n
        return t.narrow(axis, i * per, per).contiguous()

    return {l: {k: take(v, specs[l][k]) for k, v in sub.items()} for l, sub in tree.items()}


def gather_params(tree, specs, mesh: Mesh) -> dict:
    """shard_params' inverse: every cut leaf whole on every rank, its
    slices joined along its axis in the model line's order.  One
    all-gather per dtype carries every cut leaf of it."""
    n = mesh.size("model")
    out = {l: dict(sub) for l, sub in tree.items()}
    by_dtype: Dict[torch.dtype, list] = {}
    for l, sub in tree.items():
        for k, v in sub.items():
            if specs[l][k] is not None:
                by_dtype.setdefault(v.dtype, []).append((l, k, v))
    for leaves in by_dtype.values():
        flat = torch.cat([v.reshape(-1) for _, _, v in leaves])
        parts = mesh.all_gather(flat, "model").view(n, -1)  # row r: rank r's slices
        at = 0
        for l, k, v in leaves:
            slices = parts[:, at:at + v.numel()].reshape(n, *v.shape).unbind(0)
            out[l][k] = torch.cat(slices, specs[l][k])
            at += v.numel()
    return out


def replicate(mesh: Mesh, x) -> torch.Tensor:
    """x as a tensor on this rank's device: every rank holds all of it."""
    return torch.as_tensor(x).to(mesh.device)
