"""A grid of ranks over torch.distributed (the port of
`f8net_tpu/parallel/mesh.py:25-53`).

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

PR 11's `parallel/dist.py` stays what joins the default group
(`init_dist`); the mesh builds on it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

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


def shard_batch(mesh: Mesh, x):
    """This rank's data row's contiguous slice of a global batch (batch
    axis first): dist.shard_batch at the rank's data coordinate."""
    axis = mesh.axes[0]
    return pdist.shard_batch(x, mesh.index(axis), mesh.size(axis))


def replicate(mesh: Mesh, x) -> torch.Tensor:
    """x as a tensor on this rank's device: every rank holds all of it."""
    return torch.as_tensor(x).to(mesh.device)
