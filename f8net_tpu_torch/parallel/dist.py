"""Multi-process runtime helpers on torch.distributed (the port of
`f8net_tpu/parallel/dist.py`, and of `parallel/mesh.py`'s data axis).

The JAX package shards a jitted step's batch over Mesh('data') and lets
GSPMD insert the collectives; every reduction in its step spans the global
batch.  Here each process holds one shard of the global batch, and the
collectives are explicit: `AllReduceSum` carries a sum and its gradient
across processes (the QAT forward's batch statistics, `nn/quant_layers.py`),
`all_reduce_sum_` sums tensors in place (the parameter gradients,
`train/loop.py`), `all_reduce_metrics` reduces host-side metrics.

NCCL serves processes with a card each; gloo serves the CPU and processes
that share one card (NCCL refuses two ranks on one device).  gloo takes
CUDA tensors for these collectives and stages them through host memory.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch
import torch.distributed as dist


def init_dist(address: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None, backend: Optional[str] = None) -> int:
    """Joins this process to the default process group; returns its rank.

    With no address, reads what `torchrun` sets (MASTER_ADDR, MASTER_PORT,
    RANK, WORLD_SIZE, LOCAL_RANK); without those either, there is nothing
    to join and the process is rank 0 of 1.  `address` is a `tcp://host:
    port` URL, with `rank` and `world_size`.  The backend is NCCL where
    there is a card and gloo where there is none, unless `backend` says;
    under NCCL the process takes card LOCAL_RANK (or `rank`) modulo the
    cards.  A second call is a no-op."""
    if dist.is_initialized():
        return dist.get_rank()
    if address is None:
        if "MASTER_ADDR" not in os.environ or "WORLD_SIZE" not in os.environ:
            return 0
        address = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if rank is None or world_size is None:
        raise ValueError("init_dist with an address needs rank and world_size")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    device_id = None
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        device_id = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device_id)
    # NCCL told its card up front: it need not guess one from the rank
    dist.init_process_group(backend, init_method=address, rank=rank, world_size=world_size,
                            device_id=device_id)
    return dist.get_rank()


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_master() -> bool:
    return get_rank() == 0


def master_only(fn):
    """Runs `fn` on rank 0 only; elsewhere returns None."""

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        if is_master():
            return fn(*a, **kw)
        return None

    return wrapped


master_only_print = master_only(print)


def data_group():
    """The default group where it spans more than one process, else None:
    the `group` the train step, the Trainer and the QAT forward take."""
    return dist.group.WORLD if get_world_size() > 1 else None


def barrier(group=None) -> None:
    """Waits for every process of the group (no-op in one process)."""
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.barrier(group=group)


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sums `t` over the group's processes, in place (every process gets
    the same bits); returns it.  `group` may be a line of a mesh
    (`parallel.mesh.MeshLine`), whose mesh then makes and counts the
    collective."""
    if hasattr(group, "all_reduce"):
        return group.all_reduce(t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the group's processes.  Its gradient is the
    sum of the processes' gradients of y: each process's loss term reads
    every process's x through y."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum_(x.detach().clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone(memory_format=torch.contiguous_format), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group, differentiable (AllReduceSum)."""
    return AllReduceSum.apply(x, group)


def all_reduce_min(value: int, group=None) -> int:
    """The least of one integer over the group's processes."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=_collective_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return int(t)


def _collective_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_metrics(metrics: dict, reduction: str = "mean", group=None) -> dict:
    """Reduces scalar metrics across processes (`f8net_tpu/parallel/
    dist.py:66-86`): each value summed over the processes, divided by their
    number under "mean".  Returns {name: 0-d float64 tensor}, on the device
    of the first tensor among the values (else the CPU); in one process the
    values unchanged but for that type.  One collective for all values."""
    if reduction not in ("mean", "sum"):
        raise ValueError(f"reduction {reduction!r}: 'mean' or 'sum'")
    keys = list(metrics)
    device = next((v.device for v in metrics.values() if isinstance(v, torch.Tensor)),
                  torch.device("cpu"))
    values = torch.stack([torch.as_tensor(metrics[k], device=device).to(torch.float64).reshape(())
                          for k in keys]) if keys else torch.zeros(0, dtype=torch.float64)
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    if world > 1:
        values = values.to(_collective_device(group))
        dist.all_reduce(values, op=dist.ReduceOp.SUM, group=group)
        if reduction == "mean":
            values = values / world
        values = values.to(device)
    return dict(zip(keys, values.unbind(0)))


def shard_batch(batch, rank: int, world: int):
    """Process `rank`'s contiguous slice of a global batch (array or
    tensor, batch axis first): rows rank*n/world up to (rank+1)*n/world."""
    n = batch.shape[0]
    if n % world:
        raise ValueError(f"a global batch of {n} does not split over {world} processes")
    per = n // world
    return batch[rank * per:(rank + 1) * per]
