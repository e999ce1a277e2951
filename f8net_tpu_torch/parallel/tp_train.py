"""Tensor-parallel QAT training on a mesh's model line (the port of what
GSPMD makes of `f8net_tpu/parallel/mesh.py:param_shardings` in the step
`__graft_entry__.dryrun_multichip` trains).

The JAX package puts the QAT params out-channel sharded over 'model' and
lets GSPMD insert every collective.  Here each rank holds its slice of a
cut layer's leaves (`parallel.mesh.shard_params`) and computes only that
layer's out-channels; two autograd functions -- Megatron's f and g -- join
the slices to the whole tensors around them:

  f  (`copy`)    identity forward; backward sums the gradients over the
                 model line (one all-reduce for all of a layer's inputs)
  g  (`gather`)  all-gather along the channel axis forward; backward
                 keeps this rank's slice of the gradient

Three facts decide correctness:
  * Everything downstream of a g runs whole and identically on every
    rank of the model line (ReLUs, residual adds, pools, a layer the
    layout keeps whole, the loss).  So the gradient reaching g is the
    same whole tensor on every rank, and g's backward slices it: a
    reduce-scatter would multiply it by the model size.
  * A tensor that every rank holds whole enters a cut layer through f:
    its input and its clip scales fs_self and fs_next (built from alpha,
    which stays whole).  Each rank's gradient of it covers only its own
    out-channels; f sums the shares.
  * No whole parameter's gradient is summed over the model line after the
    backward: f has made it whole already, and a second sum would double
    it.  A whole layer's params get their whole gradient on every rank.

A cut layer's weight statistics span the whole weight (`ops.fxp`'s
metric and grid search over the model line; the standardization's std),
its BN moments span the data line's global batch, and its BN running
statistics are all-gathered after the update, so every rank holds the
whole state.
"""

from __future__ import annotations

from typing import Optional

import torch

from .mesh import Mesh, tp_layers


class _Copy(torch.autograd.Function):
    """Megatron's f on several tensors: identity forward; backward their
    gradients summed over the model line, in one all-reduce of their
    concatenation."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        outs = tuple(x.view_as(x) for x in xs)
        # an input without a gradient (the images) stays without one: no
        # backward of the convs that read it
        ctx.mark_non_differentiable(*(o for o, n in zip(outs, ctx.needs_input_grad[1:]) if not n))
        return outs

    @staticmethod
    def backward(ctx, *gs):
        need = ctx.needs_input_grad[1:]
        live = [g for g, n in zip(gs, need) if n]
        flat = ctx.mesh.all_reduce(torch.cat([g.reshape(-1) for g in live]), "model")
        parts = iter(flat.split([g.numel() for g in live]))
        return (None, *(next(parts).view(g.shape) if n else None for g, n in zip(gs, need)))


class _Gather(torch.autograd.Function):
    """Megatron's g: every rank's slice all-gathered along `dim` forward,
    this rank's slice of the (whole, alike on every rank) gradient
    backward."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.width = mesh, dim, x.shape[dim]
        return mesh.all_gather(x, "model", dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index("model")
        return g.narrow(ctx.dim, i * ctx.width, ctx.width), None, None


class Whole:
    """A layer every rank computes whole: no collective, the tensors as
    they are (the one-process forward)."""

    group = None

    def copy(self, *ts):
        return ts

    def local(self, t):
        return t

    def gather(self, t, dim: int):
        return t

    def gather_state(self, t):
        return t


WHOLE = Whole()


class Cut:
    """A layer cut over the model line: this rank's out-channels.
    `group`: the model line, for the statistics of the whole weight."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.group = mesh.line("model")
        self.size, self.index = mesh.size("model"), mesh.index("model")

    def copy(self, *ts):
        """f: tensors whole on every rank, their gradients summed over the
        line."""
        return _Copy.apply(self.mesh, *ts)

    def local(self, t):
        """This rank's slice of a whole per-channel vector (axis 0); a
        one-element one (a per-layer scale) as it is."""
        if t.numel() == 1:
            return t
        per = t.shape[0] // self.size
        return t[self.index * per:(self.index + 1) * per]

    def gather(self, t, dim: int):
        """g: the layer's output whole on every rank."""
        return _Gather.apply(t, self.mesh, dim)

    def gather_state(self, t):
        """A per-channel state update whole on every rank (no gradient)."""
        return self.mesh.all_gather(t.detach(), "model", t.ndim - 1)


class TensorParallel:
    """The model line of `mesh` as a model's QAT forward uses it: which
    layers the layout cuts (`parallel.mesh.tp_layers`) and, per layer, its
    Cut or WHOLE.  Without a mesh, or on a model axis of one rank, every
    layer is WHOLE."""

    def __init__(self, graph, mesh: Optional[Mesh] = None):
        self.layers = frozenset() if mesh is None else tp_layers(graph, mesh.size("model"))
        self._cut = Cut(mesh) if self.layers else None

    def of(self, name: str):
        return self._cut if name in self.layers else WHOLE


def data_line(mesh):
    """The `group` of the data line's statistics: its process group, or
    None on a mesh (or a data axis) of one rank."""
    return None if mesh is None else mesh.groups.get("data")
