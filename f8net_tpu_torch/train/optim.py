"""SGD with momentum/nesterov and F8Net's per-parameter weight-decay schemes
(the port of `f8net_tpu/train/optim.py`).

The reference builds one param-group per tensor with a decay chosen by tensor
rank (depthwise convs detected by a grouped conv spec, BN/1-D params by rank)
-- fix_train.py:519-572.  Here the same classification happens once over the
params dict, producing a decay mask of the same structure.

Update rule matches torch.optim.SGD (dampening 0), op for op the reference's:
    g   <- g + wd * p
    buf <- mu * buf + g
    d   <- g + mu * buf   (nesterov)   |   buf   (plain momentum)
    p   <- p - lr * d
Each line is its own elementwise op under torch.no_grad(), every scalar
rounded to float32 first, with no fused multiply-add (no `alpha=`, no
`addcmul`): the card then rounds every step as the CPU and XLA's op-by-op
execution do, bit for bit.  Parameters and momentum buffers are updated in
place (the reference donates them to its jitted step).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..nn.spec import ConvBNSpec


class SGDState(NamedTuple):
    momentum: Any  # {layer: {param: buffer}} matching params


def weight_decay_mask(graph, params, scheme: str, weight_decay: float):
    """Per-parameter weight decay honoring the reference's four schemes
    (all / only_no_depthwise / only_no_bn / no_depthwise_no_bn).

    Rank mapping to the reference's tensors: conv w -> 4D (depthwise iff the
    layer is grouped), linear w -> 2D, BN gamma/beta and biases -> 1D, PACT
    alpha -> 0D."""

    def decay_for(lname: str, pname: str, leaf) -> float:
        ndim = leaf.ndim
        spec = graph[lname]
        depthwise = isinstance(spec, ConvBNSpec) and spec.groups > 1 and pname == "w"
        if scheme == "all":
            return weight_decay
        if scheme == "only_no_depthwise":
            if ndim == 4 and not depthwise:
                return weight_decay
            if ndim in (1, 2):
                return weight_decay
            return 0.0
        if scheme == "only_no_bn":
            return weight_decay if ndim in (2, 4) else 0.0
        if scheme == "no_depthwise_no_bn":
            if ndim == 4 and not depthwise:
                return weight_decay
            if ndim == 2:
                return weight_decay
            return 0.0
        raise NotImplementedError(scheme)

    return {
        lname: {pname: decay_for(lname, pname, leaf) for pname, leaf in sub.items()}
        for lname, sub in params.items()
    }


def sgd_init(params) -> SGDState:
    return SGDState(momentum={
        lname: {pname: torch.zeros_like(p) for pname, p in sub.items()}
        for lname, sub in params.items()
    })


@torch.no_grad()
def sgd_update(params, grads, state: SGDState, lr, decay_mask, momentum: float = 0.9,
               nesterov: bool = True):
    """One step, in place: every params[l][p] and state.momentum[l][p]
    tensor is overwritten; returns (params, state), the same objects.  A
    missing gradient (None, or no entry) is a zero one, as a parameter the
    loss does not reach has in the reference."""
    lr = float(lr)
    for lname, sub in params.items():
        for pname, p in sub.items():
            g = grads.get(lname, {}).get(pname)
            g = torch.zeros_like(p) if g is None else g
            buf = state.momentum[lname][pname]
            g = g + decay_mask[lname][pname] * p
            buf.mul_(momentum)
            buf.add_(g)
            d = g + momentum * buf if nesterov else buf
            p.sub_(lr * d)
    return params, state
