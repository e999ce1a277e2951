"""Forward-pass runner: threads state updates through a model's QAT forward
(the port of `f8net_tpu/nn/runner.py`).

Each layer application returns its updates (EMA fraclens, BN running
statistics); the runner overlays them on its view of the state, so later
layers see earlier layers' updates of the same batch (a residual chain's
master EMA), and `finalize()` gives the new state.
"""

from __future__ import annotations

from typing import Dict

import torch.nn.functional as F

from ..parallel.tp_train import TensorParallel, data_line
from .quant_layers import Act, _quantize_input, as_act, conv_bn_apply, linear_apply


class Runner:
    """`group`: the process group whose global batch the training
    forward's statistics span (None: this process's batch).  `mesh`: a
    ('data', 'model') mesh instead (parallel.mesh) -- the statistics span
    its data line, and on a model line of more than one rank the layers
    that the layout cuts run tensor-parallel on this rank's param slices
    (parallel/tp_train.py); on a model axis of one rank the forward is the
    data-parallel one over the data line."""

    def __init__(self, graph, cfg, params, state, mode: str = "eval", group=None, mesh=None):
        if mesh is not None and group is not None:
            raise ValueError("a forward takes a group or a mesh, not both")
        self.graph = graph
        self.group = data_line(mesh) if mesh is not None else group
        self.tp = TensorParallel(graph, mesh)
        self.cfg = cfg
        self.params = params
        self.mode = mode
        self.state = {k: dict(v) for k, v in state.items()}

    def _merge(self, updates: Dict[str, Dict]):
        for lname, upd in updates.items():
            d = dict(self.state[lname])
            d.update(upd)
            self.state[lname] = d

    def conv(self, name: str, act) -> Act:
        y, upd = conv_bn_apply(self.graph, self.cfg, name, self.params, self.state, act, self.mode,
                               self.group, self.tp.of(name))
        self._merge(upd)
        return y

    def linear(self, name: str, act) -> Act:
        y, upd = linear_apply(self.graph, self.cfg, name, self.params, self.state, act, self.mode,
                              self.group, self.tp.of(name))
        self._merge(upd)
        return y

    def relu(self, act) -> Act:
        a = as_act(act)
        return Act(F.relu(a.x), a.fl)

    def boundary_quant(self, name: str, act) -> Act:
        """Deployment-aware QAT boundary (cfg.qat_boundary == 'int8'): a
        residual block's input quantized onto conv `name`'s 8-bit input grid
        with the straight-through gradient, as the int8-boundary engine's
        1-byte carry is.  The conv's own fraclen rule applies (live metric
        in training, rounded EMA at eval); its EMA update is dropped, since
        the conv makes it when it reads this tensor."""
        a = as_act(act)
        x_val, _, _ = _quantize_input(
            self.graph, self.cfg, name, self.state, a.x, self.mode in ("train", "calib"),
            self.group,
        )
        return Act(x_val, None)

    @property
    def int_sim(self) -> bool:
        """Integer-simulation eval (int_infer gates the fraclen-aligned
        residual adds)."""
        return self.cfg.int_infer and self.mode == "eval"

    def finalize(self):
        return self.state
