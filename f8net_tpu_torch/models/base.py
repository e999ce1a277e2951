"""Model container: the static layer graph, its block metadata and the QAT
forward (the port of `f8net_tpu/models/base.py:Model`).

The integer engine needs only the graph; `init` and `apply` drive the QAT
forward (nn/quant_layers.py), whose trained (params, state) `bake_plan`
turns into the engine's plan.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch

from ..nn.quant_layers import (
    init_conv_params, init_conv_state, init_linear_params, init_linear_state,
)
from ..nn.spec import ConvBNSpec, LayerGraph, LinearSpec
from ..utils.device import resolve_device


@dataclasses.dataclass
class Model:
    """A built model: immutable graph plus the walk order the engine uses.

    forward(params, state, x, mode='eval', cfg=None, group=None, mesh=None)
    -> (logits, new state): mode is 'train', 'eval' or 'calib'; cfg
    defaults to the build's and may be overridden per call (int_infer for
    the integer-simulation eval) as long as its structural knobs
    (normalize, format_type, pool_fusing) match the build; group: the
    process group whose global batch the training statistics span (data
    parallelism); mesh: a ('data', 'model') mesh instead, params this
    rank's slices of `parallel.mesh.param_shardings(..., tensor_parallel=
    True)` and state whole (tensor parallelism, nn/runner.py)."""

    name: str
    graph: LayerGraph
    cfg: Any
    block_setting: Any
    conv_order: List[str]  # layer names in the reference's named_modules order
    num_classes: int = 1000
    blocks: Any = None  # per-block metadata (body conv names; shortcut or residual flag)
    pool_fuse_layer: Optional[str] = None  # conv that absorbs 2^s/k^2 at int conversion
    pool_kernel: int = 7  # global-avgpool extent (image_size // 32)
    forward: Optional[Callable] = None

    def init(self, generator: torch.Generator, device="cuda"):
        """(params, state) with the reference's distributions, every layer's
        weights drawn in graph order from `generator` (on its own device)
        and placed on `device` ("cuda", the default, raises without a card).
        jax.random's draws cannot be matched bit for bit: carry a JAX init
        across with export.qat_from_numpy."""
        device = resolve_device(device)
        params, state = {}, {}
        for lname in self.graph.names():
            spec = self.graph[lname]
            if isinstance(spec, ConvBNSpec):
                params[lname] = init_conv_params(generator, spec, device)
                state[lname] = init_conv_state(self.cfg, spec, device)
            elif isinstance(spec, LinearSpec):
                params[lname] = init_linear_params(generator, spec, device)
                state[lname] = init_linear_state(self.cfg, spec, device)
        return params, state

    def apply(self, params, state, x, mode: str = "eval", cfg=None, group=None, mesh=None):
        """QAT forward of NHWC float images x -> (logits, new state)."""
        return self.forward(params, state, x, mode, cfg or self.cfg, group, mesh)
