"""Quantization configuration (copy of `f8net_tpu/utils/config.py:QuantConfig`).

The port keeps the reference's flag vocabulary unchanged so that a config
that drives the JAX package drives the port too.  The integer engine reads
`normalize` and `quant_avgpool`, the graphs `pool_fusing`; the other fields
steer the QAT forward (nn/quant_layers.py) and the bake (quant/plan.py).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization behavior knobs (field for field the JAX `QuantConfig`)."""

    weight_format: Tuple[int, int] = (8, 7)  # (word length, default fraclen)
    input_format: Tuple[int, int] = (8, 6)
    rescale_forward: bool = True  # linear layers
    rescale_forward_conv: bool = False
    rescale_type: str = "constant"  # or 'stddev'
    format_type: str = "per_layer"  # or 'per_channel'
    format_from_metric: bool = False
    format_grid_search: bool = False
    metric: str = "std"  # 'std' | 'mae' | 'rms'
    momentum_for_metric: float = 0.1
    no_clipping: bool = False
    input_fraclen_sharing: bool = False
    quant_bias: bool = False
    int_infer: bool = False
    int_op_only: bool = False
    integize: bool = False
    floating_model: bool = False  # clip-only float baseline
    floating_wo_clip: bool = False  # plain FP32 baseline
    normalize: bool = False  # ImageNet mean/std normalization (signed head input)
    quant_avgpool: bool = False
    quant_maxpool: bool = False
    pool_fusing: bool = False
    qat_boundary: str = ""
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5
    train_conv_bf16: bool = False

    @property
    def floating(self) -> bool:
        return self.floating_model

    def replace(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)
