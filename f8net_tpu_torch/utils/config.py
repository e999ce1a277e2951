"""Experiment configuration (copy of `f8net_tpu/utils/config.py`).

The port keeps the reference's flag vocabulary unchanged so that a config
that drives the JAX package drives the port too.  `QuantConfig`: the
integer engine reads `normalize` and `quant_avgpool`, the graphs
`pool_fusing`; the other fields steer the QAT forward (nn/quant_layers.py)
and the bake (quant/plan.py).  `TrainConfig`: the optimizer, the schedule
and the trainer's phases (train/).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer-level knobs (field for field the JAX `TrainConfig`)."""

    num_epochs: int = 150
    batch_size: int = 2048
    lr: float = 0.1
    lr_scheduler: str = "cos_annealing_iter"
    warmup_epochs: int = 5
    momentum: float = 0.9
    weight_decay: float = 4e-5
    nesterov: bool = True
    weight_decay_scheme: str = "all"
    multistep_lr_milestones: Tuple[int, ...] = (30, 60, 90)
    multistep_lr_gamma: float = 0.1
    exp_decaying_lr_gamma: float = 0.98
    exp_decaying_period: int = 1
    finetune_iters: Optional[int] = None
    bn_calib_before_test: bool = False
    bn_calib_batch_num: int = -1
    random_seed: int = 1995
    num_classes: int = 1000
    image_size: int = 224
    topk: Tuple[int, ...] = (1, 5)
    test_only: bool = False
    # per-iteration top-k error printing (fix_train.py:714-715)
    print_each_iter: bool = False

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
