"""The reference's LR schedules as pure step->multiplier functions (copy of
`f8net_tpu/train/schedules.py`).

Parity with fix_train.py:418-516: constant, multistep, multistep_iter,
exp_decaying, exp_decaying_iter, linear_decaying, cos_annealing,
cos_annealing_iter.  The *_iter variants operate per iteration and include
the linear warmup from lr*256/batch_size over warmup_epochs; the epoch
variants operate per epoch.  The multiplier scales the base lr (which itself
obeys the linear-scaling rule lr *= batch_size/256 for batch > 256, applied
by the config loader like the reference's myutils/config.py:166-172).
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Callable


def lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """Returns mult(step) for iter schedules / mult(epoch) for epoch ones;
    callers of epoch schedules pass epoch*steps_per_epoch-aligned steps."""
    name = cfg.lr_scheduler
    num_epochs = cfg.num_epochs

    if name == "constant":
        return lambda step: 1.0

    if name == "multistep":
        return lambda step: cfg.multistep_lr_gamma ** bisect_right(
            list(cfg.multistep_lr_milestones), step // steps_per_epoch
        )

    if name == "exp_decaying":

        def f(step):
            epoch = step // steps_per_epoch
            return cfg.exp_decaying_lr_gamma ** (epoch // cfg.exp_decaying_period)

        return f

    if name == "linear_decaying":
        return lambda step: 1.0 - (
            step // steps_per_epoch - cfg.warmup_epochs
        ) / num_epochs

    if name == "cos_annealing":
        span = num_epochs - cfg.warmup_epochs

        def f(step):
            epoch = step // steps_per_epoch
            return (1.0 + math.cos((epoch - cfg.warmup_epochs) * math.pi / span)) / 2

        return f

    # per-iteration schedules with warmup
    num_iters = num_epochs * steps_per_epoch
    warmup_iters = cfg.warmup_epochs * steps_per_epoch
    bs_ratio = 256.0 / cfg.batch_size

    def warmup(i):
        if warmup_iters <= 0:
            return None
        if i < warmup_iters:
            return (1.0 - bs_ratio) / warmup_iters * i + bs_ratio
        return None

    if name == "multistep_iter":

        def f(i):
            wm = warmup(i)
            if wm is not None:
                return wm
            return cfg.multistep_lr_gamma ** bisect_right(
                list(cfg.multistep_lr_milestones), i // steps_per_epoch
            )

        return f

    if name == "exp_decaying_iter":

        def f(i):
            wm = warmup(i)
            if wm is not None:
                return wm
            x = (i - warmup_iters) / max(num_iters - warmup_iters, 1)
            return math.exp(-x * 8)

        return f

    if name == "cos_annealing_iter":

        def f(i):
            wm = warmup(i)
            if wm is not None:
                return wm
            x = (i - warmup_iters) / max(num_iters - warmup_iters, 1)
            return (1.0 + math.cos(x * math.pi)) / 2

        return f

    raise NotImplementedError(f"lr scheduler {name!r}")
