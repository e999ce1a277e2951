"""Average-pool constants of the reference's FXQAvgPool2d (copy of
`f8net_tpu/nn/quant_layers.py:50-57`)."""

from __future__ import annotations

import math


def avgpool_shift_for(kernel: int) -> int:
    """shiftnum = round(log2(k*k)) of the reference's FXQAvgPool2d."""
    return max(int(round(math.log2(float(kernel * kernel)))), 0)


def avgpool_scale_for(kernel: int) -> float:
    """Pool-fusing residue 2^shift / k^2 folded into the preceding conv."""
    return 2.0 ** avgpool_shift_for(kernel) / float(kernel * kernel)
