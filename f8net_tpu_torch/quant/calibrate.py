"""BN calibration (the port of `f8net_tpu/quant/calibrate.py`): reset the
running statistics, then run 'calib'-mode forwards, which average them
cumulatively."""

from __future__ import annotations

import torch


def reset_bn_for_calib(state):
    """Zero the BN running means and counters, the variances to one."""
    out = {}
    for lname, st in state.items():
        d = dict(st)
        if "bn_mean" in d:
            d["bn_mean"] = torch.zeros_like(d["bn_mean"])
            d["bn_var"] = torch.ones_like(d["bn_var"])
            d["bn_count"] = torch.zeros_like(d["bn_count"])
        out[lname] = d
    return out
