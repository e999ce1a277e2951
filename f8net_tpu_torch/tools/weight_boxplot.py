"""BN-folded effective weight distributions per layer (the port of
`f8net_tpu/tools/weight_boxplot.py`).

The distribution of w * gamma / sqrt(var + eps) per layer (with both PACT
scales folded in: `quant.plan.folded_weight_bias`) motivates why folded
weights fit 8-bit fraclen formats.  Per-layer quantiles; optional
matplotlib boxplot.

Usage (programmatic):
    from f8net_tpu_torch.tools.weight_boxplot import folded_weight_stats
    stats = folded_weight_stats(model, params, state)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..nn.spec import ConvBNSpec
from ..quant.plan import folded_weight_bias


@torch.no_grad()
def folded_weight_stats(model, params, state, cfg=None) -> Dict[str, Dict[str, float]]:
    """{conv layer: {min, q25, median, q75, max, std}} of its folded
    weights (the quantiles and the sample std in numpy, float64)."""
    cfg = cfg or model.cfg
    out = {}
    for name in model.graph.names():
        if not isinstance(model.graph[name], ConvBNSpec):
            continue
        w_eff, _ = folded_weight_bias(model.graph, cfg, name, params, state)
        w = w_eff.detach().cpu().numpy().ravel()
        q = np.quantile(w, [0.0, 0.25, 0.5, 0.75, 1.0])
        out[name] = {
            "min": float(q[0]), "q25": float(q[1]), "median": float(q[2]), "q75": float(q[3]),
            "max": float(q[4]), "std": float(np.std(w, ddof=1)),
        }
    return out


def plot_boxes(stats: Dict[str, Dict[str, float]], png_path: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = list(stats.keys())
    fig, ax = plt.subplots(figsize=(max(8, len(names) * 0.35), 4))
    boxes = [{"whislo": s["min"], "q1": s["q25"], "med": s["median"], "q3": s["q75"],
              "whishi": s["max"]} for s in stats.values()]
    ax.bxp(boxes, showfliers=False)
    ax.set_xticklabels(names, rotation=90, fontsize=6)
    ax.set_ylabel("BN-folded effective weight")
    fig.tight_layout()
    fig.savefig(png_path, dpi=150)
    plt.close(fig)
