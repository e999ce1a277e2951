"""Per-layer fraclen profile visualization (the port of
`f8net_tpu/tools/fraclen_visual.py`).

Parses the per-layer quantization dumps (`utils.reporting.fraclen_report`'s,
or the reference's training logs -- the same vocabulary) and renders the
weight/input fraclen profile as a text table or a bar chart (matplotlib,
optional).

Usage:
    python -m f8net_tpu_torch.tools.fraclen_visual <report.txt> [--png out.png]
"""

from __future__ import annotations

import argparse

from ..utils.reporting import parse_fraclen_report


def profile_table(parsed) -> str:
    rows = ["layer\tinput_fl\tweight_fl"]
    for name, d in parsed.items():
        in_fl = d.get("input_fraclen", [])
        w_fl = d.get("weight_fraclen", [])
        rows.append(f"{name}\t{in_fl[0] if in_fl else '-'}\t{w_fl[0] if w_fl else '-'}")
    return "\n".join(rows)


def plot_profile(parsed, png_path: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    names = list(parsed.keys())
    in_fl = [d.get("input_fraclen", [np.nan])[0] for d in parsed.values()]
    w_fl = [d.get("weight_fraclen", [np.nan])[0] for d in parsed.values()]
    x = np.arange(len(names))
    fig, ax = plt.subplots(figsize=(max(8, len(names) * 0.35), 4))
    ax.bar(x - 0.2, in_fl, width=0.4, label="input fraclen")
    ax.bar(x + 0.2, w_fl, width=0.4, label="weight fraclen")
    ax.set_xticks(x)
    ax.set_xticklabels(names, rotation=90, fontsize=6)
    ax.set_ylabel("fractional length (bits)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(png_path, dpi=150)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("report")
    ap.add_argument("--png", default=None)
    args = ap.parse_args(argv)
    with open(args.report) as f:
        parsed = parse_fraclen_report(f.read())
    print(profile_table(parsed))
    if args.png:
        plot_profile(parsed, args.png)
        print(f"wrote {args.png}")


if __name__ == "__main__":
    main()
