"""Monte-Carlo fixed-point quantization error analysis (the port of
`f8net_tpu/tools/error_analysis.py`).

Re-derivation of the semi-empirical metric->fraclen rule behind
metric2fraclen's coefficient table (ops/fxp.py SIGNED_COEFF/UNSIGNED_COEFF):
for sigma over a log grid, quantize N (rectified-)Gaussian samples at every
fraclen, record the relative RMS error, and take the argmin fraclen.  The
optimal fraclen drops by one each time sigma crosses a threshold; fitting
threshold_stat(fl) ~ coeff / 2^fl at those transitions yields the
coefficients, for the 'std', 'mae' and 'rms' metrics of signed Gaussians
and unsigned rectified ones.

The samples are numpy's draws, as in the reference; the quantization is
the port's `ops.fxp.fix_quant` on `device` (exact float32 arithmetic: a
power-of-two scale, round-half-to-even, a clamp), and the statistics are
numpy's again, so every table and fit equals the reference's bit for bit.

Usage:
    python -m f8net_tpu_torch.tools.error_analysis [--n N] [--out results.txt] [--device cpu]
    python -m f8net_tpu_torch.tools.error_analysis --single [--signed]  # one sweep
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.fxp import SIGNED_COEFF, UNSIGNED_COEFF, fix_quant
from ..utils.device import resolve_device


def quant_rel_error(sigma: float, fl: int, n: int, signed: bool, seed: int = 0,
                    device="cuda") -> float:
    rng = np.random.RandomState(seed)
    x = rng.randn(n).astype(np.float32) * sigma
    if not signed:
        x = np.maximum(x, 0.0)
    q, _ = fix_quant(torch.from_numpy(x).to(resolve_device(device)), 8, float(fl), 0, signed)
    err = np.sqrt(np.mean((q.cpu().numpy() - x) ** 2))
    denom = np.sqrt(np.mean(x**2)) + 1e-12
    return float(err / denom)


def sweep(n: int = 10000, signed: bool = True, sigmas: Optional[np.ndarray] = None,
          seed: int = 0, device="cuda"):
    """Returns (sigmas, opt_fl[], err_table[n_sigma, n_fl], stats dict).

    stats['mae'] / stats['rms'] are the per-sigma sample statistics
    mean|x| and sqrt(mean x^2) of the same draws the errors are measured on
    -- the x-axis variables of the mae/rms fits."""
    if sigmas is None:
        sigmas = np.logspace(-3, 3, 121)
    fls = list(range(8 - int(signed) + 1))
    table = np.empty((len(sigmas), len(fls)))
    mae = np.empty(len(sigmas))
    rms = np.empty(len(sigmas))
    rng = np.random.RandomState(seed)
    base = rng.randn(n).astype(np.float32)
    for i, s in enumerate(sigmas):
        x = base * s
        if not signed:
            x = np.maximum(x, 0.0)
        mae[i] = np.mean(np.abs(x))
        rms[i] = np.sqrt(np.mean(x**2))
        for j, fl in enumerate(fls):
            table[i, j] = quant_rel_error(float(s), fl, n, signed, seed, device)
    opt = np.argmin(table, axis=1).astype(float)
    # the tiny-sigma underflow region can alias to fl=0; the reference
    # replaces those leading zeros by the max fl before fitting
    max_fl = float(max(fls))
    where_max = np.nonzero(opt == max_fl)[0]
    if len(where_max):
        head = slice(0, where_max[-1])
        opt[head][opt[head] == 0] = max_fl
    return sigmas, opt, table, {"std": sigmas, "mae": mae, "rms": rms}


def fit_threshold_coeff(sigmas: np.ndarray, opt_fl: np.ndarray,
                        stat: Optional[np.ndarray] = None) -> float:
    """coeff = 2^mean(fl + log2(stat at the fl->fl-1 transition)): the
    threshold is the first sigma where opt_fl == fl - 1."""
    if stat is None:
        stat = sigmas
    terms = []
    for fl in range(1, int(opt_fl.max()) + 1):
        drop = np.nonzero(opt_fl == fl - 1)[0]
        if len(drop) == 0:
            continue
        th = stat[drop[0]]
        if th > 0:
            terms.append(fl + np.log2(th))
    return float(2.0 ** np.mean(terms)) if terms else float("nan")


def fit_all_metrics(n: int = 10000, seed: int = 0, device="cuda") -> Dict[bool, Dict[str, float]]:
    """The six coefficients {signed: {std, mae, rms}} of metric2fraclen."""
    out: Dict[bool, Dict[str, float]] = {}
    for signed in (True, False):
        sigmas, opt, _, stats = sweep(n, signed, seed=seed, device=device)
        out[signed] = {m: fit_threshold_coeff(sigmas, opt, stats[m]) for m in ("std", "mae", "rms")}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--single", action="store_true", help="one sweep dump only")
    ap.add_argument("--signed", action="store_true", default=False)
    ap.add_argument("--unsigned", dest="signed", action="store_false")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="where fix_quant runs (cuda or cpu)")
    args = ap.parse_args(argv)

    if args.single:
        sigmas, opt, table, _ = sweep(args.n, args.signed, device=args.device)
        coeff = fit_threshold_coeff(sigmas, opt)
        lines = [f"# 8bit signed={args.signed} fitted threshold coeff ~ {coeff:.1f}"]
        lines += [f"{s:.6g}\t{int(o)}\t" + "\t".join(f"{e:.4g}" for e in row)
                  for s, o, row in zip(sigmas, opt, table)]
    else:
        fits = fit_all_metrics(args.n, device=args.device)
        hard = {True: SIGNED_COEFF, False: UNSIGNED_COEFF}
        lines = ["# metric2fraclen coefficient fits (8-bit), coeff = 2^mean(fl + log2(th))",
                 "# signed\tmetric\tfitted\ttable"]
        for signed in (True, False):
            for m in ("std", "mae", "rms"):
                lines.append(f"{signed}\t{m}\t{fits[signed][m]:.1f}\t{hard[signed][m]:.0f}")
    text = "\n".join(lines)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)


if __name__ == "__main__":
    main()
