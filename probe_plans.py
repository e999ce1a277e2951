#!/usr/bin/env python3
"""Time K5 and K7 under every plan their planners consider, on one card.

    python3 probe_plans.py [--batch 8] [--seed 0]

For each distinct K5 call of MobileNetV2 (224 px) in the form each engine
rung gives it (strict: int32 carry and output; int8-boundary: 1-byte carry,
requant8 output; bf16-boundary: bf16 output, no carry), and each K7 call
shape of ResNet-50, at the given batch, on random inputs made from the
seed: device ms per call (torch.profiler's kernel time over 10 launches) of
the kernel under each candidate plan -- K5: band heights x Ce splits whose
layout fits; K7: both tile widths, unsplit and split 2-8 ways -- each
output checked bitwise against the planner's own plan's; K7 also beside K1
and torch._int_mm at the same shape.  Prints one line per (shape, plan),
the planner's choice marked `*`, and the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import chip_smoke
from f8net_tpu_torch.ops import gemm as gemm_ops
from f8net_tpu_torch.ops import gemm_v2 as gemm_v2_ops
from f8net_tpu_torch.ops import ir_block as ir_ops

# (h, w, cin, ce, cout, residual) of MobileNetV2's K5 calls at 224 px, and
# how many times each runs per forward
K5_SHAPES = [
    ((56, 56, 24, 144, 24, True), 1), ((28, 28, 32, 192, 32, True), 2),
    ((14, 14, 64, 384, 64, True), 3), ((14, 14, 64, 384, 96, False), 1),
    ((14, 14, 96, 576, 96, True), 2), ((7, 7, 160, 960, 160, True), 2),
    ((7, 7, 160, 960, 320, False), 1),
]
# (M / batch, K, N, epilogue) of ResNet-50's K7 calls at 224 px
K7_SHAPES = [
    (3136, 64, 64, "requant8"), (3136, 64, 256, "int32"), (3136, 256, 64, "requant8"),
    (3136, 256, 128, "requant8"), (784, 128, 512, "int32"), (784, 512, 128, "requant8"),
    (784, 512, 256, "requant8"), (196, 256, 1024, "int32"), (196, 1024, 256, "requant8"),
    (196, 1024, 512, "requant8"), (49, 512, 2048, "int32"), (49, 2048, 512, "requant8"),
]

# (M / batch, K, N, epilogue) of MobileNetV2's pointwise convs on K1 at 224
# px with K % 16 == 0 (its 24 -> 144 expand has K = 24; the classifier is
# not a conv)
MBV2_K1_SHAPES = [
    (12544, 32, 16, "requant8"), (12544, 16, 96, "requant8"), (3136, 96, 24, "int32"),
    (784, 144, 32, "int32"), (784, 32, 192, "requant8"), (196, 192, 64, "int32"),
    (196, 96, 576, "requant8"), (49, 576, 160, "int32"), (49, 320, 1280, "int32"),
]


# the K5 form of a residual and of another block's call in each rung:
# (carry dtype or None, output)
K5_FORMS = {
    "strict": ((torch.int32, "int32"), (None, "requant8")),
    "int8": ((torch.int8, "requant8"), (None, "requant8")),
    "bf16": ((None, "bf16"), (None, "bf16")),
}


def k5_plans(n, h, w, cin, ce, cout, k, carry_bytes):
    units = -(-ce // 32)
    for th in sorted({1, 2, 3, 4, 6, 8, -(-h // 2), h}):
        if th > h:
            continue
        for s in range(1, min(8, units) + 1):
            su = -(-units // s)
            if -(-units // su) != s:
                continue
            plan = ir_ops._layout(h, w, cin, ce, cout, k, th, s, 32 * su, carry_bytes)
            if plan.total <= ir_ops.SMEM_LIMIT:
                yield plan


def k7_plans(m, k, n, sms):
    n_pad = -(-n // 64) * 64
    ksteps = -(-k // 64)
    mtiles = -(-m // 128)
    for bn in (64, 128):
        if n_pad % bn:
            continue
        tiles = mtiles * n_pad // bn
        yield gemm_v2_ops.GemmPlan(bn, n_pad, ksteps, mtiles, n_pad // bn, 1, min(tiles, sms))
        for s in (2, 4, 8):
            if ksteps >= s and tiles * s <= 2 * sms:
                yield gemm_v2_ops.GemmPlan(bn, n_pad, ksteps, mtiles, n_pad // bn, s, tiles * s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_plans: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = chip_smoke.smi("name,power.limit")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.RandomState(args.seed)
    n = args.batch

    def ints(shape, lo, hi, dtype=np.int8):
        return torch.from_numpy(rng.randint(lo, hi, shape).astype(dtype)).to(dev)

    print(f"K5 plans, batch {n} ({card}): rung | h x w | cin | ce | cout | carry | out | calls "
          f"| band rows | bands | splits x channels | blocks | smem | ms", flush=True)
    for rung, forms in K5_FORMS.items():
        for (h, w, cin, ce, cout, residual), calls in K5_SHAPES:
            cdt, out = forms[0] if residual else forms[1]
            x = ints((n, h, w, cin), -128, 128)
            w1 = gemm_v2_ops.pack_gemm_weight(ints((cin, ce), -40, 41))
            w2 = gemm_v2_ops.pack_gemm_weight(ints((ce, cout), -40, 41))
            wd = ints((3, 3, ce), -127, 128)
            b1, bd, b2 = (ints((c,), -(1 << 14), 1 << 14, np.int32) for c in (ce, ce, cout))
            c = None
            if cdt == torch.int32:
                c = ints((n, h, w, cout), -(1 << 20), 1 << 20, np.int32)
            elif cdt == torch.int8:
                c = ints((n, h, w, cout), -128, 128)
            kw = dict(net1=8, net2=13, out=out, net_out=9, out_fl=14,
                      shift_res=1 if c is not None else 0,
                      carry_add_offset=128 if cdt == torch.int8 else 0)
            cb, ob = ir_ops.call_bytes(c, out)
            chosen = ir_ops.plan_ir(n, h, w, cin, ce, cout, 3, sms, cb, ob)
            want = ir_ops.fused_ir_block(x, w1, b1, wd, bd, w2, b2, c, **kw)
            for plan in k5_plans(n, h, w, cin, ce, cout, 3, cb):
                def run(plan=plan):
                    return ir_ops.fused_ir_block(x, w1, b1, wd, bd, w2, b2, c, plan=plan, **kw)

                if not torch.equal(run(), want):
                    raise AssertionError(f"K5 {rung} {h}x{w} x {ce}: plan {plan} differs")
                ms = chip_smoke.device_ms(run)[0]
                mark = "*" if plan == chosen else " "
                cname = "none" if cdt is None else str(cdt).split(".")[-1]
                print(f"{mark} K5 | {rung} | {h}x{w} | {cin} | {ce} | {cout} | {cname} | {out} "
                      f"| {calls} | {plan.th} | {plan.bands} | {plan.splits} x {plan.cs} | "
                      f"{n * plan.bands * plan.splits} | {plan.total} | {ms:.4f}", flush=True)

    print(f"K7 plans, batch {n} ({card}): M | K | N | epilogue | tile | split | blocks | ms "
          f"| K1 ms | _int_mm ms", flush=True)
    for mb, k, nn, epi in K7_SHAPES:
        m = mb * n
        x = ints((m, k), -128, 128)
        wm = ints((k, nn), -127, 128)
        wp = gemm_v2_ops.pack_gemm_weight(wm)
        b = ints((nn,), -(1 << 16), 1 << 16, np.int32)
        kw = dict(epilogue=epi, net=9, out_signed=False) if epi == "requant8" else {}
        chosen = gemm_v2_ops.plan_gemm(m, k, nn, sms)
        want = gemm_ops.int8_gemm(x, wm, b, **kw)
        k1 = chip_smoke.device_ms(lambda: gemm_ops.int8_gemm(x, wm, b, **kw))[0]
        lib = chip_smoke.device_ms(lambda: torch._int_mm(x, wm))[0] if m > 16 else float("nan")
        for plan in k7_plans(m, k, nn, sms):
            def run(plan=plan):
                return gemm_v2_ops.int8_gemm_v2(x, wp, b, plan=plan, **kw)

            if not torch.equal(run(), want):
                raise AssertionError(f"K7 {m}x{k}x{nn}: plan {plan} differs from K1")
            ms = chip_smoke.device_ms(run)[0]
            mark = "*" if plan == chosen else " "
            print(f"{mark} K7 | {m} | {k} | {nn} | {epi} | 128x{plan.bn} | {plan.splits} | "
                  f"{plan.grid} | {ms:.4f} | {k1:.4f} | {lib:.4f}", flush=True)
    # MobileNetV2's pointwise K1 calls whose GEMM lies in K7's domain: what a
    # route by shape and domain alone would send to K7
    print(f"MobileNetV2 K1 calls in K7's domain, batch {n} ({card}): M | K | N | epilogue | "
          f"K7 ms | K1 ms", flush=True)
    for mb, k, nn, epi in MBV2_K1_SHAPES:
        m = mb * n
        x = ints((m, k), -128, 128)
        wm = ints((k, nn), -127, 128)
        b = ints((nn,), -(1 << 16), 1 << 16, np.int32)
        kw = dict(epilogue=epi, net=9, out_signed=False) if epi == "requant8" else {}
        wp = gemm_v2_ops.pack_gemm_weight(wm)
        if not torch.equal(gemm_v2_ops.int8_gemm_v2(x, wp, b, **kw), gemm_ops.int8_gemm(x, wm, b, **kw)):
            raise AssertionError(f"K7 {m}x{k}x{nn} differs from K1")
        k7 = chip_smoke.device_ms(lambda: gemm_v2_ops.int8_gemm_v2(x, wp, b, **kw))[0]
        k1 = chip_smoke.device_ms(lambda: gemm_ops.int8_gemm(x, wm, b, **kw))[0]
        print(f"  K1->K7 | {m} | {k} | {nn} | {epi} | {k7:.4f} | {k1:.4f}", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
