#!/usr/bin/env python3
"""Time K1, K4, K5, K6 and K7 under every plan their planners consider, on
one card.

    python3 probe_plans.py [--batch 8] [--seed 0] [--only k1k4,k4parts,k5,k6,k6parts,k7,mbv1]

For each distinct K5 call of MobileNetV2 (224 px) in the form each engine
rung gives it (strict: int32 carry and output; int8-boundary: 1-byte carry,
requant8 output; bf16-boundary: bf16 output, no carry), and each K7 call
shape of ResNet-50, at the given batch, on random inputs made from the
seed: device ms per call (torch.profiler's kernel time over 10 launches) of
the kernel under each candidate plan -- K5: band heights x Ce splits whose
layout fits; K7: both tile widths, unsplit and split 2-8 ways -- each
output checked bitwise against the planner's own plan's; K7 also beside K1
and torch._int_mm at the same shape.  K1 at each K1 call of ResNet-18,
MobileNetV2 and ResNet-50 (the three classifiers, MobileNetV2's three narrow
1x1 convs) and K4 at MobileNetV2's five depthwise calls, each at batch 8
and 64 whatever --batch says, under every plan ops.gemm.k1_candidates /
ops.dw.dw_candidates list, each output checked bitwise against the
planner's plan's; a summary line per call gives the pick's cost over the
best probed plan, and one per kernel and batch the sum over the calls.
Then K4 at MobileNetV2's five calls at batch 8 under plan_dw's plans with
parts of csrc/dw_conv.cu cut out -- the epilogue's arithmetic, the
multiply-adds (and with them the epilogue, whose inputs become constants),
the halo copies -- each variant built with nvcc into f8net_tpu_torch/_build/:
where the kernel's time goes.  K4 and K7 at MobileNetV1's depthwise and
pointwise calls (224 px, batch 8 and 64; 13 of each, 9 distinct shapes of
each, a shape's time counted once per call in the sums) under every plan
their planners weigh.  K6 at ResNet-18's and ResNet-50's stride-1 3x3 convs on
the flat raster (224 px, batch 8 and 64) in the forms chip_smoke.py's flat
phase gives them, under every plan ops.conv_flat.flat_candidates lists (both
tile widths, split 1-8 ways across a cluster),
each output checked bitwise against plan_flat's plan's, with K2 at the same
calls; and K6 at the four shapes, batch 8, with parts of csrc/conv_flat.cu
cut out or changed (a deeper weight ring, no products, no halo copies, no
output stores; each variant built with nvcc) and at k = 1 and 5 on the same
rasters: where a call's time goes.  `--only` runs the named probes alone.
Prints one line per (shape, plan), the planner's choice marked `*`, and the
card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import ctypes
import subprocess

import chip_smoke
from f8net_tpu_torch.ops import _build
from f8net_tpu_torch.ops import conv as conv_ops, conv_flat as flat_ops
from f8net_tpu_torch.ops import dw as dw_ops
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

# (M / batch, K, N, epilogue) of the K1 calls of the three paths at 224 px:
# the classifiers, then MobileNetV2's 1x1 convs off K7
K1_SHAPES = [
    (1, 512, 1000, "int32"), (1, 1280, 1000, "int32"), (1, 2048, 1000, "int32"),
    (12544, 32, 16, "requant8"), (3136, 96, 24, "int32"), (3136, 24, 144, "requant8"),
]
# (h, w, c, k, stride, padding) of MobileNetV2's K4 calls at 224 px
K4_SHAPES = [
    (112, 112, 32, 3, 1, 1), (112, 112, 96, 3, 2, 1), (56, 56, 144, 3, 2, 1),
    (28, 28, 192, 3, 2, 1), (14, 14, 576, 3, 2, 1),
]
K1_K4_BATCHES = (8, 64)
# MobileNetV1 at 224 px: its K4 calls (h, w, c, k, stride, padding) and its
# K7 calls (M / batch, K, N, epilogue), each with its calls per forward
MBV1_K4_CALLS = {
    (112, 112, 32, 3, 1, 1): 1, (112, 112, 64, 3, 2, 1): 1, (56, 56, 128, 3, 1, 1): 1,
    (56, 56, 128, 3, 2, 1): 1, (28, 28, 256, 3, 1, 1): 1, (28, 28, 256, 3, 2, 1): 1,
    (14, 14, 512, 3, 1, 1): 5, (14, 14, 512, 3, 2, 1): 1, (7, 7, 1024, 3, 1, 1): 1,
}
MBV1_K7_CALLS = {
    (12544, 32, 64, "requant8"): 1, (3136, 64, 128, "requant8"): 1,
    (3136, 128, 128, "requant8"): 1, (784, 128, 256, "requant8"): 1,
    (784, 256, 256, "requant8"): 1, (196, 256, 512, "requant8"): 1,
    (196, 512, 512, "requant8"): 5, (49, 512, 1024, "requant8"): 1,
    (49, 1024, 1024, "int32"): 1,
}
# K6 at ResNet's stride-1 3x3 convs on the flat raster (224 px), in the
# forms chip_smoke.py's flat phase gives them: (h, w, c, o, form) and calls
# per forward of its groups -- ResNet-18's 5 BasicBlocks as chains (body.0
# requant8 with the ring masked, body.1 int32 masked), ResNet-50's 13 convs
# (requant8, ring unmasked)
K6_CALLS = {
    (56, 56, 64, 64, "requant8 masked"): 2, (56, 56, 64, 64, "int32 masked"): 2,
    (56, 56, 64, 64, "requant8 open"): 3,
    (28, 28, 128, 128, "requant8 masked"): 1, (28, 28, 128, 128, "int32 masked"): 1,
    (28, 28, 128, 128, "requant8 open"): 3,
    (14, 14, 256, 256, "requant8 masked"): 1, (14, 14, 256, 256, "int32 masked"): 1,
    (14, 14, 256, 256, "requant8 open"): 5,
    (7, 7, 512, 512, "requant8 masked"): 1, (7, 7, 512, 512, "int32 masked"): 1,
    (7, 7, 512, 512, "requant8 open"): 2,
}
K6_FORMS = {
    "requant8 masked": dict(epilogue="requant8", net=9, out_signed=False, mask_pad=True,
                            mask_value=-128),
    "int32 masked": dict(epilogue="int32", mask_pad=True, mask_value=0),
    "requant8 open": dict(epilogue="requant8", net=9, out_signed=False, mask_pad=False),
}
# K6 with parts cut out or changed: (name, [(text in csrc/conv_flat.cu, its replacement)])
K6_PARTS = [
    ("whole", []),
    ("ring of 10 stages", [("constexpr int kFlatStages = 6;", "constexpr int kFlatStages = 10;")]),
    ("2 products in flight", [("constexpr int kFlatInFlight = 1;",
                               "constexpr int kFlatInFlight = 2;")]),
    ("3 products in flight", [("constexpr int kFlatInFlight = 1;",
                               "constexpr int kFlatInFlight = 3;")]),
    ("no products", [("wgmma_s8<BN>(acc, da, db, step > 0 || kk > 0);", "(void)da, (void)db;")]),
    ("no halo copies", [("for (int q = tid; q < a.R * 4; q += kFlatConsumers)",
                         "for (int q = tid; q < 0; q += kFlatConsumers)")]),
    ("no output stores", [("flat_write_rows(s, tr0, 64 * h, m0, n0, sbias, sflags, ep, out, a);",
                           "(void)ep;")]),
]
PROBES = ("k1k4", "k4parts", "k5", "k6", "k6parts", "k7", "mbv1")

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


def probe(label, card, shapes, plans_of, run_of, calls=None):
    """Time every plan of every shape at each of K1_K4_BATCHES: plans_of(b,
    shape) -> (the planner's plan, [plans]); run_of(b, shape) -> (describe,
    run(plan) -> output).  Each output is checked bitwise against the
    planner's plan's.  Logs one line per plan, one per call with the pick's
    cost over the best plan, one per batch with the sum over the calls
    (`calls`: {shape: calls per forward}, 1 where missing)."""
    calls = calls or {}
    for b in K1_K4_BATCHES:
        pick_sum = best_sum = 0.0
        for shape in shapes:
            chosen, plans = plans_of(b, shape)
            text, run = run_of(b, shape)
            want = run(chosen)
            times = {}
            for plan in plans:
                if not torch.equal(run(plan), want):
                    raise AssertionError(f"{label} {text}: plan {plan} differs")
                times[plan] = chip_smoke.device_ms(lambda: run(plan))[0]
                mark = "*" if plan == chosen else " "
                print(f"{mark} {label} | {b} | {text} | {plan} | {times[plan]:.4f}", flush=True)
            best = min(times, key=times.get)
            pick_sum += calls.get(shape, 1) * times[chosen]
            best_sum += calls.get(shape, 1) * times[best]
            print(f"  {label} pick | {b} | {text} | {times[chosen]:.4f} | best {times[best]:.4f} "
                  f"{best} | +{100 * (times[chosen] / times[best] - 1):.1f}%", flush=True)
        print(f"  {label} picks | batch {b}: {pick_sum:.4f} ms over the calls, best plans "
              f"{best_sum:.4f} ms: +{100 * (pick_sum / best_sum - 1):.1f}% ({card})", flush=True)


def k4_probe_fns(ints, sms):
    """(plans_of, run_of) of K4 for probe(): requant8 onto an unsigned grid,
    pad -128, as the engine calls it between convs."""
    def k4_run(b, shape):
        h, w, c, k, st, pad = shape
        x, wt = ints((b, h, w, c), -128, 128), ints((k, k, 1, c), -127, 128)
        bias = ints((c,), -(1 << 14), 1 << 14, np.int32)
        kw = dict(stride=st, padding=pad, pad_value=-128, epilogue="requant8", net=7,
                  out_signed=False)
        return (f"{b}x{h}x{w}x{c} {k}x{k}/s{st}",
                lambda plan: dw_ops.dw_int8(x, wt, bias, plan=plan, **kw))

    def k4_plans(b, shape):
        return (dw_ops.plan_dw(b, *shape, sms), dw_ops.dw_candidates(b, *shape, sms))

    return k4_plans, k4_run


def probe_mbv1(ints, sms, card):
    """K4 and K7 at MobileNetV1's calls under every plan their planners weigh."""
    print(f"K4 plans at MobileNetV1's calls ({card}): batch | x k/stride | plan | ms", flush=True)
    probe("K4 MBv1", card, list(MBV1_K4_CALLS), *k4_probe_fns(ints, sms), calls=MBV1_K4_CALLS)

    def k7_run(b, shape):
        mb, k, n, epi = shape
        x, w = ints((mb * b, k), -128, 128), ints((k, n), -127, 128)
        wp, bias = gemm_v2_ops.pack_gemm_weight(w), ints((n,), -(1 << 16), 1 << 16, np.int32)
        kw = dict(epilogue=epi, net=9, out_signed=False) if epi == "requant8" else dict(relu=True)
        return (f"{mb * b} x {k} x {n} {epi}",
                lambda plan: gemm_v2_ops.int8_gemm_v2(x, wp, bias, plan=plan, **kw))

    def k7_plans_of(b, shape):
        m, k, n = shape[0] * b, shape[1], shape[2]
        return gemm_v2_ops.plan_gemm(m, k, n, sms), list(k7_plans(m, k, n, sms))

    print(f"K7 plans at MobileNetV1's calls ({card}): batch | M x K x N epilogue | plan | ms",
          flush=True)
    probe("K7 MBv1", card, list(MBV1_K7_CALLS), k7_plans_of, k7_run, calls=MBV1_K7_CALLS)


def probe_k6(ints, sms, card):
    """K6 at K6_CALLS under every plan ops.conv_flat.flat_candidates lists,
    each output checked bitwise against plan_flat's plan's; K2 (conv_int8,
    the same packed weights) at the same call for reference."""
    def k6_run(b, shape):
        h, w, c, o, form = shape
        x = ints((b, h, w, c), -128, 128)
        wp = conv_ops.pack_conv_weight(ints((3, 3, c, o), -127, 128))
        bias = ints((o,), -(1 << 16), 1 << 16, np.int32)
        xf, geom = flat_ops.pack_flat(x, 1, -128)
        kw = dict(K6_FORMS[form], geom=geom)
        return (f"{b}x{h}x{w}x{c} -> {o} {form}",
                lambda plan: flat_ops.conv_flat_int8(xf, wp, bias, plan=plan, **kw))

    def k6_plans(b, shape):
        h, w, c, o, _ = shape
        m, w2 = b * (h + 2) * (w + 2), w + 2
        return flat_ops.plan_flat(m, c, o, 3, w2, sms), flat_ops.flat_candidates(c, o, 3, w2)

    print(f"K6 plans ({card}): batch | x -> O form | plan | ms", flush=True)
    probe("K6", card, list(K6_CALLS), k6_plans, k6_run, calls=K6_CALLS)
    print(f"K2 at the same calls ({card}): batch | x -> O form | K2 ms", flush=True)
    for b in K1_K4_BATCHES:
        for h, w, c, o, form in K6_CALLS:
            x = ints((b, h, w, c), -128, 128)
            wp = conv_ops.pack_conv_weight(ints((3, 3, c, o), -127, 128))
            bias = ints((o,), -(1 << 16), 1 << 16, np.int32)
            kw = {k: v for k, v in K6_FORMS[form].items() if not k.startswith("mask")}
            ms = chip_smoke.device_ms(lambda: conv_ops.conv_int8(
                x, wp, bias, padding=1, pad_value=-128, **kw))[0]
            print(f"  K2 | {b} | {b}x{h}x{w}x{c} -> {o} {form} | {ms:.4f}", flush=True)


def probe_k1_k4(rng, dev, sms, card):
    def ints(shape, lo, hi, dtype=np.int8):
        return torch.from_numpy(rng.randint(lo, hi, shape).astype(dtype)).to(dev)

    def k1_run(b, shape):
        mb, k, n, epi = shape
        x, w = ints((mb * b, k), -128, 128), ints((k, n), -127, 128)
        wp, bias = gemm_ops.pack_k1_weight(w), ints((n,), -(1 << 16), 1 << 16, np.int32)
        kw = dict(epilogue=epi, net=9, out_signed=False) if epi == "requant8" else {}
        return (f"{mb * b} x {k} x {n} {epi}",
                lambda plan: gemm_ops.int8_gemm(x, wp, bias, plan=plan, **kw))

    def k1_plans(b, shape):
        m, k, n, esize = shape[0] * b, shape[1], shape[2], 4 if shape[3] == "int32" else 1
        return (gemm_ops.plan_k1(m, k, n, sms, esize),
                gemm_ops.k1_candidates(m, k, n, sms, esize))

    print(f"K1 plans ({card}): batch | M x K x N epilogue | plan | ms", flush=True)
    probe("K1", card, K1_SHAPES, k1_plans, k1_run)
    print(f"K4 plans ({card}): batch | x k/stride | plan | ms", flush=True)
    probe("K4", card, K4_SHAPES, *k4_probe_fns(ints, sms))


# K4 with parts cut out: (name, [(text in csrc/dw_conv.cu, its replacement)])
K4_EPILOGUE = ("epi.byte(acc[0][o], b[0]), epi.byte(acc[1][o], b[1]), epi.byte(acc[2][o], b[2]),\n"
               "                  epi.byte(acc[3][o], b[3])", "acc[0][o], acc[1][o], acc[2][o], acc[3][o]")
K4_MACS = ("for (int ky = 0; ky < KS; ++ky) {", "for (int ky = 0; ky < 0; ++ky) {")
K4_COPIES = ("dw_cp16(dst, src + ", "if (a.n < 0) dw_cp16(dst, src + ")
K4_PARTS = [("whole", []), ("no epilogue arithmetic", [K4_EPILOGUE]),
            ("no multiply-adds", [K4_MACS]), ("no halo copies", [K4_COPIES]),
            ("copies and stores only", [K4_MACS, K4_EPILOGUE])]


def probe_k4_parts(sms, card):
    src = (_build.CSRC / "dw_conv.cu").read_text()
    _build.BUILD_DIR.mkdir(exist_ok=True)
    procs = []
    for i, (_, cuts) in enumerate(K4_PARTS):
        text = src
        for old, new in cuts:
            if old not in text:
                raise AssertionError(f"k4parts: {old!r} is not in csrc/dw_conv.cu")
            text = text.replace(old, new)
        cu = _build.BUILD_DIR / f"dw_parts_{i}.cu"
        cu.write_text(text)
        so = _build.BUILD_DIR / f"dw_parts_{i}.so"
        # each variant's static locals stay its own (GCC would merge them across the libraries)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique",
               "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.DEVNULL), so))
    fns = []
    for proc, so in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"k4parts: nvcc failed for {so.name}")
        lib = ctypes.CDLL(str(so))
        lib.f8_error_string.restype = ctypes.c_char_p
        fn = lib.f8_dw_conv
        fn.argtypes = dw_ops._ARGTYPES
        fns.append((lib, fn))
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    print(f"K4 parts, batch 8 ({card}): call | plan | " + " | ".join(n for n, _ in K4_PARTS)
          + " (device us)", flush=True)
    for h, w, c, k, st, pad in K4_SHAPES:
        x = torch.randint(-128, 128, (8, h, w, c), generator=g, dtype=torch.int8).to(dev)
        wt = torch.randint(-127, 128, (k, k, 1, c), generator=g, dtype=torch.int8).to(dev)
        bias = torch.randint(-(1 << 14), 1 << 14, (c,), generator=g, dtype=torch.int32).to(dev)
        oh, ow = dw_ops.dw_out_hw(h, w, k, st, pad)
        out = torch.empty((8, oh, ow, c), dtype=torch.int8, device=dev)
        plan = dw_ops.plan_dw(8, h, w, c, k, st, pad, sms)
        times = []
        for (name, _), (lib, fn) in zip(K4_PARTS, fns):
            def run(fn=fn, lib=lib, name=name):
                rc = fn(x.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(), 8, h, w, c,
                        oh, ow, k, st, pad, plan.th, plan.tw, plan.cb, plan.rowb, plan.grid, -128,
                        1, 7, 0, 0, torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"k4parts {name}: {lib.f8_error_string(rc).decode()}")
            times.append(chip_smoke.device_ms(run)[0] * 1e3)
        print(f"  K4 parts | 8x{h}x{w}x{c} {k}x{k}/s{st} | {plan} | "
              + " | ".join(f"{t:.2f}" for t in times), flush=True)


def probe_k6_parts(ints, sms, card):
    """K6 at ResNet's four stride-1 3x3 shapes, batch 8, requant8 with the
    ring masked, under plan_flat's plan: with parts of csrc/conv_flat.cu
    cut out or changed (K6_PARTS, each built with nvcc into
    f8net_tpu_torch/_build/), and whole at k = 1, 3 and 5 on the same raster
    (1, 9 and 25 steps per slice): where a call's time goes."""
    src = (_build.CSRC / "conv_flat.cu").read_text()
    _build.BUILD_DIR.mkdir(exist_ok=True)
    procs = []
    for i, (_, cuts) in enumerate(K6_PARTS):
        text = src
        for old, new in cuts:
            if old not in text:
                raise AssertionError(f"k6parts: {old!r} is not in csrc/conv_flat.cu")
            text = text.replace(old, new)
        cu = _build.BUILD_DIR / f"flat_parts_{i}.cu"
        cu.write_text(text)
        so = _build.BUILD_DIR / f"flat_parts_{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique",
               "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.DEVNULL), so))
    fns = []
    for proc, so in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"k6parts: nvcc failed for {so.name}")
        lib = ctypes.CDLL(str(so))
        lib.f8_error_string.restype = ctypes.c_char_p
        fn = lib.f8_conv_flat
        fn.argtypes = flat_ops._ARGTYPES
        fns.append((lib, fn))
    dev = torch.device("cuda")
    print(f"K6 parts, batch 8, requant8, ring masked ({card}): call | plan | "
          + " | ".join(n for n, _ in K6_PARTS) + " | whole at k = 1 | k = 5 (device us)",
          flush=True)
    for h, w, c, o, form in K6_CALLS:
        if form != "requant8 masked":
            continue
        x = ints((8, h, w, c), -128, 128)
        xf, geom = flat_ops.pack_flat(x, 1, -128)
        m, w2 = xf.shape[0], geom[2]
        wp = conv_ops.pack_conv_weight(ints((3, 3, c, o), -127, 128))
        bias = ints((o,), -(1 << 16), 1 << 16, np.int32)
        out = torch.empty((m, o), dtype=torch.int8, device=dev)
        plan = flat_ops.plan_flat(m, c, o, 3, w2, sms)
        times = []
        for (name, _), (lib, fn) in zip(K6_PARTS, fns):
            def run(fn=fn, lib=lib, name=name):
                rc = fn(xf.data_ptr(), wp.data.data_ptr(), bias.data_ptr(), out.data_ptr(), m, c,
                        o, geom[1], w2, 3, 1, 9, 0, 0, 1, -128, plan.bn, plan.splits,
                        torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"k6parts {name}: {lib.f8_error_string(rc).decode()}")
            times.append(chip_smoke.device_ms(run)[0] * 1e3)
        kw = dict(K6_FORMS["requant8 masked"], geom=geom)
        for k in (1, 5):  # packed beforehand: device_ms counts every kernel of the call
            wk = conv_ops.pack_conv_weight(ints((k, k, c, o), -127, 128))
            times.append(chip_smoke.device_ms(
                lambda: flat_ops.conv_flat_int8(xf, wk, bias, kernel=(k, k), **kw))[0] * 1e3)
        print(f"  K6 parts | 8x{h}x{w}x{c} -> {o} | {plan.bn} wide, split {plan.splits} | "
              + " | ".join(f"{t:.2f}" for t in times), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=",".join(PROBES),
                    help="comma-separated probes to run, of " + ", ".join(PROBES))
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(PROBES):
        ap.error(f"--only takes {', '.join(PROBES)}")
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

    if "k1k4" in only:
        probe_k1_k4(rng, dev, sms, card)
    if "k4parts" in only:
        probe_k4_parts(sms, card)
    if "k5" in only:
        probe_k5(n, ints, sms, card)
    if "k6" in only:
        probe_k6(ints, sms, card)
    if "k6parts" in only:
        probe_k6_parts(ints, sms, card)
    if "k7" in only:
        probe_k7(n, ints, sms, card)
    if "mbv1" in only:
        probe_mbv1(ints, sms, card)
    print(card)
    return 0


def probe_k5(n, ints, sms, card):
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


def probe_k7(n, ints, sms, card):
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


if __name__ == "__main__":
    sys.exit(main())
