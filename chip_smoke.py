#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (sm_90a).

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --dp-cards 4     # the dp phase alone, over NCCL
    python3 chip_smoke.py --mp-cards 4     # the tp, pp, xserve and tpqat phases alone, over NCCL

Drives the port's four main paths -- ResNet-18, MobileNetV2, ResNet-50 and
MobileNetV1 integer inference at 224x224, full width, 1000 classes -- each
in the engine's three boundary rungs (strict, `int8_boundary=True`,
`bf16_boundary=True`), twelve forwards, through the entry points a user
calls (`load_deploy_bundle`, `model_from_topology`, `IntEngine(...)`,
`IntEngine.condition_input`, `IntEngine.__call__`), on random weights made
from the seed, and again with bake-time channel padding
(`IntEngine(..., pad_channels_to=N)`); the port's own QAT forward and bake,
and QAT with the bf16-operand conv (`cfg.train_conv_bf16`); and its training path
(Trainer, sgd_update, checkpoints, the Loader on its native and PIL paths,
the run.py CLI, the parity harness, data parallelism over two processes);
tensor-parallel QAT training on the rank mesh (param_shardings, the TP
train step, the TP-trained model baked and served by TPEngine); the
multi-card inference engines (tensor- and pipeline-parallel); serving
across ranks (ServingEngine(mesh=), CrossHostServingEngine); and the
offline tools:

  build    compile every CUDA kernel from f8net_tpu_torch/csrc, one nvcc per
           source, all at once
  bundle   per path, a synthetic baked model (int8 weights, int32 biases,
           fraclens calibrated on the card), written as a deploy bundle and
           loaded back
  engine   per path and rung, batch 8 through the kernels and through their
           plain PyTorch versions: logits bitwise equal, launches per
           forward as LAUNCHES_PER_FORWARD in every rung (ResNet-18: 19 K2 +
           1 K3 + 1 K1; MobileNetV2: 1 K2 + 5 K4 + 4 K1 + 7 K7 + 12 K5;
           ResNet-50: 1 K3 + 19 K2 + 33 K7 + 1 K1; MobileNetV1: 1 K2 + 13 K4
           + 13 K7 + 1 K1), non-degenerate logits,
           and every 8-bit operand (K5's internal ones and its requant8
           outputs, the int8 rung's packed carries, included) clamped less
           than MAX_CLAMPED and zero less than MAX_ZERO of the time; logged:
           how far logits and block outputs are from the float network's,
           and each relaxed rung's top-1 agreement with and L2 distance to
           the strict rung's logits and the float network's
  kernels  every kernel call of those forwards (K5 in its int32-carry,
           1-byte-carry and bf16-output forms; plus K1's requant8 epilogue
           at a 1x1-conv shape) against its plain version on the same
           inputs; K1 on each K7 call, equal to K7
  bake     ResNet-18 at 224 px, 1000 classes, on the card: Model.init from a
           seeded torch.Generator, BAKE_TRAIN_STEPS train-mode QAT forwards
           at batch 8 (the EMA fraclens settle), the reference's BN
           calibration (BAKE_CALIB_STEPS calib-mode forwards), bake_plan, and
           the strict engine on the baked plan: every kernel call against
           its plain version, logits bitwise equal to the plain path's; the
           same plan through IntEngine(int_only=False) and through the QAT
           eval forward with int_infer, each within BAKE_ATOL of the integer
           logits, with top-1 agreement logged; the train-mode forward's
           wall ms and the baked plan's clamped and zero shares logged, not
           gated (the weights are random and barely trained); then the
           offline tools (f8net_tpu_torch/tools): error_analysis's
           fit_all_metrics with fix_quant on the card equal to the same
           call on the CPU, weight_boxplot's folded_weight_stats of the
           baked ResNet-18 within rtol 1e-6 of the same on CPU copies,
           fraclen_visual's profile_table of its fraclen report (one row
           per layer)
  serve    ResNet-18 (the engine phase's synthetic bundle) behind
           ServingEngine(IntEngine(...), buckets=SERVE_BUCKETS, ring of
           SERVE_RING images, 224x224x3 uint8), strict and bf16 rungs (the
           bf16 rung is the JAX package's serving configuration,
           examples/end_to_end.py:81-92): no synchronising CUDA call in
           IntEngine.__call__ at any bucket.  The traffic: one client
           sending single images, then closed-loop client threads sending
           requests of 1-4 images (a few as int32, which the ring does not
           take: the copy path) and one of SERVE_OVERSIZED images.
           Checked window, once through a server whose engine records every
           device batch with its logits and launches (19 K2 + 1 K3 + 1 K1
           each, counts reset before serving): every served row bitwise
           equal to its recorded batch's row for the same image, the engine
           again on each recorded batch bitwise equal, and in the strict
           rung each request bitwise equal to the engine on its images
           alone.  Pipeline: SERVE_PIPELINED full batches queued before the
           server starts, each forward behind a spin kernel that outlasts
           the host's enqueue of the next batch; when batch k is routed,
           batch k+1 must be enqueued and its forward not yet finished on
           the card (an event behind each forward): routing waits for its
           own batch alone.  Measured windows, through a server on the
           bare IntEngine: a warm-up window, the single-image client (its
           latency), SERVE_ROUNDS rounds of the clients' traffic in one
           window (images/s, client-side p50 and p99 latency, the server's
           stats), then one round under torch.profiler (its device time per
           computed row, bucket padding included; times the measured
           window's rows over its wall: the device-busy share while
           serving); every batch's launches counted
  export   the bake phase's ResNet-18: export_torchscript at 224 px, loaded
           back with torch.jit.load on the CPU, its logits on 2 images
           bitwise equal to the card's strict engine's (CPU wall time
           logged); its F8NB bundle written and read back equal to the plan
           and int params
  pad      (after timing) each path and rung again through
           IntEngine(..., pad_channels_to=N), N in PAD_TO where it pads a
           channel (MobileNetV2 and V1 at 64 in every rung and at 128 in the
           strict one, the ResNets at 128 in every rung: K3 writes 128
           channels), on the same bundles and batch: every
           kernel call against its plain version, the logits bitwise the
           unpadded engine's, the launches (counts set to 0 just before the
           forward) the padded routing's table (IntEngine.launch_table: K7
           takes the GEMMs padding widens out of K1's range); device ms per
           forward at batch 8 and 64 beside the unpadded engine's (`pad |`
           lines)
  train    (after pad) ResNet-18 from the repository's
           fix_quant_train.yml at its full width (1000 classes, 224 px),
           written to a temporary YAML with the synthetic dataset, a
           temporary log directory and one epoch of TRAIN_SYNTHETIC images:
           OVERFIT_STEPS Trainer steps on the CLI's val images (random
           labels), every loss logged, the last below the first; one
           sgd_update of ResNet-18's real params, gradients and momentum
           on the card bitwise equal to the same call on CPU copies; a
           batch-TRAIN_BATCH step timed (wall ms over TRAIN_TIMED_STEPS
           steps, images/s, peak memory, device-busy share from
           torch.profiler, its conv and GEMM FLOPs as autograd ran them
           over their device ms) and the Loader alone on a JPEG ImageFolder
           tree of LOADER_IMAGE-px images, on its native path (which it
           must take: the native library must build) and on its PIL path
           (images/s per epoch, start-up excluded); then run.main as a user
           calls it: one epoch from
           the overfit weights (fp_pretrained_file), whose latest_checkpoint
           and best_model must equal the tensors it held when it saved
           them; a resumed run one epoch longer, which must print "Loaded
           checkpoint ... at epoch 1" and load exactly what was saved; the
           bn_calib_before_test phase; the int_op_only phase from
           fix_quant_test_int_op_only.yml on best_model, launches counted
           (19 K2 + 1 K3 + 1 K1 per val batch), whose engine's input and
           logits on every val batch must equal, bitwise, those of
           chip_smoke's own IntEngine on the same bake and val loader
           (run.datasets, run.make_loader), and its printed top-1 error
           that engine's, whose forward's every kernel call is held
           against its plain version; and parity.evaluate_parity's
           synthetic dry run on the card, integize's logits bitwise equal
           to int_op_only's on every image; each CLI phase's
           wall s logged
  bf16train (after train) cfg.train_conv_bf16: each distinct conv of
           ResNet-18's and MobileNetV2's QAT forward at batch TRAIN_BATCH,
           224 px, through the flagged conv (bfloat16-rounded operands on
           TF32 tensor cores, inside float32_exact as the train step runs
           it) against the float64 conv of the same rounded operands:
           bitwise on small-grid operands; on operands like the
           batch-statistics conv's each output within BF16_CONV_BOUND of its
           sqrt(sum of squared products), with cudnn.benchmark off (the
           Trainer's) and on, and no Winograd or FFT kernel launched
           (torch.profiler); the float32 conv's (TF32 off) and an im2col
           GEMM's on cuBLAS's TF32 tensor cores errors logged beside it;
           CUDA-event ms of the float32 conv, the flagged conv and F.conv2d
           in bf16 (the library yardstick) beside the TF32 bound; then the
           train phase's QAT step with the flag off and on, BF16_ROUNDS
           interleaved rounds of BF16_ROUND_STEPS steps on one set of
           params: wall ms, images/s, peak memory, and per flag one
           profiled step and one profiled forward (the forward's convs over
           the TF32 or float32 peak, the backward's over the float32
           peak); then BF16_TRAIN_STEPS more flagged steps, BF16_CALIB_STEPS
           flagged calib steps, bake_plan, and the strict engine on the
           bake: every kernel call against its plain version, logits bitwise
           the plain path's, 19 K2 + 1 K3 + 1 K1; and run.main with
           `train_conv_bf16: True` in the train phase's YAML for one
           synthetic epoch (it must call the flagged conv and write its
           checkpoint)
  dp       (after bf16train) ResNet-18 from the same config at full width, a
           global batch of DP_BATCH split over DP_WORLD spawned ranks that
           share the card over gloo (parallel.init_dist): one
           floating_wo_clip and one QAT train step on each rank's shard,
           both ranks' params, state and momentum bitwise equal, each held
           against the same step in one process on the global batch (run
           twice: the card's run-to-run spread, logged) -- fraclen EMAs
           equal, loss, BN state, updates and momentum within DP_LIMITS;
           run.main on both ranks for a synthetic epoch, a resumed one and
           int_op_only on the checkpoint: rank 0 alone writes and prints,
           the resume loads the same tensors on both ranks, the params
           saved, both ranks end each epoch with bitwise equal params, and
           int_op_only's reduced result is alike on both, each rank having
           launched K1-K3; run.main at world size 1 in an NCCL group joined
           through init_dist; the phase's wall s.  With --dp-cards N the
           script runs this phase alone (after the build), its N ranks each
           on a card of its own over NCCL, the card init_dist picks
  tpqat    (after dp) __graft_entry__.dryrun_multichip's training half
           and its bake: ResNet-18 from the dp phase's config at full width
           (224 px, 1000 classes), global batch DP_BATCH, on a (data 1,
           model MP_WORLD) mesh of MP_WORLD spawned ranks that share the card
           over gloo, the QAT params out-channel sharded
           (parallel.param_shardings(..., tensor_parallel=True),
           shard_params), the state whole: one floating_wo_clip and one QAT
           step (train.make_train_step(..., mesh=)); every rank's gathered
           params, state and momentum bitwise alike, each step held against
           the same step in one process on the global batch as the dp phase
           holds its ranks (step_gaps, DP_LIMITS: fraclen EMAs equal); then
           TPQAT_TIMED_STEPS more QAT steps timed on every rank, beside the
           one-process step's wall; TPQAT_CALIB_STEPS calib-mode forwards on
           the mesh, bake_plan on the gathered params, IntEngine on the card
           and TPEngine on the mesh: every rank's logits bitwise equal to the
           single engine's on its data row, every kernel call of its forward
           against its plain version, its launches (counts set to 0 just
           before it) its routing's table (IntEngine.launch_table at the
           shard shapes); logged: collectives and bytes per step
           (Mesh.counts), wall ms per step, peak memory.  With --mp-cards N:
           N ranks over NCCL, a card each, on (1, N) and (2, N/2)
  tp, pp   (after tpqat) MP_WORLD spawned ranks that share the card over gloo
           (parallel.init_dist; a pinned host buffer carries each collective):
           engine.TPEngine on a (data 1, model 2) mesh (parallel.make_mesh)
           on all four paths and engine.PPEngine at 2 stages on ResNet-18
           and MobileNetV2 (batch 8 in PP_MICRO microbatches), every rung,
           on the engine phase's bundles and batch: every rank's logits
           bitwise equal to the single-card engine's in the same rung, every
           kernel call of every rank against its plain version, each rank's
           launches (counts set to 0 just before its forward) equal to the
           table its routing at its shard shapes gives
           (IntEngine.launch_table), one all-reduce per row layer and no
           all-gather (tp), the wire's bytes and dtypes per forward logged
           (pp); tp_paired_matmul_int8 and tp_ring_matmul_int8 bitwise equal
           to their one-process composition; an int32 all-reduce across
           INT32_MAX equal to its wrapped sum; the phases' wall s.  With
           --mp-cards N the script runs these phases alone (after the build
           and the bundles), N ranks each on a card of its own over NCCL: TP
           on (1, N) and (2, N/2), PP at N stages (2 x N microbatches), the
           NCCL wrap check, and wall and device ms per forward (strict) of
           MP_TIMED_PATHS at batch 8 and 64 under TP (1, N) and PP (N stages,
           MP_TIMED_MICRO microbatches) beside the single-card engine's
  xserve   (after tp and pp) ResNet-18 (the engine phase's bundle) in the
           strict and bf16 rungs served across MP_WORLD spawned ranks that
           share the card over gloo, buckets SERVE_BUCKETS:
           ServingEngine(mesh=make_mesh(data=2)) over IntEngine replicas,
           ServingEngine(mesh=make_mesh(data=1, model=2)) over TPEngine
           (rank 0 the front end), CrossHostServingEngine on (2, 1), each
           rank with its own clients and images (first one image, which
           must run the smallest bucket in some round, and one request of
           the per-host shard, which must run the largest); per ingesting
           rank XSERVE_CLIENTS closed-loop clients, a checked window and a
           measured one.  Every served row bitwise equal to the single-card
           engine's row for its image; every forward of every rank
           launching its routing's table (19 K2 + 1 K3 + 1 K1 per replica,
           IntEngine.launch_table under TP), every kernel call of each
           rank's first XSERVE_CHECKED forwards equal to its plain version;
           every CrossHost leader ran the same coordination ticks; logged:
           rank 0's mesh collectives and bytes per round, served images/s,
           client p50/p99, coordination ms per tick, and one card's
           ServingEngine on the same traffic.  With --mp-cards N: N ranks
           over NCCL, a card each, ServingEngine on (N, 1) and (2, N/2),
           CrossHost on (N, 1)
  flat     K6, which no engine calls, on the paths' own activations and the
           weights the engine packed for K2: each of ResNet-50's stride-1
           3x3 convs, and ResNet-18's stride-1 BasicBlocks as two-conv
           chains on the flat raster (ring masked); launches counted (set
           to 0 just before the 23 calls, read just after: one K6 launch
           per call, no other kernel); each call against its plain version
           on every row and, unpacked, against K2
  timing   device time (torch.profiler) of each kernel call, of its plain
           version and of one PyTorch call computing the same function where
           there is one (K1 and K7: torch._int_mm; K2, K4 and K6: F.conv2d in
           float32, TF32 off, channels_last, without the epilogue; K3:
           F.conv2d of its 7x7/s2 conv alone, without the pool) at the same
           shape (K7 also beside K1, K6 beside K2); K1 per call with its form and
           plan (ops/gemm.py:plan_k1) beside the replaced design's recorded
           time, K2 per shape with
           its tile and split (ops/conv.py:plan_conv), K4 per call with its
           tile (ops/dw.py:plan_dw) beside its bytes bound and its dp4a
           issue floor (at an assumed rate), K5 per call with its band height and Ce split
           (ops/ir_block.py:plan_ir), K7 per shape with its tile, split and
           grid (ops/gemm_v2.py:plan_gemm) beside K1 and torch._int_mm, K6
           per call with its tile and split
           (ops/conv_flat.py:plan_flat) beside K2 and F.conv2d; per
           path and rung, whole-forward images/s,
           device-busy share, glue ms and device-time breakdown at batch 8
           and 64, beside the bf16 baseline's images/s (engine.baseline,
           cuDNN, fed (x / 256) in bf16 as bench.py does) and each rung's
           ratio to it

The engine hands K1, K2, K3, K5 and K7 the weights it packed at
construction (PackedK1Weight, PackedConvWeight, pack_stem_weight), and the
flat phase hands K2's to K6; the plain versions compute from the same
packed layouts.

The serve, export and train phases' numbers are logged on lines before the
kernel table.  A kernel's `launches` there are those of the twelve forwards
(K6's: of the flat phase); the table adds each kernel's launches while serving
(`serve_launches`), on the tp, pp, xserve and tpqat phases' forwards,
summed over the ranks (`tp_launches`, `pp_launches`, `xserve_launches`,
`tpqat_launches`), on the pad phase's padded forwards (`pad_launches`) and
on the bf16train phase's engine (`bf16train_launches`).

Any failed check raises, and the script exits non-zero without a result.
The last three lines of standard output are the kernel table (JSON), the
card's name and power limit, and {"ok": true, "device": ...}.  It needs a
CUDA device and the repository around it: alone, or without a card, it
fails.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import math
import multiprocessing
import os
import random
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
import yaml
from PIL import Image

from f8net_tpu_torch.engine import IntEngine, ServingEngine, plain_forward, plain_params
from f8net_tpu_torch.engine.int_engine import is_bottleneck
from f8net_tpu_torch.export import (
    export_torchscript, load_deploy_bundle, load_native_bundle, model_from_topology,
    save_deploy_bundle, save_native_bundle,
)
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.nn import quant_layers as ql, runner as nn_runner
from f8net_tpu_torch.nn.pool import avgpool_shift_for
from f8net_tpu_torch.nn.spec import ConvBNSpec
from f8net_tpu_torch.ops import _build, conv as conv_ops, dw as dw_ops, gemm as gemm_ops
from f8net_tpu_torch.ops import conv_flat as flat_ops, gemm_v2 as gemm_v2_ops
from f8net_tpu_torch.ops import ir_block as ir_ops, stem as stem_ops
from f8net_tpu_torch.quant import LayerPlan, QuantPlan, bake_plan, reset_bn_for_calib
from f8net_tpu_torch.utils import QuantConfig, float32_exact

import f8net_tpu_torch.export as export_mod
import f8net_tpu_torch.train as train_mod
from f8net_tpu_torch import data, native as native_mod, parity, run as cli
from f8net_tpu_torch.native import imageops as native_ops
from f8net_tpu_torch.train import (
    SGDState, checkpoint as train_ckpt, load_checkpoint, loop as train_loop, save_checkpoint,
    sgd_update, weight_decay_mask,
)
from f8net_tpu_torch.tools import error_analysis, fraclen_visual, weight_boxplot
from f8net_tpu_torch.utils.flags import from_flags, load_yaml
from f8net_tpu_torch.utils.reporting import fraclen_report, parse_fraclen_report
from f8net_tpu_torch.utils.profiling import H100_PEAK_OPS, model_flops

IMAGE_SIZE = 224
BATCH = 8
TIMED_BATCHES = (8, 64)
WEIGHT_FL = 7
# F8Net's sigma -> fraclen rule, std metric (copy of f8net_tpu/ops/fxp.py:34-35)
SIGNED_STD_COEFF = 40.0
UNSIGNED_STD_COEFF = 70.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak, published
# K4's dp4a issue floor: 32-bit integer multiply-adds issue at 64 per clock
# per SM on sm_90 (CUDA C++ Programming Guide, arithmetic instruction
# throughput).  That table gives no rate for __dp4a: the floor assumes the
# same one, and the K4 table says so
INT_MAD_PER_CLOCK_PER_SM = 64
# K1's and K4's device ms per call at batch 8 in the designs the present ones
# replaced, as recorded (not measured by this run): this script at commit
# 24d3ec5 on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6),
# strict forwards; keyed (kernel, x shape, weight shape, stride)
PREV_MS = {
    ("int8_gemm", (8, 512), (512, 1000), 1): 0.0106,
    ("int8_gemm", (100352, 32), (32, 16), 1): 0.0128,
    ("int8_gemm", (25088, 96), (96, 24), 1): 0.0059,
    ("int8_gemm", (25088, 24), (24, 144), 1): 0.0196,
    ("int8_gemm", (8, 1280), (1280, 1000), 1): 0.0224,
    ("int8_gemm", (8, 2048), (2048, 1000), 1): 0.0366,
    ("dw_int8", (8, 112, 112, 32), (3, 3, 1, 32), 1): 0.0143,
    ("dw_int8", (8, 112, 112, 96), (3, 3, 1, 96), 2): 0.0119,
    ("dw_int8", (8, 56, 56, 144), (3, 3, 1, 144), 2): 0.0069,
    ("dw_int8", (8, 28, 28, 192), (3, 3, 1, 192), 2): 0.0055,
    ("dw_int8", (8, 14, 14, 576), (3, 3, 1, 576), 2): 0.0057,
}
# every 8-bit operand a forward makes must clamp less and be zero less than
# this often, or the synthetic calibration leaves the requant paths idle
MAX_CLAMPED, MAX_ZERO = 0.05, 0.9
# the bake phase: train-mode forwards (the EMA's initial fraclen keeps
# 0.9^30 = 4% of its weight) and calib-mode forwards at batch 8
BAKE_TRAIN_STEPS, BAKE_CALIB_STEPS = 30, 4
# the float-dtype engine and the QAT int_infer forward carry the integers in
# float32: they equal the integer logits while every conv's partial sums
# stay below 2^24; past that a sum rounds at 2^-24 relative, and an 8-bit
# operand downstream may move one step, which the requants scale back down
BAKE_ATOL = 2.0**-20
# the serve phase: ResNet-18 behind ServingEngine with the buckets and ring
# the JAX package's deployment uses; SERVE_CLIENTS closed-loop clients (each
# waits for its answer before it sends the next request) of SERVE_REQUESTS
# requests of 1-4 images, every SERVE_COPY_EVERY-th as int32 (the same
# pixel values in a dtype the ring does not take: the copy path), plus one
# request of SERVE_OVERSIZED images (split across full batches); before
# them one client sends SERVE_TRICKLE single images, one at a time
SERVE_BUCKETS, SERVE_RING, SERVE_WAIT_MS = (8, 16, 64), 256, 2.0
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_COPY_EVERY = 16, 24, 16
SERVE_OVERSIZED, SERVE_TRICKLE = 100, 16
SERVE_TIMEOUT = 120.0
# the measured window: each client sends its requests SERVE_ROUNDS times;
# the pipeline check: SERVE_PIPELINED full batches (they fill the ring),
# each behind a spin kernel of SERVE_SPIN_CYCLES (about 20 ms at 1980 MHz)
SERVE_ROUNDS, SERVE_PIPELINED, SERVE_SPIN_CYCLES = 4, 4, 40_000_000

# the train phase: ResNet-18 from the repository's config (train_yaml says
# what changes), the CLI at batch TRAIN_BATCH, TRAIN_EPOCHS epochs of
# TRAIN_SYNTHETIC synthetic images (its val set is a quarter of that) on
# TRAIN_WORKERS loader threads; OVERFIT_STEPS steps at OVERFIT_LR on the val
# set's images first, then the classifier's bias for one val label lifted by
# BIAS_LIFT (the CLI writes best_model only below a val error of 1);
# TRAIN_TIMED_STEPS timed steps; the Loader alone over LOADER_EPOCHS epochs
# of LOADER_BATCHES batches; the parity dry run at PARITY_BATCH, two
# batches.  TRAIN_OVERRIDES: config fields changed further (none on the
# card; the CPU rehearsal shrinks the model)
REPO = os.path.dirname(os.path.abspath(__file__))
TRAIN_CONFIG = "configs/imagenet/resnet18/conventional/fix_quant_train.yml"
INT_CONFIG = "configs/imagenet/resnet18/conventional/fix_quant_test_int_op_only.yml"
TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_SYNTHETIC, TRAIN_WORKERS = 64, 1, 64, 4
OVERFIT_STEPS, OVERFIT_LR, TRAIN_TIMED_STEPS, PARITY_BATCH = 32, 0.005, 20, 16
LOADER_EPOCHS, LOADER_BATCHES, LOADER_DECODE_THREADS = 2, 16, 2
LOADER_IMAGE = (500, 375)  # (width, height) of the Loader's JPEGs
BIAS_LIFT = 100.0
TRAIN_OVERRIDES: dict = {}
# the dp phase: the train phase's config at a global batch of DP_BATCH over
# DP_WORLD ranks that share the card over gloo, one step of each kind at
# DP_LR.  DP_LIMITS: the gaps (step_gaps) allowed between the ranks' step and
# its reference on the global batch -- for the float step one process in
# float64, which the float32 steps approximate; for the chaotic QAT step one
# process in float32.  Each is about three times the gap measured at 224 px
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6), where one process in
# float32 sat as far from float64 (update_l2 0.0103 against the ranks'
# 0.0102; per tensor, update and momentum 0.108 for both) and one process on
# images one ulp up as far from itself (BN 0.0126, update_l2 0.241 against the
# ranks' 0.0128, 0.239).  The float step's per-tensor limits hold every tensor,
# the small ones too (BN scales and shifts, the classifier's bias), which
# update_l2 over the whole tree would not see
DP_WORLD, DP_BATCH, DP_LR, DP_TIMEOUT = 2, 64, 0.01, 600.0
DP_LIMITS = {"floating_wo_clip": {"loss": 3e-6, "bn": 2e-5, "update_l2": 0.03, "update": 0.3,
                                  "momentum": 0.3},
             "qat": {"loss": 1e-3, "bn": 0.04, "update_l2": 0.75}}
# the tp and pp phases: MP_WORLD ranks sharing the card over gloo (or, with
# --mp-cards N, N ranks over NCCL, a card each); the TP engine on a (data 1,
# model MP_WORLD) mesh on MP_TP_PATHS (with --mp-cards also on (2, N/2)),
# the PP engine at MP_WORLD stages on MP_PP_PATHS, batch 8 in PP_MICRO
# microbatches at 2 stages (2 x stages at more), every rung; with
# --mp-cards, MP_TIMED_PATHS timed at each of TIMED_BATCHES under TP (1, N)
# and PP (N stages, MP_TIMED_MICRO microbatches)
MP_WORLD, PP_MICRO, MP_TIMED_MICRO, MP_TIMEOUT = 2, 4, 8, 900.0
# the tpqat phase: the dp phase's config, global batch and step, the QAT
# params out-channel sharded over a (data 1, model MP_WORLD) mesh of
# MP_WORLD ranks sharing the card over gloo (with --mp-cards N: (1, N) and
# (2, N/2) over NCCL); TPQAT_TIMED_STEPS more QAT steps timed on every rank
# and in one process, TPQAT_CALIB_STEPS calib forwards before the bake
TPQAT_TIMED_STEPS, TPQAT_CALIB_STEPS = 3, 2
MP_TP_PATHS = ("resnet18", "resnet50", "mobilenet_v2", "mobilenet_v1")
MP_PP_PATHS = ("resnet18", "mobilenet_v2")
MP_TIMED_PATHS = ("resnet50", "mobilenet_v2")
# the xserve phase: ResNet-18 (the engine phase's bundle) in the strict and
# bf16 rungs behind ServingEngine(mesh=) over IntEngine replicas at (N, 1)
# and over TPEngine at (1, N) -- (2, N/2) at 4 cards -- and behind
# CrossHostServingEngine at (N, 1), buckets SERVE_BUCKETS; per ingesting rank
# XSERVE_CLIENTS closed-loop clients of XSERVE_REQUESTS requests of 1-4
# images from its region of XSERVE_POOL images, twice (a checked window, then
# a measured one); each rank's first XSERVE_CHECKED forwards have every
# kernel call held against its plain version; CrossHost ticks every
# XSERVE_TICK_MS
XSERVE_POOL, XSERVE_CLIENTS, XSERVE_REQUESTS, XSERVE_CHECKED, XSERVE_TICK_MS = 1024, 8, 6, 2, 2.0
# the bf16train phase (cfg.train_conv_bf16): each distinct conv of
# BF16_PATHS' QAT step at TRAIN_BATCH and IMAGE_SIZE px, flagged on the card
# against a float64 conv of the same bfloat16-rounded operands.  On operands
# like the batch-statistics conv's (fix_scaling * x, raw weights) every
# output must lie within BF16_CONV_BOUND of its sqrt(sum of squared
# products), with the algorithm cuDNN's heuristics pick (the Trainer leaves
# cudnn.benchmark off) and the one its autotuner picks (benchmark on), and
# neither may launch a kernel whose name holds one of BF16_REFUSED: Winograd
# and FFT convs transform the operands before the tensor cores round them to
# TF32, so their products are not exact.  On small-grid operands (x = i / 8,
# 0 <= i < 8; w = j / 4, |j| <= 3; batch BF16_GRID_BATCH) every product and
# partial sum is exact in float32, and the conv must equal the float64 conv
# bitwise.  Logged beside the error: the float32 conv's (TF32 off) and the
# witness's, an im2col GEMM of the same rounded operands on cuBLAS's TF32
# tensor cores (exact products, the tensor cores' accumulation, no conv
# algorithm).  Then the train phase's QAT step with the flag off and on in
# BF16_ROUNDS interleaved rounds of BF16_ROUND_STEPS steps, and a ResNet-18
# trained BF16_TRAIN_STEPS more flagged steps, calibrated over
# BF16_CALIB_STEPS flagged calib steps, baked and run by IntEngine
BF16_PATHS = ("resnet18", "mobilenet_v2")
BF16_CONV_BOUND = 2.0**-14
BF16_REFUSED = ("winograd", "fft")
BF16_GRID_BATCH = 8
BF16_ROUNDS, BF16_ROUND_STEPS, BF16_TRAIN_STEPS, BF16_CALIB_STEPS = 4, 3, 2, 2
# the pad phase: each path's engines again with IntEngine(pad_channels_to=N)
# for N in PAD_TO where N pads some channel (the ResNets have none below 64),
# every rung at the smallest N that pads the path and the strict rung at the
# larger ones; every kernel call against its plain version, logits bitwise
# the unpadded engine's; device ms per forward over PAD_REPS forwards at each
# of TIMED_BATCHES beside the unpadded engine's
PAD_TO, PAD_REPS = (64, 128), 5
# the lines of the CLI's fraclen report (logged as a count)
REPORT_KEYS = ("layer name:", "alpha:", "master layer", "weight format:", "input format:",
               "fix scaling:", "following layer fix scaling:", "input_fraclen:",
               "weight_fraclen:")

CFG = QuantConfig(
    format_from_metric=True, metric="std", quant_bias=True, quant_avgpool=True,
    pool_fusing=True,
)

KERNELS = {
    "int8_gemm": dict(
        fn=gemm_ops.int8_gemm, plain=gemm_ops.int8_gemm_plain,
        source="f8net_tpu_torch/csrc/int8_gemm.cu", replaces="f8net_tpu/ops/pallas_gemm.py:175",
    ),
    "conv_int8": dict(
        fn=conv_ops.conv_int8, plain=conv_ops.conv_int8_plain,
        source="f8net_tpu_torch/csrc/int8_conv.cu", replaces="f8net_tpu/ops/pallas_conv.py:314",
    ),
    "stem_pool": dict(
        fn=stem_ops.stem_pool, plain=stem_ops.stem_pool_plain,
        source="f8net_tpu_torch/csrc/stem_pool.cu", replaces="f8net_tpu/ops/pallas_stem.py:292",
    ),
    "dw_int8": dict(
        fn=dw_ops.dw_int8, plain=dw_ops.dw_int8_plain,
        source="f8net_tpu_torch/csrc/dw_conv.cu", replaces="f8net_tpu/ops/pallas_dw.py:200",
    ),
    "ir_block": dict(
        fn=ir_ops.fused_ir_block, plain=ir_ops.fused_ir_block_plain,
        source="f8net_tpu_torch/csrc/ir_block.cu",
        replaces="f8net_tpu/ops/pallas_ir_block.py:317",
    ),
    "int8_gemm_v2": dict(  # K1's contract, on weights packed for K7
        fn=gemm_v2_ops.int8_gemm_v2, plain=gemm_v2_ops.int8_gemm_v2_plain,
        source="f8net_tpu_torch/csrc/int8_gemm_v2.cu",
        replaces="f8net_tpu/ops/pallas_gemm_v2.py:174",
    ),
    "conv_flat_int8": dict(
        fn=flat_ops.conv_flat_int8, plain=flat_ops.conv_flat_int8_plain,
        source="f8net_tpu_torch/csrc/conv_flat.cu",
        replaces="f8net_tpu/ops/pallas_conv_flat.py:221",
    ),
}
# the engine's product functions, by kernel: IntEngine attribute names
ENGINE_ATTRS = {
    "int8_gemm": "_gemm", "conv_int8": "_convk", "stem_pool": "_stemk",
    "dw_int8": "_dwk", "ir_block": "_irk", "int8_gemm_v2": "_gemm2",
}
# the relaxed rungs, as IntEngine's keywords, and their names in the log
RUNGS = {"int8_boundary": "int8", "bf16_boundary": "bf16"}
# kernel launches per forward of each main path, in every rung (the rungs
# change what crosses a block boundary, not which products run where);
# kernels not named: 0
LAUNCHES_PER_FORWARD = {
    "resnet18": {"conv_int8": 19, "stem_pool": 1, "int8_gemm": 1},
    "mobilenet_v2": {"conv_int8": 1, "dw_int8": 5, "int8_gemm": 4, "int8_gemm_v2": 7,
                     "ir_block": 12},
    "resnet50": {"stem_pool": 1, "conv_int8": 19, "int8_gemm_v2": 33, "int8_gemm": 1},
    "mobilenet_v1": {"conv_int8": 1, "dw_int8": 13, "int8_gemm_v2": 13, "int8_gemm": 1},
}


def log(*parts) -> None:
    print(*parts, flush=True)


# -- synthetic bundle ---------------------------------------------------------


def fraclen_for(sigma: float, signed: bool) -> int:
    """Input fraclen from the input's std: floor(log2(coeff / sigma)),
    clipped to [0, 8 - signed] (f8net_tpu/ops/fxp.py:metric2fraclen)."""
    coeff = SIGNED_STD_COEFF if signed else UNSIGNED_STD_COEFF
    return int(min(max(math.floor(math.log2(coeff / sigma)), 0), 8 - int(signed)))


def _nchw_conv(x, w_hwio, b, spec: ConvBNSpec):
    return F.conv2d(
        x, w_hwio.permute(3, 2, 0, 1), b, stride=spec.stride, padding=spec.padding,
        groups=spec.groups,
    )


def head_input(model, images):
    """The head's input value, NCHW: the wire's round(255 x) at fraclen 8,
    or the normalized image itself."""
    x = images if model.cfg.normalize else torch.round(255.0 * images) / 256.0
    return x.permute(0, 3, 1, 2)


def float_forward(model, w_real, b_real, x):
    """The real-valued network the synthetic integer model approximates,
    in float32 on the input's device; `x` is the head's input value, NCHW.
    ReLU follows the head, every body conv but the last, the ResNet residual
    add, each MobileNetV1 block and the MobileNetV2 tail; MobileNetV2's
    project and add have none.
    Returns ({layer: std of its input}, [each block's output], logits)."""
    g, sig, outs = model.graph, {}, []

    def conv(name, v):
        sig[name] = float(v.std())
        return _nchw_conv(v, w_real[name], b_real[name], g[name])

    def body(meta, v):
        for name in meta.body:
            v = conv(name, v)
            if name != meta.body[-1]:
                v = F.relu(v)
        return v

    a = F.relu(conv("head", x))
    if model.name == "mobilenet_v2":
        for meta in model.blocks:
            v = body(meta, a)
            a = v + a if meta.residual else v
            outs.append(a)
        a = F.relu(conv("tail", a))
    elif model.name == "mobilenet_v1":
        for meta in model.blocks:
            a = F.relu(body(meta, a))
            outs.append(a)
    else:
        a = F.max_pool2d(a, 3, 2, 1)
        for meta in model.blocks:
            v = body(meta, a)
            s = a if meta.shortcut is None else conv(meta.shortcut, a)
            a = F.relu(v + s)
            outs.append(a)
    pooled = a.sum((2, 3)) / 2.0 ** avgpool_shift_for(model.pool_kernel)
    sig["classifier"] = float(pooled.std())
    return sig, outs, pooled @ w_real["classifier"] + b_real["classifier"]


def synthetic_bundle(model, seed: int, images):
    """Random int8 weights with a std matched to each layer's fan-in (He),
    real biases, input fraclens chosen from the std of each layer's input in
    one float pass on the images' device (signed where the layer's input is
    double-side), and int32 biases at each layer's accumulator scale.
    Returns (plan records, numpy params, float logits)."""
    rng = np.random.RandomState(seed)
    w_int, b_real, w_real = {}, {}, {}
    dev = images.device
    # MobileNetV2's projects and a Bottleneck's last conv feed the residual
    # stream with no ReLU of their own: a gain of 1 instead of He's 2 keeps
    # that stream from growing block by block, as the trained network's
    # folded BatchNorm does
    linear_out = {
        m.body[-1] for m in model.blocks
        if model.name == "mobilenet_v2" or is_bottleneck(model.graph, m)
    }
    for name in model.graph.names():
        spec = model.graph[name]
        shape = spec.weight_shape()
        fan_in = int(np.prod(shape[:-1]))
        std = math.sqrt((1.0 if name in linear_out else 2.0) / fan_in) * 2**WEIGHT_FL
        w_int[name] = np.clip(np.round(rng.standard_normal(shape) * std), -127, 127).astype(np.int8)
        b_real[name] = (0.05 * rng.standard_normal(shape[-1])).astype(np.float32)
        w_real[name] = torch.from_numpy(w_int[name].astype(np.float32) / 2**WEIGHT_FL).to(dev)
    normalize = model.cfg.normalize
    sig, _, logits = float_forward(
        model, w_real, {k: torch.from_numpy(v).to(dev) for k, v in b_real.items()},
        head_input(model, images),
    )
    records, arrays = [], {}
    for name in model.graph.names():
        signed = bool(model.graph[name].double_side)
        in_fl = 8 if name == "head" and not normalize else fraclen_for(sig[name], signed)
        b = np.round(b_real[name].astype(np.float64) * 2.0 ** (in_fl + WEIGHT_FL))
        records.append((name, in_fl, WEIGHT_FL, signed))
        arrays[name] = {"w": w_int[name], "b": b.astype(np.int32)}
    return records, arrays, logits


def load_synthetic_model(
    seed: int, image_size: int, num_classes: int, device, images, model_name="resnet18", cfg=CFG
):
    """Build the synthetic bundle of `model_name`, write it, and load it back
    through the serving entry (load_deploy_bundle, model_from_topology)."""
    model = get_model(model_name, cfg, num_classes=num_classes, image_size=image_size)
    records, arrays, float_logits = synthetic_bundle(model, seed, images)
    plan = QuantPlan(tuple(LayerPlan(*r) for r in records))
    params = {k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in arrays.items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = save_deploy_bundle(f"{tmp}/{model_name}_synthetic", model, plan, params)
        topo, plan2, params2 = load_deploy_bundle(path, device=device)
    if plan2 != plan:
        raise AssertionError("bundle round trip changed the plan")
    for name, d in arrays.items():
        for key, arr in d.items():
            if not np.array_equal(params2[name][key].cpu().numpy(), arr):
                raise AssertionError(f"bundle round trip changed {name}/{key}")
    return model_from_topology(topo, image_size=image_size), plan2, params2, float_logits


# -- engine -------------------------------------------------------------------


class Recorder:
    """Wraps an engine's product functions to keep every call's inputs."""

    def __init__(self, engine: IntEngine):
        self.calls = []
        for name, attr in ENGINE_ATTRS.items():
            setattr(engine, attr, self._wrap(name, getattr(engine, attr)))

    def _wrap(self, name, fn):
        def call(*args, **kw):
            self.calls.append((name, args, kw))
            return fn(*args, **kw)

        return call


def clamp_zero_shares(v, signed: bool, packed: bool = True):
    """(share clamped, share zero) of 8-bit values on a signed grid
    (-127..127) or an unsigned one, stored packed (u - 128) or not."""
    if signed:
        clamped, zero = (v.abs() == 127), (v == 0)
    else:
        lo = -128 if packed else 0
        clamped, zero = (v == lo + 255), (v == lo)
    return float(clamped.float().mean()), float(zero.float().mean())


class RequantStats:
    """Wraps an engine's pack_for and conv_int to keep the share of clamped
    and of zero values in every 8-bit operand its forward produces outside
    K5: each pack of an int32 activation and each requant8 conv output."""

    def __init__(self, engine: IntEngine):
        self.rows = []
        plan, pack_for, conv_int = engine.plan, engine.pack_for, engine.conv_int

        def pack(act, name):
            out = pack_for(act, name)
            if act.packed_for is None:
                self._add(plan, out)
            return out

        def conv(name, act, pack_output_for=None, **kw):
            out = conv_int(name, act, pack_output_for, **kw)
            if pack_output_for is not None:
                self._add(plan, out)
            return out

        engine.pack_for, engine.conv_int = pack, conv

    def _add(self, plan, act):
        signed = plan[act.packed_for].input_symmetric
        self.rows.append((act.packed_for, *clamp_zero_shares(act.x, signed)))


def ir_block_stats(eng: IntEngine, calls):
    """The same shares for the two 8-bit operands inside each recorded K5
    call, from its plain steps 1-4 on the recorded inputs: the expand's
    output as the depthwise reads it (unpacked) and the depthwise's output
    packed for the project; and for a requant8 call (a block output packed
    for the next conv: in the int8 rung, the carry of a residual block) its
    output.  Rows are named by the layer that reads them, or for an output
    by the layer that makes it."""
    fused = getattr(eng, "_fused", {})  # MobileNetV2 engines only
    body_of = {id(fused[m.body[0]][0]): m.body for m in eng.model.blocks if m.body[0] in fused}
    rows = []
    for name, args, kw in calls:
        if name != "ir_block":
            continue
        _, dn, pn = body_of[id(args[1])]
        ev, d8 = ir_ops.ir_block_operands_plain(
            *args[:5], **{k: kw[k] for k in ("net1", "dw_in_signed", "net2", "proj_in_signed")}
        )
        rows.append((f"{dn} (in K5)", *clamp_zero_shares(ev, kw["dw_in_signed"], packed=False)))
        rows.append((f"{pn} (in K5)", *clamp_zero_shares(d8, kw["proj_in_signed"])))
        if kw.get("out") == "requant8":
            y8 = ir_ops.fused_ir_block_plain(*args, **kw)
            rows.append((f"{pn} output (K5)", *clamp_zero_shares(y8, kw["out_signed"])))
    return rows


def reset_launches():
    for k in KERNELS.values():
        k["fn"].launches = 0


def launches():
    return {name: k["fn"].launches for name, k in KERNELS.items()}


def expected_launches(path: str):
    return {name: LAUNCHES_PER_FORWARD[path].get(name, 0) for name in KERNELS}


def engine_phase(eng: IntEngine, x):
    """One forward through the kernels, launches counted, and one through
    the plain versions with every product's inputs recorded.  Returns
    (kernel logits, plain logits, launches, recorded calls, clamped and
    zero shares of every 8-bit operand, K5's internal ones included)."""
    ref = IntEngine(eng.model, eng.plan, eng.params, device=eng.device,
                    int8_boundary=eng.int8_boundary, bf16_boundary=eng.bf16_boundary)
    # the same packed weight objects, so that a recorded call names its layer
    for attr in ("_packed", "_stem_w"):
        if hasattr(eng, attr):
            setattr(ref, attr, getattr(eng, attr))
    for name, attr in ENGINE_ATTRS.items():
        setattr(ref, attr, KERNELS[name]["plain"])
    rec, stats = Recorder(ref), RequantStats(ref)
    reset_launches()
    logits = eng(x)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    counts = launches()
    logits_ref = ref(x)
    return logits, logits_ref, counts, rec.calls, stats.rows + ir_block_stats(ref, rec.calls)


def check_logits(logits, logits_ref, batch, num_classes):
    if logits.shape != (batch, num_classes) or logits.dtype != torch.float32:
        raise AssertionError(f"logits {tuple(logits.shape)} {logits.dtype}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    if not torch.equal(logits, logits_ref):
        diff = (logits - logits_ref).abs().max().item()
        raise AssertionError(f"kernel logits differ from the plain path (max {diff})")
    if all(torch.equal(logits[0], logits[i]) for i in range(1, batch)):
        raise AssertionError("every image got the same logits")


# -- kernels and timing ---------------------------------------------------------


PACKED = (conv_ops.PackedConvWeight, gemm_ops.PackedK1Weight)


def nbytes(*ts) -> int:
    """Bytes of the tensors; a packed weight (K1's, K2's, K5's, K7's) counts
    its logical bytes (the function's input, not the kernel's padded
    layout)."""
    return sum(
        math.prod(t.shape) if isinstance(t, PACKED) else t.numel() * t.element_size() for t in ts
    )


STEM_TAPS = 7 * 7 * 3  # the stem's HWIO weights per output channel, packed or not


def work(name, args, kw, out):
    """(bytes, operations) the call must move and do: each input read once,
    the output written once; 2 operations per int8 x int8 multiply-add.
    Both count the function's logical shapes -- x's, the output's and the
    weights' logical ones -- so a bound is the same whatever layout
    (packed, padded) the kernel reads."""
    x, w = args[0], args[1]
    if name == "stem_pool":  # weights HWIO or packed: the function's bytes
        oh, ow, _, _ = stem_ops.stem_out_hw(x.shape[1], x.shape[2])
        nb = nbytes(x, *args[2:], out) + STEM_TAPS * out.shape[3]
        return nb, 2 * x.shape[0] * oh * ow * STEM_TAPS * out.shape[3]
    if name in ("int8_gemm", "int8_gemm_v2"):  # (M, K) x (K, N), N from the output
        macs = x.shape[0] * x.shape[1] * out.shape[1]
    elif name == "conv_flat_int8":  # every row of the raster; a masked ring needs no taps
        rows = x.shape[0]
        if kw["mask_pad"]:
            n, h2, w2 = kw["geom"]
            p = (w.shape[0] - 1) // 2
            rows = n * (h2 - 2 * p) * (w2 - 2 * p)
        macs = rows * math.prod(w.shape)  # HWIO or packed: the logical weights
    elif name in ("conv_int8", "dw_int8"):  # dw weights are (kh, kw, 1, C)
        macs = out.numel() * w.shape[0] * w.shape[1] * w.shape[2]
    elif name == "ir_block":  # per pixel: cin x ce expand, k x k x ce depthwise, ce x cout project
        kh, kwd, ce = args[3].shape
        cin, cout = x.shape[3], out.shape[3]
        macs = out.numel() // cout * (cin * ce + kh * kwd * ce + ce * cout)
    else:
        raise ValueError(f"no work model for {name}")
    return nbytes(*(a for a in args if a is not None), out), 2 * macs


def bound_s(nb, ops):
    """(seconds for the bytes, seconds for the operations) at the card's
    memory rate and its int8 peak."""
    return nb / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over rounds of the CUDA-event time of `reps` back-to-back
    calls, per call: device time plus whatever gaps the host leaves."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def profile(run, complete=lambda ka: sum(e.self_device_time_total for e in ka) > 0,
            tries: int = 6):
    """key_averages of one torch.profiler session (device activity) around
    `run()`, after one warm-up run.  A session whose key_averages are not
    `complete` (by default: it recorded no device time) is made again, up
    to `tries` sessions; then it raises."""
    run()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        if complete(ka):
            return ka
        log("  torch.profiler missed device activity; profiling again")
    raise RuntimeError(f"torch.profiler missed device activity in {tries} sessions")


def device_ms(fn, reps: int = 10):
    """Device time per call: the CUDA kernel time torch.profiler records
    over `reps` calls, divided by reps.  Returns (ms, key_averages)."""

    def run():
        for _ in range(reps):
            fn()

    ka = profile(run)
    return sum(e.self_device_time_total for e in ka) / reps / 1e3, ka


def compare(name, args, kw):
    """Kernel vs plain version on the same inputs; raises unless equal.
    Returns (kernel output, max abs error)."""
    got = KERNELS[name]["fn"](*args, **kw)
    return got, check_plain(name, args, kw, got)


def check_plain(name, args, kw, got):
    """A kernel's output `got` against its plain version on the same inputs;
    raises unless equal.  Returns the max abs error."""
    want = KERNELS[name]["plain"](*args, **kw)
    if got.device.type == "cuda":
        torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    err = diff.max().item()
    if not torch.equal(got, want):
        bad = torch.nonzero(diff)
        raise AssertionError(
            f"{name} {describe(args, kw)}: differs from its plain version at {len(bad)} of "
            f"{diff.numel()} elements, max abs err {err}; first at {bad[0].tolist()}: "
            f"kernel {got[tuple(bad[0])].item()}, plain {want[tuple(bad[0])].item()}"
        )
    return err


def describe(args, kw) -> str:
    shapes = "x".join(str(tuple(a.shape)) for a in args[:2])  # a packed weight: its logical shape
    if len(args) > 5:  # K5: input x w1 x wd x w2, carry (int32 or int8) or not
        shapes = "x".join(str(tuple(args[i].shape)) for i in (0, 1, 3, 5))
        shapes += f" carry {k5_carry(args)}" if k5_carry(args) != "none" else ""
    opts = ",".join(f"{k}={v}" for k, v in sorted(kw.items()))
    return f"{shapes} {opts}"


def k5_carry(args) -> str:
    """A K5 call's carry: "none", "int32" or "int8"."""
    c = args[7] if len(args) > 7 else None
    return "none" if c is None else str(c.dtype).split(".")[-1]


@functools.lru_cache(maxsize=None)
def int_mm_ms(M, K, N, device):
    """torch._int_mm at (M, K) x (K, N), or at the nearest larger M it
    accepts, timed once per shape in a run.  Returns (ms, M used)."""
    b = torch.randint(-127, 128, (K, N), dtype=torch.int8, device=device)
    for m in sorted({M, *range(max(M, 17), max(M, 17) + 64, 8)}):
        a = torch.randint(-127, 128, (m, K), dtype=torch.int8, device=device)
        try:
            torch._int_mm(a, b)
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return device_ms(lambda: torch._int_mm(a, b))[0], m
    raise RuntimeError("torch._int_mm accepted no M")


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def drive(label: str, path: str, eng: IntEngine, images, log_calls: bool = True,
          gate: bool = True):
    """The engine and kernels phases of one forward of `path` on `eng`:
    every kernel call against its plain version, the logits against the
    plain path's, launches against LAUNCHES_PER_FORWARD, the clamp and zero
    gates (logged only, without `gate`).  Returns (logits, launches per forward, [(kernel, args, kwargs,
    output, max abs err)] of every kernel call of the forward)."""
    x = eng.condition_input(images[:BATCH])
    logits, logits_ref, counts, calls, stats = engine_phase(eng, x)
    checked = []
    for name, cargs, kw in calls:
        out, err = compare(name, cargs, kw)
        checked.append((name, cargs, kw, out, err))
        if log_calls or name == "ir_block":
            log(f"{label} kernel {name} {describe(cargs, kw)}: equal to its plain version")
    log(f"{label}: all {len(checked)} kernel calls equal to their plain versions")
    check_logits(logits, logits_ref, x.shape[0], eng.model.num_classes)
    want = expected_launches(path)
    recorded = {name: [c[0] for c in calls].count(name) for name in KERNELS}
    if recorded != want:
        raise AssertionError(f"{label}: kernel calls per forward {recorded}, expected {want}")
    if eng.device.type == "cuda" and counts != want:
        raise AssertionError(f"{label}: launches per forward {counts}, expected {want}")
    log(f"{label} engine: logits bitwise equal to the plain path; launches {counts}")
    for name, clamped, zero in stats:
        log(f"  {label} requant -> {name}: clamped {clamped:.4f} zero {zero:.4f}")
        if gate and (clamped >= MAX_CLAMPED or zero >= MAX_ZERO):
            raise AssertionError(f"{label}: the 8-bit input of {name} is degenerate: clamped "
                                 f"{clamped:.4f} (limit {MAX_CLAMPED}), zero {zero:.4f} "
                                 f"(limit {MAX_ZERO})")
    return logits, counts, checked


def check_path(path: str, seed: int, images, device):
    """The bundle, engine and kernels phases of one main path, strict rung.
    Returns (engine, launches per forward, [(kernel, args, kwargs, output,
    max abs err)] of every kernel call of the forward, logits, the float
    network's logits)."""
    model, plan, params, float_logits = load_synthetic_model(
        seed, IMAGE_SIZE, 1000, device, images[:BATCH], model_name=path
    )
    log(f"{path} bundle: fraclens " + " ".join(f"{p.name}={p.input_fl}" for p in plan.layers))
    eng = IntEngine(model, plan, params, device=device)
    logits, counts, checked = drive(path, path, eng, images)
    float_agreement(path, logits, plan, float_logits)
    block_errors(path, eng, images[:BATCH])
    return eng, counts, checked, logits, float_logits


def check_rung(path: str, rung: str, strict, images):
    """The engine and kernels phases of `path` in a relaxed rung, on the
    strict engine's bundle, and how far its logits are from the strict
    rung's and the float network's.  Returns (engine, launches per forward,
    checked calls) as check_path does."""
    eng0, _, _, strict_logits, float_logits = strict
    eng = IntEngine(eng0.model, eng0.plan, eng0.params, device=eng0.device, **{rung: True})
    label = f"{path} {RUNGS[rung]}"
    logits, counts, checked = drive(label, path, eng, images, log_calls=False)
    rung_agreement(label, logits, eng.plan, strict_logits, float_logits)
    block_errors(label, eng, images[:BATCH])
    return eng, counts, checked


def rung_agreement(label, logits, plan, strict_logits, float_logits) -> None:
    """Logs a relaxed rung's top-1 agreement with, and relative L2 distance
    to, the strict rung's logits and the float network's (both at their
    real scale)."""
    real = logits.double() / 2.0 ** plan["classifier"].out_fl
    for what, ref in (("strict rung", strict_logits.double() / 2.0 ** plan["classifier"].out_fl),
                      ("float network", float_logits.double())):
        agree = (real.argmax(1) == ref.argmax(1)).double().mean().item()
        rel = ((real - ref).norm() / ref.norm()).item()
        log(f"{label} engine: top-1 agreement with the {what} {agree:.3f}; relative L2 "
            f"distance {rel:.4f}")


def real_value(act, plan):
    """An engine activation at its real scale, float64."""
    if act.scaled:  # a bf16 real value
        return act.x.double()
    v = act.x.double()
    if act.packed_for is not None and not plan[act.packed_for].input_symmetric:
        v = v + 128  # stored as u - 128
    return v / 2.0 ** act.fl


def block_errors(path, eng, images) -> None:
    """Logs the relative L2 error of each block's output in the engine
    against the float network run on the engine's own weights and biases:
    where the integer network parts from the float one."""
    model, plan, params = eng.model, eng.plan, eng.params
    w_real = {n: params[n]["w"].float() / 2.0 ** plan[n].weight_fl for n in model.graph.names()}
    b_real = {n: params[n]["b"].float() / 2.0 ** plan[n].out_fl for n in model.graph.names()}
    _, want, _ = float_forward(model, w_real, b_real, head_input(model, images))
    attr = {"mobilenet_v2": "block_mbv2", "mobilenet_v1": "block_mbv1"}.get(model.name, "block")
    method, got = getattr(eng, attr), []

    def hooked(meta, *rest):
        out = method(meta, *rest)
        got.append(real_value(out, plan).permute(0, 3, 1, 2))
        return out

    setattr(eng, attr, hooked)
    try:
        eng(eng.condition_input(images))
    finally:
        delattr(eng, attr)
    errs = [((g - w.double()).norm() / w.double().norm()).item() for g, w in zip(got, want)]
    log(f"{path} engine: relative L2 error of each block's output against the float network: "
        + " ".join(f"{e:.3f}" for e in errs))


def float_agreement(path, logits, plan, float_logits) -> None:
    """Logs how far the integer logits, at their real scale, are from the
    float network's, per image beside the gap between the float network's
    two best classes: where the gap is smaller than the error, the argmax
    of the two may part."""
    real = logits.double() / 2.0 ** plan["classifier"].out_fl
    ref = float_logits.double()
    err = (real - ref).abs().amax(1)
    best = ref.topk(2, 1).values
    gap = best[:, 0] - best[:, 1]
    agree = real.argmax(1) == ref.argmax(1)
    rel = ((real - ref).norm() / ref.norm()).item()
    log(f"{path} engine: top-1 agreement with the float network "
        f"{agree.double().mean().item():.3f}; relative L2 error of the logits {rel:.4f}; "
        f"float logits' std {ref.std().item():.4f}")
    for i in range(len(gap)):
        log(f"  {path} image {i}: float top-1 gap {gap[i].item():.4f}, largest logit error "
            f"{err[i].item():.4f}, top-1 {'agrees' if agree[i] else 'differs'}")


def time_call(name, cargs, kw, out, reps: int, plain_reps: int = 3):
    """(device ms, call ms, plain device ms, bytes, operations) of one
    kernel call.  One profiler session covers `reps` kernel calls and
    `plain_reps` plain ones: the port's kernels are the f8:: entries, the
    plain version everything else.  call ms = CUDA-event time of
    back-to-back wrapper calls, which includes the host's per-call
    overhead."""
    k = KERNELS[name]

    def run():
        for _ in range(reps):
            k["fn"](*cargs, **kw)
        for _ in range(plain_reps):
            k["plain"](*cargs, **kw)

    def split(ka):
        ours = sum(e.self_device_time_total for e in ka if "f8::" in e.key)
        return ours, sum(e.self_device_time_total for e in ka) - ours

    ours, rest = split(profile(run, complete=lambda ka: min(split(ka)) > 0))
    call_ms = time_ms(lambda: k["fn"](*cargs, **kw), reps=2 * reps)
    return (ours / reps / 1e3, call_ms, rest / plain_reps / 1e3) + work(name, cargs, kw, out)


def time_forward(label: str, forward, images, card: str, prepare=None) -> dict:
    """Wall time (CUDA events), device-busy time (profiler) and where the
    device time goes, for one forward at each timed batch; `prepare` makes
    the forward's input from the images (the engine's condition_input).
    Returns {batch: images/s}."""
    ips = {}
    for b in TIMED_BATCHES:
        xb = prepare(images[:b])
        wall = time_ms(lambda: forward(xb), reps=5, rounds=5)
        busy, ka = device_ms(lambda: forward(xb), reps=5)
        ips[b] = 1e3 * b / wall
        ours = sum(e.self_device_time_total for e in ka if "f8::" in e.key) / 5e3
        log(f"{label} forward: batch {b}: {wall:.3f} ms, {ips[b]:.1f} images/s, device "
            f"busy {busy:.4f} ms, idle share {1 - busy / wall:.3f}, port kernels {ours:.4f} ms, "
            f"glue {busy - ours:.4f} ms ({card})")
        for e in sorted(ka, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"  {label} forward batch {b}: {e.self_device_time_total / 5e3:.4f} ms, "
                f"{e.count // 5} launches: {e.key[:90]}")
    return ips


def time_baseline(path: str, eng: IntEngine, images, card: str) -> dict:
    """The bf16 baseline of `path` (engine.baseline: the same topology on
    cuDNN, channels_last) on the engine's own weights, fed (x / 256) of the
    conditioned uint8 input in bf16, as bench.py feeds it.  Returns {batch:
    images/s}."""
    fp = plain_params(eng.model, eng.params)
    ips = time_forward(
        f"{path} bf16 baseline", lambda xb: plain_forward(eng.model, fp, xb), images, card,
        prepare=lambda im: (eng.condition_input(im).to(torch.float32) / 256.0).to(torch.bfloat16),
    )
    out = plain_forward(eng.model, fp, (eng.condition_input(images[:BATCH]).float() / 256).bfloat16())
    if out.shape != (BATCH, 1000):
        raise AssertionError(f"{path} bf16 baseline: logits {tuple(out.shape)}")
    return ips


def layers_by_weight(eng: IntEngine):
    """{id of a layer's weight tensor: layer name}: a recorded call carries
    the engine's own weight tensors (K2's packed ones), which name the layer
    it computes."""
    ids = {id(p["w"]): name for name, p in eng.params.items()}
    ids.update({id(w): name for name, w in eng._packed.items()})
    return ids


def hwio(w):
    """A K2 call's weights as HWIO, as F.conv2d takes them."""
    return conv_ops.unpack_conv_weight(w) if isinstance(w, conv_ops.PackedConvWeight) else w


def k1_args(cargs):
    """A recorded K7 call's inputs as K1 takes them: its packed weights as
    the (K, N) matrix."""
    x, w, b = cargs
    return x, gemm_v2_ops.unpack_gemm_weight(w), b


def k7_against_k1(checked) -> int:
    """K1 on each recorded K7 call's inputs: the two kernels share one
    contract, so their outputs must be equal bit for bit.  Returns the
    number of calls checked."""
    n = 0
    for name, cargs, kw, out, _ in checked:
        if name != "int8_gemm_v2":
            continue
        k1 = gemm_ops.int8_gemm(*k1_args(cargs), **kw)
        if not torch.equal(k1, out):
            raise AssertionError(f"int8_gemm_v2 {describe(cargs, kw)}: differs from int8_gemm")
        n += 1
    return n


def flat_kwargs(kw, geom, mask_pad: bool, mask_value: int):
    """K6's arguments for a recorded stride-1 3x3 K2 call: the call's own
    epilogue on the flat raster of geometry `geom`."""
    return dict(
        geom=geom, kernel=(3, 3), epilogue=kw["epilogue"], net=kw.get("net", 0),
        out_signed=kw.get("out_signed", True), relu=kw.get("relu", False),
        mask_pad=mask_pad, mask_value=mask_value,
    )


def flat_phase(paths):
    """K6 on the paths' own activations, with the weights K2 was handed
    (packed once by the engine), launches counted:
      * ResNet-50's stride-1 3x3 convs, one K6 call each on the recorded
        input packed flat (pad = the layer's packed zero), the ring
        unmasked: what lands there is computed across image boundaries;
      * ResNet-18's stride-1 BasicBlocks as two-conv chains on the flat
        raster: body.0 into requant8 with its ring masked to body.1's
        packed zero, then body.1 into int32 -- equal to K2's chain only if
        the ring mask is right.
    Per path, the launch counts are set to 0 just before its calls and read
    just after (on a card: one K6 launch per call and no other kernel); then
    each call is held to its plain version on every row of the raster and,
    unpacked, to K2's recorded output.  Returns ([(label, [(K6 args, kwargs,
    output, max abs err)], [(K2 args, kwargs)])], one entry per conv or
    chain; {path: the launch counts read after its calls})."""
    jobs = []  # (label, [(K6 args, kwargs)], [(K2 args, kwargs, K2 output)])
    eng, _, checked = paths["resnet50"]
    names = layers_by_weight(eng)
    for name, cargs, kw, out, _ in checked:
        if name != "conv_int8" or kw["stride"] != 1 or cargs[1].shape[0] != 3:
            continue
        x, wp, b = cargs
        xf, geom = flat_ops.pack_flat(x, 1, kw["pad_value"])
        fkw = flat_kwargs(kw, geom, mask_pad=False, mask_value=0)
        jobs.append((f"resnet50 {names[id(wp)]}", [((xf, wp, b), fkw)], [(cargs, kw, out)]))
    eng, _, checked = paths["resnet18"]
    names = layers_by_weight(eng)
    calls = {names[id(c[1][1])]: c for c in checked if c[0] == "conv_int8"}
    for meta in eng.model.blocks:
        if meta.shortcut is not None:
            continue
        _, args0, kw0, out0, _ = calls[meta.body[0]]
        _, args1, kw1, out1, _ = calls[meta.body[1]]
        (x0, wp0, b0), (_, wp1, b1) = args0, args1
        xf, geom = flat_ops.pack_flat(x0, 1, kw0["pad_value"])
        k0 = flat_kwargs(kw0, geom, mask_pad=True, mask_value=kw1["pad_value"])
        k1 = flat_kwargs(kw1, geom, mask_pad=True, mask_value=0)
        # body.1's input is body.0's output: filled in as the chain runs
        jobs.append((f"resnet18 {meta.body[0]} -> {meta.body[1]}",
                     [((xf, wp0, b0), k0), ((None, wp1, b1), k1)],
                     [(args0, kw0, out0), (args1, kw1, out1)]))
    fn = KERNELS["conv_flat_int8"]["fn"]
    outs, path_counts = [], {}
    for path in dict.fromkeys(label.split()[0] for label, _, _ in jobs):
        reset_launches()
        ncalls = 0
        for label, k6, _ in jobs:
            if label.split()[0] != path:
                continue
            ys = []
            for i, (args, kw) in enumerate(k6):
                if args[0] is None:
                    args = (ys[-1], *args[1:])
                    k6[i] = (args, kw)
                ys.append(fn(*args, **kw))
            outs.append(ys)
            ncalls += len(ys)
        if outs[-1][0].device.type == "cuda":
            torch.cuda.synchronize()
        path_counts[path] = launches()
        want = {name: ncalls if name == "conv_flat_int8" else 0 for name in KERNELS}
        if outs[-1][0].device.type == "cuda" and path_counts[path] != want:
            raise AssertionError(f"flat phase {path}: launches {path_counts[path]}, "
                                 f"expected {want}")
    groups = []
    for (label, k6, k2), ys in zip(jobs, outs):
        calls = []
        for (args, kw), y, (_, _, out) in zip(k6, ys, k2):
            err = check_plain("conv_flat_int8", args, kw, y)
            if not torch.equal(flat_ops.unpack_flat(y, kw["geom"], 1), out):
                raise AssertionError(f"conv_flat_int8 at {label}: differs from conv_int8")
            calls.append((args, kw, y, err))
        groups.append((label, calls, [(a, kw) for a, kw, _ in k2]))
    return groups, path_counts


def new_row(name):
    has_library = name != "ir_block"
    return dict(max_abs_err=0, ms=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0,
                library_ms=0.0 if has_library else None, by_path={})


def time_into(row, path, launches, name, cargs, kw, out, err):
    """Time one kernel call (time_call), log it, and add it to the kernel's
    row and to the row's entry for `path`.  Returns (the kernel's ms, its
    bound ms)."""
    ms, call_ms, plain_ms, nb, ops = time_call(name, cargs, kw, out, reps=10)
    tb, to = bound_s(nb, ops)
    log(f"{path} time {name} {describe(cargs, kw)}: {ms:.4f} ms (call {call_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, bound {1e3 * max(tb, to):.4f} ms "
        f"({'bytes' if tb > to else 'operations'}), {nb} bytes, {ops} ops")
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["ms"] += ms
    row["plain_ms"] += plain_ms
    row["bound_ms"] += 1e3 * max(tb, to)
    row["t_bytes"] += tb
    row["t_ops"] += to
    by = row["by_path"].setdefault(path, dict(
        launches=launches, ms=0.0, bound_ms=0.0,
        library_ms=None if row["library_ms"] is None else 0.0,
    ))
    by["ms"] += ms
    by["bound_ms"] += 1e3 * max(tb, to)
    return ms, 1e3 * max(tb, to)


def k2_plan_of(cargs, kw, out):
    """(M, K, N, kernel, stride, K2's plan) of a recorded K2 call."""
    kh, kwd, c, o = cargs[1].shape
    m = out.shape[0] * out.shape[1] * out.shape[2]
    sms = torch.cuda.get_device_properties(out.device).multi_processor_count
    return m, kh * kwd * c, o, kh, kw["stride"], conv_ops.plan_conv(m, kh * kwd * c, o, sms)


def log_k2_table(rows, card: str) -> None:
    """Per-shape table of K2's calls: shape, plan, device ms beside the bound
    and F.conv2d's (float32) at the same shape."""
    log(f"K2 per shape, batch {BATCH}, {IMAGE_SIZE} px ({card}): path | M | K | N | kernel/stride "
        f"| tile | split | blocks | calls | ms per call | bound ms | x bound | F.conv2d ms")
    shapes = {}
    for path, cargs, kw, out, ms, bound, lib in rows:
        m, k, n, kh, st, plan = k2_plan_of(cargs, kw, out)
        key = (path, m, k, n, kh, st, plan)
        tot = shapes.setdefault(key, [0, 0.0, bound, lib])
        tot[0] += 1
        tot[1] += ms
    for (path, m, k, n, kh, st, plan), (calls, ms, bound, lib) in shapes.items():
        log(f"  K2 | {path} | {m} | {k} | {n} | {kh}x{kh}/s{st} | {conv_ops.BM}x{plan.bn} | {plan.splits} | "
            f"{plan.blocks} | {calls} | {ms / calls:.4f} | {bound:.5f} | {ms / calls / bound:.1f} | "
            f"{lib:.4f}")


def log_k6_table(rows, card: str) -> None:
    """K6's calls one by one: shape, ring mask and epilogue, plan
    (ops/conv_flat.py:plan_flat), device ms beside the bound, K2's ms and
    F.conv2d's (float32) at the same call."""
    log(f"K6 per call, batch {BATCH}, {IMAGE_SIZE} px ({card}): conv | M | C | O | mask "
        f"| epilogue | tile | split | blocks | smem | K6 ms | bound ms | x bound "
        f"| K2 ms | F.conv2d ms")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (args, kw, out, _), ms, bound, k2_ms, lib_ms in rows:
        (m, c), o, w2 = args[0].shape, out.shape[1], kw["geom"][2]
        plan = flat_ops.plan_flat(m, c, o, kw["kernel"][0], w2, sms)
        log(f"  K6 | {label} | {m} | {c} | {o} | {kw['mask_pad']} | {kw['epilogue']} | "
            f"{flat_ops.BM}x{plan.bn} | {plan.splits} | {plan.blocks(m, o)} | "
            f"{flat_ops.flat_smem(kw['kernel'][0], w2, plan.bn, plan.splits)} | {ms:.4f} | {bound:.5f} | {ms / bound:.1f} | {k2_ms:.4f} | "
            f"{lib_ms:.4f}")


def log_k5_table(rows, card: str) -> None:
    """K5's calls one by one, per forward: shape, form (carry: none, int32
    or int8 with its offset; output), plan (ops/ir_block.py:plan_ir),
    device ms beside the bound.  Both products run on wgmma at every
    shape."""
    log(f"K5 per call, batch {BATCH}, {IMAGE_SIZE} px ({card}): rung | h x w | cin | ce | cout "
        f"| carry | out | band rows | bands | Ce splits x channels | blocks | ms | bound ms "
        f"| x bound")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, cargs, kw, out, ms, bound in rows:
        n, h, w, cin = cargs[0].shape
        kh, _, ce = cargs[3].shape
        cout = out.shape[3]
        carry = k5_carry(cargs)
        cb, ob = ir_ops.call_bytes(None if carry == "none" else cargs[7], kw["out"])
        plan = ir_ops.plan_ir(n, h, w, cin, ce, cout, kh, sms, cb, ob)
        if carry == "int8":
            carry += f" +{kw.get('carry_add_offset', 0)}"
        log(f"  K5 | {label} | {h}x{w} | {cin} | {ce} | {cout} | {carry} | {kw['out']} "
            f"| {plan.th} | {plan.bands} | {plan.splits} x {plan.cs} | {n * plan.bands * plan.splits} "
            f"| {ms:.4f} | {bound:.5f} | {ms / bound:.1f}")


def log_k7_table(rows, card: str) -> None:
    """K7 per (M, K, N, epilogue), beside K1 and torch._int_mm at the same
    calls, with its plan (ops/gemm_v2.py:plan_gemm)."""
    log(f"K7 per shape, batch {BATCH}, {IMAGE_SIZE} px ({card}): path | M | K | N | epilogue | "
        f"calls | tile | split | blocks | K7 ms | K1 ms | _int_mm ms | bound ms | x bound")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = {}
    for path, cargs, kw, out, ms, bound, k1_ms, lib_ms in rows:
        (m, k), n = cargs[0].shape, out.shape[1]
        tot = shapes.setdefault((path, m, k, n, kw["epilogue"]), [0, 0.0, 0.0, 0.0, bound])
        tot[0] += 1
        tot[1] += ms
        tot[2] += k1_ms
        tot[3] += lib_ms
    for (path, m, k, n, epi), (calls, ms, k1, lib, bound) in shapes.items():
        plan = gemm_v2_ops.plan_gemm(m, k, n, sms)
        log(f"  K7 | {path} | {m} | {k} | {n} | {epi} | {calls} | {gemm_v2_ops.BM}x{plan.bn} | {plan.splits} "
            f"| {plan.grid} | {ms / calls:.4f} | {k1 / calls:.4f} | {lib / calls:.4f} "
            f"| {bound:.5f} | {ms / calls / bound:.1f}")


def k1_plan_text(plan) -> str:
    """A K1 plan (ops/gemm.py:plan_k1) in a table cell."""
    if plan.form == "skinny":
        return f"skinny {plan.bm}x{plan.bn}, {plan.ntiles} blocks"
    if plan.form == "narrow":
        return (f"narrow {plan.bm}x{plan.bn}, {plan.mtiles} tiles on {plan.grid} blocks of "
                f"{plan.warps} warps")
    return f"general {plan.bm}x{plan.bn}, {plan.mtiles * plan.ntiles} tiles"


def prev_ms(name, cargs, kw):
    """The replaced design's recorded ms for the same call (PREV_MS), or None."""
    key = (name, tuple(cargs[0].shape), tuple(cargs[1].shape), kw.get("stride", 1))
    return PREV_MS.get(key)


def cell(v, fmt=".4f") -> str:
    return "--" if v is None else format(v, fmt)


def log_k1_table(rows, card: str) -> None:
    """K1's calls one by one, strict forwards: shape, epilogue, form and plan
    (ops/gemm.py:plan_k1), device ms beside the replaced design's recorded ms,
    torch._int_mm's and the bound."""
    log(f"K1 per call, batch {BATCH}, {IMAGE_SIZE} px ({card}): path | M | K | N | epilogue | "
        f"form and plan | K1 ms | PR 6 ms, recorded (PERF.md s6) | _int_mm ms (at M) | bound ms | "
        f"x bound")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for path, cargs, kw, out, ms, bound, lib_ms, lib_m in rows:
        (m, k), n = cargs[0].shape, out.shape[1]
        plan = gemm_ops.plan_k1(m, k, n, sms, 4 if kw["epilogue"] == "int32" else 1)
        log(f"  K1 | {path} | {m} | {k} | {n} | {kw['epilogue']} | {k1_plan_text(plan)} | "
            f"{ms:.4f} | {cell(prev_ms('int8_gemm', cargs, kw))} | {lib_ms:.4f} (M={lib_m}) | "
            f"{bound:.5f} | {ms / bound:.1f}")


def conv_library_ms(x, w, stride: int, padding: int, pad_value: int, groups: int = 1) -> float:
    """Device ms of one F.conv2d computing a conv kernel's products on the
    same inputs: x (NHWC int8) padded with pad_value beforehand, HWIO
    weights, float32 with TF32 off, channels_last; no bias or epilogue.
    Exact while |acc| <= kh * kw * (C / groups) * 128 * 127 < 2^24 (K4's and
    K3's 7x7 x 3); at K2's larger reductions float32 may round a sum: a
    yardstick of time, not of the integers."""
    p = padding
    xf = F.pad(x.permute(0, 3, 1, 2).float(), (p, p, p, p), value=float(pad_value))
    xf = xf.contiguous(memory_format=torch.channels_last)
    wf = w.permute(3, 2, 0, 1).float().contiguous(memory_format=torch.channels_last)
    return device_ms(lambda: F.conv2d(xf, wf, stride=stride, groups=groups))[0]


# the conv kernels timed against F.conv2d, and what each one's log line adds
# to "F.conv2d (float32, channels_last, no epilogue"
CONV_LIBRARY = {"conv_int8": "", "dw_int8": ", groups=C",
                "stem_pool": ", the 7x7/s2 conv without the pool"}


def library_conv_ms(eng, name, cargs, kw) -> float:
    """F.conv2d at a recorded K2, K4 or K3 call (conv_library_ms): K2 on its
    weights as HWIO, K4 with groups = C, K3's 7x7/s2 conv alone (without the
    pool) on the engine's HWIO head weights."""
    x = cargs[0]
    if name == "stem_pool":
        spec = eng.graph["head"]
        return conv_library_ms(x, eng.params["head"]["w"], spec.stride[0], spec.padding[0],
                               kw["pad_value"])
    groups = x.shape[3] if name == "dw_int8" else 1
    return conv_library_ms(x, hwio(cargs[1]), kw["stride"], kw["padding"], kw["pad_value"], groups)


def dw_floor_ms(cargs, out, clock_mhz: float) -> float:
    """K4's CUDA-core issue floor: k * ceil(k / 4) dp4a per output element
    (4 taps each), at INT_MAD_PER_CLOCK_PER_SM on every SM at `clock_mhz`."""
    k = cargs[1].shape[0]
    sms = torch.cuda.get_device_properties(out.device).multi_processor_count
    return out.numel() * k * -(-k // 4) / (sms * INT_MAD_PER_CLOCK_PER_SM * clock_mhz * 1e3)


def log_k4_table(rows, card: str, clock_mhz: float) -> None:
    """K4's calls one by one, strict forwards: shape, stride, tile
    (ops/dw.py:plan_dw), device ms beside the replaced design's recorded ms, F.conv2d's, the
    bytes bound and the dp4a issue floor (at an assumed dp4a rate); x bound against the larger
    of the two."""
    log(f"K4 per call, batch {BATCH}, {IMAGE_SIZE} px ({card}; floor at {clock_mhz:.0f} MHz): "
        f"path | x | k/stride | epilogue | tile th x tw x cb | threads | tiles | blocks | K4 ms "
        f"| PR 6 ms, recorded (PERF.md s6) | F.conv2d ms | bytes bound ms | "
        f"dp4a floor ms (assumed rate) | x bound")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for path, cargs, kw, out, ms, bound, lib_ms in rows:
        n, h, w, c = cargs[0].shape
        k, st, pad = cargs[1].shape[0], kw["stride"], kw["padding"]
        plan = dw_ops.plan_dw(n, h, w, c, k, st, pad, sms)
        g = dw_ops.dw_geometry(h, w, c, k, st, pad, plan.th, plan.tw, plan.cb, plan.rowb)
        floor = dw_floor_ms(cargs, out, clock_mhz)
        log(f"  K4 | {path} | {n}x{h}x{w}x{c} | {k}x{k}/s{st} | {kw['epilogue']} | "
            f"{plan.th}x{plan.tw}x{plan.cb} | {g.threads} | {n * g.tiles_per_image} | {plan.grid} | "
            f"{ms:.4f} | {cell(prev_ms('dw_int8', cargs, kw))} | {lib_ms:.4f} | {bound:.5f} | "
            f"{floor:.5f} | {ms / max(bound, floor):.1f}")


def add_to(row, path, key, ms):
    """Add a yardstick's ms to a kernel's row and to its entry for `path`."""
    row[key] = row.get(key, 0.0) + ms
    by = row["by_path"][path]
    by[key] = (by.get(key) or 0.0) + ms


def timing_phase(forwards, paths, flat, extra, images, device, card: str) -> dict:
    """Times every kernel call of every forward, K6 on its recorded
    activations beside K2, K1's extra requant8 call, and each path's whole
    forwards in each rung beside the bf16 baseline; logs the K2, K5 and K7
    tables and the images/s table.  `flat` is what flat_phase returned;
    `extra` is (args, kwargs, output) of K1's extra call; `images` the batch
    the forwards are timed on.  Returns {kernel: its row of the kernel table}."""
    extra, extra_kw, extra_out = extra
    # timing: each call of each forward (all three rungs); a kernel's row
    # sums its calls, a GEMM's library time sums torch._int_mm at the same
    # calls, and K7's row also sums K1's time at its calls.  The K2 and K7
    # tables list the strict forwards' calls (the rungs make the same calls
    # on other inputs); the K5 table every forward's, with each call's form.
    table = {n: new_row(n) for n in KERNELS}
    k1_rows, k2_rows, k4_rows, k5_rows, k7_rows = [], [], [], [], []
    k1_at_k7, conv_lib = {}, {}
    for (path, rung), (eng, counts, checked) in forwards.items():
        key = path if rung is None else f"{path}/{RUNGS[rung]}"
        for name, cargs, kw, out, err in checked:
            ms, bound = time_into(table[name], key, counts[name], name, cargs, kw, out, err)
            if name in ("int8_gemm", "int8_gemm_v2"):
                (M, K), N = cargs[0].shape, out.shape[1]
                lib_ms, lib_m = int_mm_ms(M, K, N, device)
                log(f"{key} library {name}: torch._int_mm at M={lib_m} (call's M={M}), "
                    f"K={K}, N={N}: {lib_ms:.4f} ms")
                add_to(table[name], key, "library_ms", lib_ms)
            if name == "int8_gemm" and rung is None:
                k1_rows.append((path, cargs, kw, out, ms, bound, lib_ms, lib_m))
            if name in CONV_LIBRARY:
                shape = (name, tuple(cargs[0].shape), tuple(cargs[1].shape), kw.get("stride"),
                         kw.get("padding"))
                if shape not in conv_lib:  # timed once per shape: the values do not matter
                    conv_lib[shape] = library_conv_ms(eng, name, cargs, kw)
                log(f"{key} library {name}: F.conv2d (float32, channels_last, no epilogue"
                    f"{CONV_LIBRARY[name]}) at the same call: {conv_lib[shape]:.4f} ms")
                add_to(table[name], key, "library_ms", conv_lib[shape])
                if name == "dw_int8" and rung is None:
                    k4_rows.append((path, cargs, kw, out, ms, bound, conv_lib[shape]))
                if name == "conv_int8" and rung is None:
                    k2_rows.append((path, cargs, kw, out, ms, bound, conv_lib[shape]))
            if name == "int8_gemm_v2":
                shape = (tuple(cargs[0].shape), N, tuple(sorted(kw.items())))
                if shape not in k1_at_k7:  # timed once per shape and epilogue
                    a1 = k1_args(cargs)
                    k1_at_k7[shape] = device_ms(lambda: gemm_ops.int8_gemm(*a1, **kw))[0]
                k1_ms = k1_at_k7[shape]
                log(f"{key} int8_gemm at the same call: {k1_ms:.4f} ms")
                add_to(table[name], key, "k1_ms", k1_ms)
                if rung is None:
                    k7_rows.append((path, cargs, kw, out, ms, bound, k1_ms, lib_ms))
            if name == "ir_block":
                k5_rows.append((RUNGS.get(rung, "strict"), cargs, kw, out, ms, bound))
    row = table["conv_flat_int8"]
    k6_rows = []
    flat, flat_counts = flat
    for label, k6_calls, k2_calls in flat:
        path = label.split()[0]
        k6 = k2 = lib = 0.0
        for c6, (a2, kw2) in zip(k6_calls, k2_calls):
            ms6, bound = time_into(row, path, flat_counts[path]["conv_flat_int8"],
                                   "conv_flat_int8", *c6)
            ms2 = device_ms(lambda: conv_ops.conv_int8(*a2, **kw2))[0]
            lib_ms = library_conv_ms(None, "conv_int8", a2, kw2)
            k6_rows.append((label, c6, ms6, bound, ms2, lib_ms))
            k6, k2, lib = k6 + ms6, k2 + ms2, lib + lib_ms
        add_to(row, path, "library_ms", lib)
        log(f"{label}: conv_flat_int8 {k6:.4f} ms, conv_int8 {k2:.4f} ms, F.conv2d (float32, "
            f"channels_last, no epilogue) {lib:.4f} ms at the same call(s)")
        add_to(row, path, "k2_ms", k2)
    ms, call_ms, plain_ms, nb, ops = time_call("int8_gemm", extra, extra_kw, extra_out, 10)
    tb, to = bound_s(nb, ops)
    log(f"time int8_gemm {describe(extra, extra_kw)}: {ms:.4f} ms (call {call_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, bound {1e3 * max(tb, to):.4f} ms, {nb} bytes, {ops} ops")

    log_k1_table(k1_rows, card)
    log_k2_table(k2_rows, card)
    log_k4_table(k4_rows, card, float(smi("clocks.max.sm").split()[0]))
    log_k5_table(k5_rows, card)
    log_k7_table(k7_rows, card)
    log_k6_table(k6_rows, card)

    # whole forwards: the bf16 baseline first, then each rung, per path, in
    # one call on one card; cuDNN picks its fastest algorithm for the
    # baseline, as a bf16 deployment would let it; the phases after this one
    # (the training steps) run with the setting the Trainer leaves, as before
    speeds, autotune = {}, torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        for path in LAUNCHES_PER_FORWARD:
            speeds[(path, "bf16 baseline")] = time_baseline(path, paths[path][0], images, card)
            for rung in (None, *RUNGS):
                eng = forwards[(path, rung)][0]
                label = f"{path} {RUNGS.get(rung, 'strict')}"
                speeds[(path, label)] = time_forward(label, eng, images, card,
                                                     eng.condition_input)
    finally:
        torch.backends.cudnn.benchmark = autotune
    log(f"images/s and ratio to the bf16 baseline, {IMAGE_SIZE} px ({card}): path | batch | "
        f"bf16 baseline | strict (ratio) | int8 (ratio) | bf16 (ratio)")
    for path in LAUNCHES_PER_FORWARD:
        for b in TIMED_BATCHES:
            base = speeds[(path, "bf16 baseline")][b]
            cells = [f"{speeds[(path, f'{path} {r}')][b]:.1f} ({speeds[(path, f'{path} {r}')][b] / base:.3f})"
                     for r in ("strict", "int8", "bf16")]
            log(f"  speed | {path} | {b} | {base:.1f} | " + " | ".join(cells))
    return table


def bake_phase(seed: int, images, card: str):
    """The port's own QAT forward and bake on ResNet-18 (see the module
    docstring), on the images' device.  quant_avgpool without pool fusing:
    ResNet's QAT forward does not apply the pool-fusing scale (the bake
    alone folds it into the last conv), so only without it do the QAT
    int_infer forward and the integer engine compute the same network.
    Returns (launches per forward, checked kernel calls) of the baked
    engine's forward and (model, plan, int params, engine)."""
    dev = images.device
    cfg = CFG.replace(pool_fusing=False)
    model = get_model("resnet18", cfg, num_classes=1000, image_size=IMAGE_SIZE)
    params, state = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)

    def batch(i):  # the wire's conditioning, round(255 x) / 256
        j = i % (len(images) // BATCH)
        return torch.round(255.0 * images[j * BATCH:(j + 1) * BATCH]) / 256.0

    history = []
    with torch.no_grad():
        for i in range(BAKE_TRAIN_STEPS):
            _, state = model.apply(params, state, batch(i), mode="train")
            history.append([round(float(st["input_fl_ema"][0])) for st in state.values()])
        state = reset_bn_for_calib(state)
        for i in range(BAKE_CALIB_STEPS):
            _, state = model.apply(params, state, batch(i), mode="calib")
    moved = [sum(a != b for a, b in zip(history[i - 1], history[i])) for i in range(1, len(history))]
    log(f"bake: {BAKE_TRAIN_STEPS} train-mode forwards at batch {BATCH}; layers whose rounded EMA "
        f"fraclen moved at each step: {moved}")
    if dev.type == "cuda":
        ms = time_ms(lambda: model.apply(params, state, batch(0), mode="train"), reps=3, rounds=3)
        log(f"bake: QAT train-mode forward (autograd on), batch {BATCH}, {IMAGE_SIZE} px: "
            f"{ms:.3f} ms wall ({card})")
    plan, int_params = bake_plan(model, params, state)
    log("bake: fraclens " + " ".join(f"{p.name}={p.input_fl}/{p.weight_fl}" for p in plan.layers))
    eng = IntEngine(model, plan, int_params, device=dev)
    logits, counts, checked = drive("resnet18 baked", "resnet18", eng, images, log_calls=False,
                                    gate=False)
    x = images[:BATCH]
    sim = IntEngine(model, plan, int_params, device=dev, int_only=False)
    xf = sim.condition_input(x)
    qat, _ = model.apply(params, state, xf, mode="eval", cfg=cfg.replace(int_infer=True))
    tol = BAKE_ATOL * float(logits.abs().max())
    for what, other in (("IntEngine(int_only=False)", sim(xf)),
                        ("QAT eval forward with int_infer", qat * 2.0**plan["classifier"].out_fl)):
        err = float((other - logits).abs().max())
        agree = float((other.argmax(1) == logits.argmax(1)).double().mean())
        log(f"bake: {what} against the integer logits: largest difference {err} (limit {tol}), "
            f"top-1 agreement {agree:.3f}")
        if not err <= tol:
            raise AssertionError(f"bake: {what} parts from the integer engine by {err} > {tol}")
    tools_phase(model, params, state, card)
    return counts, checked, (model, plan, int_params, eng)


def tools_phase(model, params, state, card: str) -> None:
    """The offline tools (f8net_tpu_torch/tools) on the bake phase's
    ResNet-18 and on the card: error_analysis.fit_all_metrics with fix_quant
    on the card equal to the same call on the CPU (exact float32 arithmetic
    both ways); weight_boxplot.folded_weight_stats of every conv within
    rtol 1e-6 of the same on CPU copies of the params and state;
    fraclen_visual.profile_table of the card's fraclen report, one row per
    layer (logged: whether the CPU copy's table is the same text)."""
    dev = next(iter(params.values()))["w"].device
    t0 = time.perf_counter()
    fits = error_analysis.fit_all_metrics(device=dev)
    t_fit = time.perf_counter() - t0
    if fits != error_analysis.fit_all_metrics(device="cpu"):
        raise AssertionError(f"tools: fit_all_metrics on {dev} differs from the CPU's: {fits}")
    log(f"tools: fit_all_metrics (n 10000) on {dev} in {t_fit:.2f} s equal to the CPU's: "
        + ", ".join(f"{'signed' if s else 'unsigned'} {m} {v:.1f}" for s, d in fits.items()
                    for m, v in d.items()) + f" ({card})")
    host = lambda tree: {k: {kk: v.detach().cpu() for kk, v in d.items()}  # noqa: E731
                         for k, d in tree.items()}
    stats = weight_boxplot.folded_weight_stats(model, params, state)
    want = weight_boxplot.folded_weight_stats(model, host(params), host(state))
    for name, st in want.items():
        for key, v in st.items():
            if not math.isclose(stats[name][key], v, rel_tol=1e-6, abs_tol=0.0):
                raise AssertionError(f"tools: folded weight {key} of {name}: {stats[name][key]} on "
                                     f"{dev}, {v} on the CPU")
    widest = max(stats, key=lambda n: stats[n]["max"] - stats[n]["min"])
    log(f"tools: folded_weight_stats of {len(stats)} convs within rtol 1e-6 of the CPU's; widest "
        f"{widest} [{stats[widest]['min']:.4f}, {stats[widest]['max']:.4f}], std "
        f"{stats[widest]['std']:.4f}")
    tables = []
    for p, st in ((params, state), (host(params), host(state))):
        buf = io.StringIO()
        fraclen_report(model, p, st, print_fn=lambda t: buf.write(t + "\n"))
        tables.append(fraclen_visual.profile_table(parse_fraclen_report(buf.getvalue())))
    rows = tables[0].splitlines()
    if len(rows) != len(model.graph.names()) + 1:
        raise AssertionError(f"tools: profile_table has {len(rows)} lines for "
                             f"{len(model.graph.names())} layers")
    log(f"tools: profile_table of the card's fraclen report: {len(rows) - 1} layers "
        f"({rows[1]!r} ... {rows[-1]!r}); the CPU copy's table "
        f"{'the same text' if tables[0] == tables[1] else 'differs'}")


# -- serve and export -----------------------------------------------------------


def serve_traffic(seed: int, image_size: int = IMAGE_SIZE):
    """The serve phase's requests: (trickle requests, one list of requests
    per client).  Every image is distinct random uint8 with its index in its
    first pixel's three bytes (image_id), which finds its rows in a recorded
    device batch; a request is a slice of the pool, int32 where the copy
    path is meant."""
    rng = np.random.RandomState(seed + 7)
    sizes = rng.randint(1, 5, (SERVE_CLIENTS, SERVE_REQUESTS))
    n = SERVE_TRICKLE + int(sizes.sum()) + SERVE_OVERSIZED
    shape = (n, image_size, image_size, 3)
    pool = np.frombuffer(rng.bytes(math.prod(shape)), np.uint8).reshape(shape).copy()
    ids = np.arange(n)
    pool[:, 0, 0] = np.stack([ids % 256, ids // 256 % 256, ids // 65536], 1)
    trickle = [pool[i:i + 1] for i in range(SERVE_TRICKLE)]
    k, clients = SERVE_TRICKLE, []
    for c in range(SERVE_CLIENTS):
        reqs = []
        for j, size in enumerate(sizes[c]):
            r = pool[k:k + size]
            k += size
            copy_path = (c * SERVE_REQUESTS + j) % SERVE_COPY_EVERY == SERVE_COPY_EVERY - 1
            reqs.append(r.astype(np.int32) if copy_path else r)
        clients.append(reqs)
    clients[0].insert(SERVE_REQUESTS // 2, pool[k:k + SERVE_OVERSIZED])
    return trickle, clients


def image_id(x: np.ndarray) -> np.ndarray:
    """The indices serve_traffic wrote into images x (N, H, W, 3)."""
    p = x[:, 0, 0].astype(np.int64)
    return p[:, 0] + 256 * p[:, 1] + 65536 * p[:, 2]


class ServeRecorder:
    """An engine for ServingEngine that keeps each device batch it is handed,
    its logits and the kernel launches its forward made (the dispatcher
    thread is the only one that launches while the server runs)."""

    def __init__(self, engine: IntEngine):
        self.engine, self.device, self.calls = engine, engine.device, []

    def __call__(self, x):
        before = launches()
        y = self.engine(x)
        after = launches()
        self.calls.append((x.clone(), y.clone(), {k: after[k] - before[k] for k in after}))
        return y


def run_clients(srv: ServingEngine, clients):
    """Each client in a thread of its own sends its requests one after the
    other, waiting for each answer.  Returns (wall s, [(request, logits,
    latency s)])."""
    out = [[] for _ in clients]
    errors = []

    def client(c):
        try:
            for r in clients[c]:
                t = time.perf_counter()
                y = srv.infer(r, timeout=SERVE_TIMEOUT)
                out[c].append((r, y, time.perf_counter() - t))
        except Exception as e:  # re-raised by the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(len(clients))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(SERVE_TIMEOUT)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or any(len(o) != len(c) for o, c in zip(out, clients)):
        raise AssertionError("serve: a client did not get all its answers")
    return wall, [r for o in out for r in o]


def latency_ms(results):
    """(p50, p99) of the results' client-side latencies, ms."""
    lat = np.array([r[2] for r in results]) * 1e3
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))


def check_served(label: str, eng: IntEngine, rec: ServeRecorder, served, strict: bool):
    """Every served row bitwise equal to the row of its image in a recorded
    device batch; the engine again on each recorded batch bitwise equal to
    what it gave while serving; in the strict rung each request bitwise
    equal to the engine on its images alone."""
    where, rows = {}, []
    for ci, (x, y, _) in enumerate(rec.calls):
        x8 = x.cpu().to(torch.uint8).numpy()  # an int32 copy batch holds 0..255
        for r, i in enumerate(image_id(x8)):
            where.setdefault(int(i), []).append((ci, r))
        rows.append((x8, y.cpu().numpy()))
        if not torch.equal(eng(x), y):
            raise AssertionError(f"{label} serve: the engine on recorded batch {ci} differs")
    direct = {}
    for req, logits, _ in served:
        req8 = req.astype(np.uint8)
        for img, i, row in zip(req8, image_id(req8), logits):
            if not any(np.array_equal(rows[ci][0][r], img) and np.array_equal(rows[ci][1][r], row)
                       for ci, r in where.get(int(i), [])):
                raise AssertionError(f"{label} serve: image {i}'s row is not its device batch's")
        if strict:
            if id(req) not in direct:
                direct[id(req)] = eng(torch.from_numpy(req).to(eng.device)).cpu().numpy()
            if not np.array_equal(direct[id(req)], logits):
                raise AssertionError(f"{label} serve: a request of {len(req)} images differs "
                                     f"from the engine on its images alone")
    return len(direct)


class ForwardEvents:
    """An engine for ServingEngine that queues a spin kernel of
    SERVE_SPIN_CYCLES ahead of each forward on the card (so every batch
    outlasts the host's enqueue of the next, in either rung) and records an
    event behind it."""

    def __init__(self, engine: IntEngine):
        self.engine, self.device, self.done = engine, engine.device, []

    def __call__(self, x):
        if x.is_cuda:
            torch.cuda._sleep(SERVE_SPIN_CYCLES)
        y = self.engine(x)
        if y.is_cuda:
            ev = torch.cuda.Event()
            ev.record()
            self.done.append(ev)
        return y


def check_pipeline(label: str, eng: IntEngine, server, clients) -> None:
    """Batch k routed while batch k+1 still runs on the card (module
    docstring): SERVE_PIPELINED requests of one full batch each, from the
    clients' uint8 images, all queued before the server starts, so the
    dispatcher finds the next one at once.  Every request's logits bitwise
    equal to the engine's on its images."""
    b = max(SERVE_BUCKETS)
    pool = np.concatenate([r for c in clients for r in c if r.dtype == np.uint8])
    reqs = [pool[k * b:(k + 1) * b] for k in range(SERVE_PIPELINED)]
    if SERVE_PIPELINED * b > SERVE_RING or len(reqs[-1]) != b:
        raise ValueError("the pipeline check's requests must be full batches that fit the ring")
    probe = ForwardEvents(eng)
    srv = server(probe, name=f"pipeline-{label}")
    running = {}

    def routed(k):
        def note(_):  # in the dispatcher thread, as batch k's rows are routed
            nxt = probe.done[k + 1] if len(probe.done) > k + 1 else None
            running[k] = None if nxt is None else not nxt.query()
        return note

    futs = [srv.submit(r) for r in reqs]
    for k, f in enumerate(futs):
        f.add_done_callback(routed(k))
    try:
        srv.start()
        got = [f.result(SERVE_TIMEOUT) for f in futs]
    finally:
        srv.stop()
    if (srv.stats["batches"], srv.stats["ring_batches"]) != (SERVE_PIPELINED, SERVE_PIPELINED):
        raise AssertionError(f"{label} serve: pipeline: not one ring batch per request: {srv.stats}")
    for k, (r, y) in enumerate(zip(reqs, got)):
        if not np.array_equal(eng(torch.from_numpy(r).to(eng.device)).cpu().numpy(), y):
            raise AssertionError(f"{label} serve: pipeline: request {k} differs from the engine")
    if eng.device.type != "cuda":
        return
    for k in range(SERVE_PIPELINED - 1):
        if running.get(k) is None:
            raise AssertionError(f"{label} serve: pipeline: batch {k + 1} was not enqueued when "
                                 f"batch {k} was routed")
        if not running[k]:
            raise AssertionError(f"{label} serve: pipeline: batch {k + 1}'s forward had finished "
                                 f"on the card when batch {k} was routed")
    log(f"{label} serve: pipeline: each of batches 0-{SERVE_PIPELINED - 2} (of {b} images, each "
        f"forward behind a {SERVE_SPIN_CYCLES}-cycle spin) routed while the next batch's forward "
        f"was still running on the card; every request bitwise equal to the engine on its images")


def serve_rung(label: str, eng: IntEngine, traffic, card: str):
    """The serve phase of one rung (module docstring).  Returns the launches
    made in the checked window."""
    trickle, clients = traffic
    dev = eng.device
    side = trickle[0].shape[1]
    x64 = np.concatenate(clients[0])[:max(SERVE_BUCKETS)].astype(np.uint8)
    x64 = torch.from_numpy(x64).to(dev)
    for b in SERVE_BUCKETS:  # warm-up, and no synchronising call in the forward
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            eng(x64[:b])
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng(x64)
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        log(f"{label} serve: IntEngine.__call__ made no synchronising CUDA call at batch "
            f"{', '.join(map(str, SERVE_BUCKETS))}; at batch {max(SERVE_BUCKETS)} it returned after "
            f"{1e3 * enqueue:.3f} ms, the card finished after {1e3 * (time.perf_counter() - t0):.3f} ms")
    server = functools.partial(
        ServingEngine, buckets=SERVE_BUCKETS, max_wait_ms=SERVE_WAIT_MS, ring_capacity=SERVE_RING,
        image_shape=(side, side, 3), image_dtype=np.uint8,
    )
    want = expected_launches("resnet18")

    def check_stopped(srv, what):
        if srv._thread.is_alive():
            raise AssertionError(f"{label} serve: {what}: the dispatcher did not stop")
        hits = srv.stats["bucket_hits"]
        if not (hits.get(min(SERVE_BUCKETS)) and hits.get(max(SERVE_BUCKETS))
                and srv.stats["ring_batches"] and srv.stats["copy_batches"]):
            raise AssertionError(f"{label} serve: {what}: a path of the server went unused: "
                                 f"{srv.stats}")

    # the checked window: every device batch recorded
    rec = ServeRecorder(eng)
    srv = server(rec, name=f"serve-{label}-checked")
    reset_launches()
    try:
        srv.start()
        _, low = run_clients(srv, [trickle])
        _, res = run_clients(srv, clients)
    finally:
        srv.stop()
    counts = launches()
    check_stopped(srv, "checked window")
    batches = len(rec.calls)
    if srv.stats["batches"] != batches:
        raise AssertionError(f"{label} serve: {srv.stats['batches']} batches routed, {batches} run")
    if dev.type == "cuda":
        for ci, (_, _, delta) in enumerate(rec.calls):
            if delta != want:
                raise AssertionError(f"{label} serve: batch {ci} launched {delta}, expected {want}")
        if counts != {k: v * batches for k, v in want.items()}:
            raise AssertionError(f"{label} serve: launches {counts} for {batches} batches")
    served = low + res
    n = check_served(label, eng, rec, served, strict=not eng.bf16_boundary)
    del rec
    log(f"{label} serve: checked window: {len(served)} requests, {batches} device batches, each "
        f"launching {want}; every served row bitwise equal to its device batch's, the engine "
        f"again on each batch bitwise equal" + (f", {n} requests bitwise equal to the engine on "
                                                f"their images alone" if n else ""))
    check_pipeline(label, eng, server, clients)

    # the measured windows: the bare engine, nothing recorded
    srv = server(eng, name=f"serve-{label}")
    rounds = [reqs * SERVE_ROUNDS for reqs in clients]
    profiled = []

    def rows():  # rows the card computed so far, bucket padding included
        return srv.stats["images"] + srv.stats["padded"]

    def profiled_round():
        r0 = rows()
        profiled.append(run_clients(srv, clients) + (rows() - r0,))

    reset_launches()
    try:
        srv.start()
        run_clients(srv, clients)  # warm-up: pinned buffers, the allocator's first blocks
        _, low = run_clients(srv, [trickle])
        r0 = rows()
        wall, res = run_clients(srv, rounds)
        measured_rows = rows() - r0
        if dev.type == "cuda":  # profile() runs its own warm-up round first
            ka = profile(profiled_round)
    finally:
        srv.stop()
    check_stopped(srv, "measured windows")
    if dev.type == "cuda" and launches() != {k: v * srv.stats["batches"] for k, v in want.items()}:
        raise AssertionError(f"{label} serve: launches {launches()} for {srv.stats['batches']} "
                             f"batches of the bare engine")
    images = sum(len(r[0]) for r in res)
    p50, p99 = latency_ms(res)
    log(f"{label} serve: measured window (bare IntEngine, after a warm-up window): "
        f"{SERVE_CLIENTS} closed-loop clients x {SERVE_ROUNDS} rounds, {len(res)} requests, "
        f"{images} images in {wall:.3f} s: {images / wall:.1f} images/s, latency p50 {p50:.3f} ms "
        f"p99 {p99:.3f} ms max {1e3 * max(r[2] for r in res):.3f} ms; max_wait_ms {SERVE_WAIT_MS}, "
        f"buckets {SERVE_BUCKETS} ({card})")
    t50, t99 = latency_ms(low)
    log(f"{label} serve: one client of single images (bare IntEngine): p50 {t50:.3f} ms p99 "
        f"{t99:.3f} ms ({card})")
    if dev.type == "cuda":
        pwall, pres, prows = profiled[-1]
        device_s = sum(e.self_device_time_total for e in ka) / 1e6
        log(f"{label} serve: device busy share while serving {device_s / prows * measured_rows / wall:.3f} "
            f"in the measured window ({measured_rows} rows computed; {1e3 * device_s / prows:.5f} "
            f"device ms per row in one round under torch.profiler, which itself ran "
            f"{sum(len(r[0]) for r in pres) / pwall:.1f} images/s at a busy share of "
            f"{device_s / pwall:.3f}) ({card})")
    log(f"{label} serve: stats of the measured server (every window) {srv.stats}")
    return counts


def export_phase(model, plan, int_params, eng: IntEngine, images, card: str):
    """The export phase (module docstring) on the bake phase's ResNet-18."""
    x = eng.condition_input(images[:2])
    want = eng(x).cpu()
    side = images.shape[1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = export_torchscript(model, plan, int_params, f"{tmp}/resnet18_int.pt",
                                  image_size=side)
        t1 = time.perf_counter()
        ts = torch.jit.load(path, map_location="cpu")
        with torch.no_grad():
            got = ts(x.cpu().permute(0, 3, 1, 2).to(torch.int32))
        t2 = time.perf_counter()
        if not torch.equal(got, want):
            raise AssertionError(f"export: the TorchScript's logits differ from the card's strict "
                                 f"engine's (max {float((got - want).abs().max())})")
        log(f"export: TorchScript at {side} px bitwise equal to the card's strict engine on 2 "
            f"images; trace and save {t1 - t0:.3f} s, load and run on the CPU {t2 - t1:.3f} s "
            f"wall ({card}; {torch.get_num_threads()} CPU threads)")
        bundle = load_native_bundle(save_native_bundle(f"{tmp}/resnet18.f8nb", model, plan,
                                                       int_params))
    for rec, p in zip(bundle["layers"], plan.layers, strict=True):
        entry = {k: v.cpu().numpy() for k, v in int_params[p.name].items()}
        if ((rec["input_fl"], rec["weight_fl"], rec["symmetric"])
                != (p.input_fl, p.weight_fl, p.input_symmetric)
                or not np.array_equal(rec["w"], entry["w"])
                or not np.array_equal(rec["b"], entry.get("b"))):
            raise AssertionError(f"export: F8NB layer {p.name} differs from the plan")
    log(f"export: F8NB bundle read back, all {len(plan.layers)} layers' fraclens, weights and "
        f"biases equal to the plan's")


# -- train ----------------------------------------------------------------------


@contextlib.contextmanager
def patched(module, name, value):
    """module.name replaced by value within the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def train_yaml(tmp: str, name: str, source: str, **over) -> str:
    """`source` (a repository config, its !include resolved) with the train
    phase's changes: the synthetic dataset, a log directory under `tmp`, no
    experiment subdirectory, TRAIN_EPOCHS epochs of TRAIN_SYNTHETIC images,
    TRAIN_WORKERS loader threads; then TRAIN_OVERRIDES and `over`.  Returns
    the written YAML's path."""
    d = load_yaml(os.path.join(REPO, source))
    d.update(dataset="synthetic", log_dir=os.path.join(tmp, "log"), experiment_subdir=False,
             num_epochs=TRAIN_EPOCHS, synthetic_size=TRAIN_SYNTHETIC,
             data_loader_workers=TRAIN_WORKERS)
    d.update(TRAIN_OVERRIDES, **over)
    path = os.path.join(tmp, f"{name}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


def run_cli(label: str, argv, device):
    """run.main(argv) with its standard output captured; logs its lines but
    the fraclen report's (counted).  Returns (result, printed lines, wall s)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = cli.main(argv, device=device)
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    report = [ln for ln in lines if ln.startswith(REPORT_KEYS)]
    for ln in lines:
        if not ln.startswith(REPORT_KEYS):
            log(f"train: {label} | {ln}")
    log(f"train: {label} | ... fraclen report: {len(report)} lines, "
        f"{sum(ln.startswith('layer name:') for ln in report)} layers")
    return result, lines, wall


def val_loader(cfg, tcfg, extras):
    """The CLI's val loader for these flags (run.datasets, run.make_loader)."""
    return cli.make_loader(cli.datasets(tcfg, extras)[1], False, cfg, tcfg, extras)


def recording_engine(calls: list):
    """An IntEngine.__call__ that appends (int_only, input, logits), both
    copied to the host, to `calls` and returns the logits."""
    call = IntEngine.__call__

    def wrapper(self, x):
        y = call(self, x)
        calls.append((self.int_only, x.detach().cpu().clone(), y.detach().cpu().clone()))
        return y
    return wrapper


def same_trees(what: str, got, want) -> None:
    """Two {layer: {name: tensor or array}} trees bitwise equal."""
    if list(got) != list(want):
        raise AssertionError(f"train: {what}: layers differ")
    for lname, sub in want.items():
        if set(got[lname]) != set(sub):
            raise AssertionError(f"train: {what}: {lname}'s entries differ")
        for k, v in sub.items():
            a = got[lname][k]
            a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            if a.dtype != v.dtype or not np.array_equal(a, v):
                raise AssertionError(f"train: {what}: {lname}/{k} differs")


def overfit_step(trainer, params, state, opt, images, labels):
    """Step 1: OVERFIT_STEPS train steps on one fixed batch (constant lr, no
    weight decay); every loss logged; the last must lie below the first."""
    losses = []
    for i in range(OVERFIT_STEPS):
        params, state, opt, res = trainer.run_epoch(params, state, opt, [(images, labels)], i,
                                                    1, "train")
        losses.append(res["loss"])
    log(f"train: overfit {len(labels)} images with random labels, {OVERFIT_STEPS} steps at lr "
        f"{trainer.tcfg.lr}, losses " + " ".join(f"{v:.4f}" for v in losses))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the overfit loss did not fall ({losses[0]} -> {losses[-1]})")
    return params, state, opt


def update_rule_step(model, trainer, params, state, opt, images, labels) -> None:
    """Step 2: one sgd_update of the model's real params, gradients (one
    backward on the card) and momentum, on the card and on CPU copies:
    bitwise equal."""
    dev = trainer.device
    x = train_loop.condition_input(images, trainer.cfg)
    for sub in params.values():
        for p in sub.values():
            p.requires_grad_(True)
    with float32_exact():
        logits, _ = model.forward(params, state, x, "train", trainer.cfg)
        train_loop.cross_entropy_loss(logits, labels).backward()
    grads = {l: {k: p.grad.detach().clone() for k, p in sub.items() if p.grad is not None}
             for l, sub in params.items()}
    new = {l: {k: p.detach().clone() for k, p in sub.items()} for l, sub in params.items()}
    for sub in params.values():
        for p in sub.values():
            p.grad = None
            p.requires_grad_(False)
    mom = {l: {k: b.clone() for k, b in sub.items()} for l, sub in opt.momentum.items()}
    def cpu(tree):  # copies, also of CPU tensors (the CPU rehearsal)
        return {l: {k: v.to("cpu", copy=True) for k, v in sub.items()} for l, sub in tree.items()}

    cpu_p, cpu_g, cpu_m = cpu(new), cpu(grads), cpu(mom)
    mask = weight_decay_mask(model.graph, new, "all", 4e-5)
    sgd_update(new, grads, SGDState(mom), 0.05, mask, 0.9, True)
    sgd_update(cpu_p, cpu_g, SGDState(cpu_m), 0.05, mask, 0.9, True)
    same_trees("sgd_update params, card against CPU", new, cpu_p)
    same_trees("sgd_update momentum, card against CPU", mom, cpu_m)
    n = sum(t.numel() for sub in new.values() for t in sub.values())
    moved = sum(int((a != params[l][k]).sum()) for l, sub in new.items() for k, a in sub.items())
    log(f"train: sgd_update (nesterov, wd 4e-5, lr 0.05) of {model.name}'s {n} params on {dev} "
        f"bitwise equal to the CPU's, params and momentum; {moved} params moved")


# kernel names by kind, the first match wins
CONV_KIND = "convolutions and GEMMs (cuDNN, cuBLAS)"
KERNEL_KINDS = (("layout conversions", ("nhwctonchw", "nchwtonhwc")),
                (CONV_KIND, ("xmma", "cudnn", "gemm", "cutlass")),
                ("reductions", ("reduce",)), ("elementwise and other", ("",)))


def by_kind(ka) -> dict:
    """{kind: [device ms, kernels]} of profiler key_averages, by KERNEL_KINDS."""
    out = {name: [0.0, 0] for name, _ in KERNEL_KINDS}
    for e in ka:
        if e.self_device_time_total <= 0:
            continue
        name = next(n for n, keys in KERNEL_KINDS if any(k in e.key.lower() for k in keys))
        out[name][0] += e.self_device_time_total / 1e3
        out[name][1] += e.count
    return out


def time_train_step(model, trainer, params, state, opt, card: str) -> float:
    """Wall ms per train step at batch TRAIN_BATCH (CUDA-synchronised host
    clock, TRAIN_TIMED_STEPS steps), images/s and peak device memory; one
    step's convolution and GEMM FLOPs as autograd ran them, forward and
    backward (torch.utils.flop_counter), beside model_flops' forward (one
    conv per layer) and over the step's conv and GEMM device ms; the
    device-busy share: one profiled step's kernel ms over the median step's
    wall ms.  Returns the median step's images/s."""
    from torch.utils.flop_counter import FlopCounterMode

    side = trainer.tcfg.image_size
    g = torch.Generator().manual_seed(3)
    images = torch.rand((TRAIN_BATCH, side, side, 3), generator=g).to(trainer.device)
    labels = torch.randint(0, model.num_classes, (TRAIN_BATCH,), generator=g).to(trainer.device)
    def step():
        trainer.train_step(params, state, opt, images, labels, 1e-4)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = statistics.median(walls)
    q1, _, q3 = statistics.quantiles(walls, n=4)
    counter = FlopCounterMode(display=False)
    with counter:
        step()
    flops = counter.get_total_flops()
    by_op = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ka = [e for e in prof.key_averages() if e.self_device_time_total > 0]  # the card's work
    busy = sum(e.self_device_time_total for e in ka) / 1e3
    top = sorted(ka, key=lambda e: -e.self_device_time_total)[:6]
    log(f"train: step at batch {TRAIN_BATCH}, {side} px: {ms:.2f} ms wall (median of "
        f"{TRAIN_TIMED_STEPS}; quartiles {q1:.2f} / {q3:.2f}, min {min(walls):.2f}, max "
        f"{max(walls):.2f}: " + " ".join(f"{w:.2f}" for w in walls) + f"), "
        f"{TRAIN_BATCH / ms * 1e3:.1f} images/s; peak memory {peak:.3f} GiB; profiled step: "
        f"{busy:.2f} device ms, device-busy share {busy / ms:.3f} of the median step's wall "
        f"({busy / wall:.3f} of the profiled step's own {wall:.2f} ms, which the profiler "
        f"slows); {sum(e.count for e in ka)} kernels and copies ({card})")
    for e in top:
        log(f"  train step device time: {e.key[:70]} {e.self_device_time_total / 1e3:.3f} ms "
            f"x{e.count}")
    by_group = by_kind(ka)
    log("train: step device ms by kind: " + "; ".join(
        f"{name} {kms:.2f} ms in {n} kernels" for name, (kms, n) in by_group.items()))
    conv_ms = by_group[CONV_KIND][0]
    rate = flops / (conv_ms * 1e-3)
    log(f"train: the step's convolutions and GEMMs, forward and backward, as autograd ran them: "
        f"{flops / 1e12:.4f} TFLOP ({by_op}); model_flops' forward "
        f"{model_flops(model, side, TRAIN_BATCH) / 1e12:.4f} TFLOP; over their {conv_ms:.2f} "
        f"device ms {rate / 1e12:.2f} TFLOP/s, "
        f"{rate / H100_PEAK_OPS['float32']:.3f} of the H100's 67 TFLOP/s float32 dense peak "
        f"({card})")
    return TRAIN_BATCH / ms * 1e3


def jpeg_tree(root: str, n: int, classes: int, seed: int) -> str:
    """An ImageFolder tree of `n` JPEG files (quality 90) of LOADER_IMAGE
    (width, height) px, ImageNet's typical size: smooth random images (a
    16 x 12 colour field resized up) with noise, so they compress about as
    photographs do.  Written on threads; returns `root`."""
    from concurrent.futures import ThreadPoolExecutor

    w, h = LOADER_IMAGE
    rng = np.random.RandomState(seed)
    noise = rng.randint(-12, 13, (h + 64, w + 64, 3)).astype(np.int16)
    fields = rng.randint(0, 256, (n, 12, 16, 3)).astype(np.uint8)
    shifts = rng.randint(0, 64, (n, 2))
    for c in range(classes):
        os.makedirs(os.path.join(root, f"c{c:03d}"), exist_ok=True)

    def write(i):
        base = np.asarray(Image.fromarray(fields[i]).resize((w, h), Image.BILINEAR), np.int16)
        dy, dx = shifts[i]
        img = np.clip(base + noise[dy:dy + h, dx:dx + w], 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"c{i % classes:03d}", f"{i:05d}.jpg"),
                                  quality=90)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(n)))
    return root


def loader_rates(ld) -> list:
    """images/s of LOADER_EPOCHS epochs of `ld`, each timed from the arrival
    of its first round of batches (one per worker: thread start-up and the
    first decodes excluded) to its last."""
    rates = []
    for epoch in range(LOADER_EPOCHS):
        ld.set_epoch(epoch)
        batches = iter(ld)
        for _ in range(ld.workers):
            next(batches)
        t0 = time.perf_counter()
        n = sum(len(labels) for _, labels in batches)
        rates.append(n / (time.perf_counter() - t0))
    return rates


def time_loader(cfg, tcfg, step_rate: float, card: str) -> None:
    """The train Loader alone (no step) on its native path and on its PIL
    path, at the config's size, over one JPEG ImageFolder tree of
    TRAIN_BATCH * LOADER_BATCHES images of LOADER_IMAGE px: LOADER_EPOCHS
    epochs each (loader_rates), TRAIN_WORKERS workers with
    LOADER_DECODE_THREADS decode threads each; beside the train step's
    images/s.  The native library must build (a build failure raises) and
    the native Loader must take it."""
    lib = native_ops.load()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ds = data.ImageFolderDataset(jpeg_tree(tmp, TRAIN_BATCH * LOADER_BATCHES, 16, 1))
        made = time.perf_counter() - t0
        kw = dict(batch_size=TRAIN_BATCH, train=True, normalize=cfg.normalize,
                  image_size=tcfg.image_size, num_workers=TRAIN_WORKERS, seed=1,
                  decode_threads=LOADER_DECODE_THREADS)
        nat = data.Loader(ds, **kw)
        native_rates = loader_rates(nat)
        if nat.path == "pil":
            raise AssertionError("train: the Loader did not take its native path")
        pil = data.Loader(ds, **kw)
        with patched(native_mod, "imageops_available", lambda: False):
            pil_rates = loader_rates(pil)
        if pil.path != "pil":
            raise AssertionError(f"train: the PIL Loader took its {pil.path} path")
    decode = ("libjpeg on native threads" if nat.path == "native_jpeg"
              else "PIL (the native library was built without libjpeg: this host has no "
                   "jpeglib.h or libjpeg.so)")
    for name, rates in ((f"native path ({nat.path}: decode by {decode}; crop, resize, flip in "
                         f"C++, {lib._name.rsplit('/', 1)[-1]})", native_rates),
                        ("PIL path", pil_rates)):
        log(f"train: Loader {name}, train transform to {tcfg.image_size} px, {TRAIN_WORKERS} "
            f"workers x {LOADER_DECODE_THREADS} decode threads, {LOADER_EPOCHS} epochs of "
            f"{LOADER_BATCHES} batches of {TRAIN_BATCH}, the first {TRAIN_WORKERS} of each "
            f"untimed: " + " ".join(f"{r:.1f}" for r in rates) + f" images/s, "
            f"{min(rates) / step_rate:.2f}-{max(rates) / step_rate:.2f}x the step's median "
            f"{step_rate:.1f}")
    log(f"train: Loader native / PIL per epoch: "
        + " ".join(f"{a / b:.2f}" for a, b in zip(native_rates, pil_rates))
        + f"; {TRAIN_BATCH * LOADER_BATCHES} JPEGs of {LOADER_IMAGE[0]}x{LOADER_IMAGE[1]} px "
        f"written in {made:.1f} s ({os.cpu_count()} host cores; {card})")


def train_phase(seed: int, card: str, device="cuda"):
    """The training path (module docstring): returns {kernel: launches} of
    the CLI's int_op_only run and (engine, checked calls) of chip_smoke's
    own engine on the trained checkpoint."""
    dev = torch.device(device)
    with tempfile.TemporaryDirectory() as tmp:
        cfg, tcfg, extras = from_flags(load_yaml(train_yaml(tmp, "train", TRAIN_CONFIG)),
                                       TRAIN_BATCH)
        model = get_model("resnet18", cfg, num_classes=tcfg.num_classes,
                          image_size=tcfg.image_size)
        log(f"train: {TRAIN_CONFIG} at batch {TRAIN_BATCH}: {tcfg.num_classes} classes, "
            f"{tcfg.image_size} px, lr {tcfg.lr} {tcfg.lr_scheduler}, momentum {tcfg.momentum} "
            f"nesterov {tcfg.nesterov}, wd {tcfg.weight_decay} ({tcfg.weight_decay_scheme})")
        # 1. overfit the CLI's val images (random labels); the CLI starts
        # from these weights (fp_pretrained_file)
        trainer = train_loop.Trainer(
            model, cfg, tcfg.replace(lr=OVERFIT_LR, lr_scheduler="constant", weight_decay=0.0),
            log=lambda *a: None, device=dev)
        params, state, opt = trainer.init(torch.Generator().manual_seed(seed))
        images, labels = next(iter(val_loader(cfg, tcfg, extras)))  # the whole val set
        images, labels = torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev)
        params, state, opt = overfit_step(trainer, params, state, opt, images, labels)
        # a val error below 1 whatever the CLI's first step (at the config's
        # lr, on images these weights never saw) does, so the CLI writes a
        # best_model: the classifier's bias for the first val image's label
        # lifted by BIAS_LIFT, so every image is given that class
        with torch.no_grad():
            params["classifier"]["bias"][labels[0]] += BIAS_LIFT
        # 2. the update rule on the card against the CPU
        update_rule_step(model, trainer, params, state, opt, images, labels)
        init = save_checkpoint(os.path.join(tmp, "overfit"), {"params": params, "state": state})
        if dev.type == "cuda":  # on other weights from here
            time_loader(cfg, tcfg, time_train_step(model, trainer, params, state, opt, card), card)
        del trainer, params, state, opt
        train_cfg = train_yaml(tmp, "train", TRAIN_CONFIG, fp_pretrained_file=init)

        # 3. the CLI trains an epoch from those weights; every save recorded
        saved = {}

        class Recording(train_ckpt.AsyncCheckpointer):
            def save(self, path, trees, meta=None):
                saved[path if path.endswith(".npz") else path + ".npz"] = {
                    n: {l: {k: t.detach().clone() for k, t in sub.items()}
                        for l, sub in tree.items()} for n, tree in trees.items()}
                return super().save(path, trees, meta)

        walls = {}
        with patched(train_mod, "AsyncCheckpointer", Recording):
            _, lines, walls["train"] = run_cli("train", [f"app:{train_cfg}", f"bs:{TRAIN_BATCH}"],
                                               dev)
        log_dir = os.path.join(tmp, "log")
        for name in ("latest_checkpoint", "best_model"):
            path = os.path.join(log_dir, f"{name}.npz")
            if not os.path.exists(path):
                raise AssertionError(f"train: the CLI wrote no {name}")
            trees, _ = load_checkpoint(path)
            for tree, want in saved[path].items():
                same_trees(f"{name} file against the CLI's {tree} at its save", trees[tree], want)
        if "Start training." not in lines or not any(ln.startswith("layer name: ") for ln in lines):
            raise AssertionError("train: the CLI's train run printed no training or report")
        log("train: the CLI, started from the overfit weights (fp_pretrained_file), wrote "
            "latest_checkpoint and best_model, each bitwise equal to the tensors it held when it "
            "saved them")

        # 4. resume: one epoch more; what it loads equal to the file
        loaded = []

        def recording(fn):  # copies: the resumed run trains its tensors in place
            def wrapper(*a, **kw):
                out = fn(*a, **kw)
                copy = lambda t: {l: {k: v.clone() for k, v in sub.items()} for l, sub in t.items()}
                loaded.append(tuple(map(copy, out)) if isinstance(out, tuple) else copy(out))
                return out
            return wrapper

        resume_cfg = train_yaml(tmp, "resume", TRAIN_CONFIG, num_epochs=TRAIN_EPOCHS + 1,
                                fp_pretrained_file=init)
        with patched(export_mod, "qat_from_numpy", recording(export_mod.qat_from_numpy)), \
                patched(export_mod, "tensors_from_numpy", recording(export_mod.tensors_from_numpy)):
            _, lines, walls["resume"] = run_cli("resume", [f"app:{resume_cfg}",
                                                           f"bs:{TRAIN_BATCH}"], dev)
        want = f"Loaded checkpoint {log_dir} at epoch {TRAIN_EPOCHS}."
        if want not in lines:
            raise AssertionError(f"train: the resumed run did not print {want!r}")
        trees, _ = load_checkpoint(os.path.join(log_dir, "latest_checkpoint"))
        # loaded: the fp_pretrained_file's (params, state), then the
        # checkpoint's (params, state) and momentum; the file now holds
        # epoch 2, so hold what was loaded against the epoch-1 save
        first = saved[os.path.join(log_dir, "latest_checkpoint.npz")]
        same_trees("resumed params", loaded[1][0], first["params"])
        same_trees("resumed state", loaded[1][1], first["state"])
        same_trees("resumed momentum", loaded[2], first["opt_momentum"])
        log(f"train: resumed at epoch {TRAIN_EPOCHS}: the params, state and momentum it loaded "
            f"bitwise equal to those saved")

        # 5. bn-calibration on the checkpoint
        calib_cfg = train_yaml(tmp, "calib", TRAIN_CONFIG, num_epochs=TRAIN_EPOCHS + 1,
                               bn_calib_before_test=True, bn_calib_batch_num=1)
        _, lines, walls["bn_calib"] = run_cli("bn_calib", [f"app:{calib_cfg}",
                                                           f"bs:{TRAIN_BATCH}"], dev)
        if "Start calibration." not in lines or not os.path.exists(
                os.path.join(log_dir, "best_model_bn_calibrated.npz")):
            raise AssertionError("train: the bn-calibration phase did not run")

        # 6. the int_op_only phase on the trained checkpoint, through the
        # kernels; chip_smoke's own engine on the same bake and val loader
        best = os.path.join(log_dir, "best_model.npz")
        int_cfg = train_yaml(tmp, "int", INT_CONFIG, pretrained_file=best,
                             int_op_only_file_path=os.path.join(tmp, "export"))
        cli_calls = []  # the CLI engine's (int_only, input, logits)
        reset_launches()
        with patched(IntEngine, "__call__", recording_engine(cli_calls)):
            result, lines, walls["int_op_only"] = run_cli("int_op_only", [f"app:{int_cfg}",
                                                                          f"bs:{TRAIN_BATCH}"], dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        cli_launches = launches()
        printed = [ln for ln in lines if ln.startswith("test\t-1/")]
        icfg, itcfg, iextras = from_flags(load_yaml(int_cfg), TRAIN_BATCH)
        imodel = get_model("resnet18", icfg, num_classes=itcfg.num_classes,
                           image_size=itcfg.image_size)
        trees, _ = load_checkpoint(best)
        plan, int_params = bake_plan(imodel, *export_mod.qat_from_numpy(
            trees["params"], trees["state"], device=dev))
        eng = IntEngine(imodel, plan, int_params, device=dev)
        total, correct = 0, 0
        vbatches = list(val_loader(icfg, itcfg, iextras))
        if len(cli_calls) != len(vbatches) or not all(io for io, _, _ in cli_calls):
            raise AssertionError(f"train: the CLI's int_op_only made {len(cli_calls)} integer "
                                 f"engine calls over {len(vbatches)} val batches")
        for (vimages, vlabels), (_, cli_x, cli_y) in zip(vbatches, cli_calls):
            x = eng.condition_input(vimages)
            y = eng(x)
            if not torch.equal(x.cpu(), cli_x) or not torch.equal(y.cpu(), cli_y):
                raise AssertionError("train: the CLI's int_op_only engine parts from chip_smoke's "
                                     "on the same bake: input or logits differ")
            correct += int((y.argmax(1).cpu() == torch.from_numpy(vlabels).long()).sum())
            total += len(vlabels)
        mine = f"test\t-1/{itcfg.num_epochs}: top1_error: {1 - correct / max(total, 1):.3f}"
        if printed != [mine] or abs(result["top1_error"] - (1 - correct / total)) > 0:
            raise AssertionError(f"train: the CLI's int_op_only printed {printed}; chip_smoke's "
                                 f"engine on the same bake gives {mine!r}")
        want = {name: LAUNCHES_PER_FORWARD["resnet18"].get(name, 0) * len(vbatches)
                for name in KERNELS}
        if dev.type == "cuda" and cli_launches != want:
            raise AssertionError(f"train: the CLI's int_op_only launched {cli_launches}, "
                                 f"expected {want}")
        log(f"train: the CLI's int_op_only engine: its input and logits on each of its "
            f"{len(cli_calls)} val batches bitwise equal to chip_smoke's engine on the same "
            f"bake and val loader; its top-1 error {result['top1_error']:.3f} over {total} "
            f"images (every image given the lifted bias's class); its launches {cli_launches}")
        vimages = torch.from_numpy(np.concatenate([b[0] for b in vbatches])).to(dev)
        _, counts, checked = drive("resnet18 trained", "resnet18", eng, vimages,
                                   log_calls=False, gate=False)

        # 7. the parity dry run on the card: integize's logits equal to
        # int_op_only's
        parity_calls = []  # (int_only, input, logits) of both engines, batch by batch
        t0 = time.perf_counter()
        with patched(IntEngine, "__call__", recording_engine(parity_calls)):
            results, n, _ = parity.evaluate_parity(
                "resnet18", synthetic=True, image_size=tcfg.image_size, batch_size=PARITY_BATCH,
                limit_batches=2, num_classes=tcfg.num_classes, seed=seed, device=dev)
        walls["parity"] = time.perf_counter() - t0
        sims = [y for io, _, y in parity_calls if not io]
        ints = [y for io, _, y in parity_calls if io]
        if len(sims) != 2 or len(ints) != 2 or sum(len(y) for y in ints) != n:
            raise AssertionError(f"train: parity made {len(sims)} integize and {len(ints)} "
                                 f"int_op_only calls over {n} images")
        differ = [int((a != b).sum()) for a, b in zip(sims, ints)]
        if any(differ) or results["integize"] != results["int_op_only"]:
            raise AssertionError(f"train: parity integize parts from int_op_only: {differ} "
                                 f"logits differ per batch; {results}")
        log(f"train: parity dry run over {n} images: integize's logits bitwise equal to "
            f"int_op_only's on every image ({sum(y.numel() for y in ints)} logits); top-1 / "
            f"top-5 of the random weights (a log): " + ", ".join(
                f"{m} {r['top1']:.2f} / {r['top5']:.2f}" for m, r in results.items()))
    log("train: wall s per phase: " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
        + f" ({card})")
    return cli_launches, counts, checked


# -- dp -------------------------------------------------------------------------


def free_port() -> int:
    """A free localhost port below the kernel's ephemeral range: the other
    ranks connect to rank 0's port before it listens, and a connection
    from an ephemeral port can take that port itself (a TCP self-connect:
    rank 0's bind then fails with EADDRINUSE)."""
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        first = int(f.read().split()[0])
    for _ in range(100):
        port = random.randrange(max(1024, first - 10000), first)
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError(f"no free port below {first}")


def spawn_ranks(target, world: int, settings: dict, what: str, timeout: float = MP_TIMEOUT):
    """Starts target(rank, world, port, settings) in `world` spawned
    processes, the group's address on a free localhost port.  Returns
    wait(), which waits for them (killing the rest once one has failed,
    or all still alive after `timeout` s), raises unless every one exited
    0, and gives what each wrote to settings["out"]/rank<r>.pt."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, settings)) for r in range(world)]
    for p in procs:
        p.start()

    def wait() -> list:
        deadline = time.monotonic() + timeout
        while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
               and not any(p.exitcode for p in procs)):
            time.sleep(0.2)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        if alive or any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"{what}: rank exit codes {[p.exitcode for p in procs]}")
        return [torch.load(os.path.join(settings["out"], f"rank{r}.pt"), weights_only=False)
                for r in range(world)]

    return wait


def dp_global_batch(seed: int, n: int, side: int, classes: int):
    """The dp phase's global batch, drawn on the host from `seed`."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, side, side, 3), generator=g),
            torch.randint(0, classes, (n,), generator=g, dtype=torch.int32))


def host_tree(tree):
    return {l: {k: v.detach().to("cpu", copy=True) for k, v in sub.items()}
            for l, sub in tree.items()}


def tree_digest(tree) -> dict:
    """{layer: {name: sha256 of the tensor's bytes}}: bitwise equality of
    trees across processes without moving them."""
    import hashlib

    return {l: {k: hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()
                for k, v in sub.items()} for l, sub in tree.items()}


def dp_steps(settings: dict, device, group=None, rank: int = 0, world: int = 1,
             kinds=("floating_wo_clip", "qat"), dtype=torch.float32, nudge: bool = False) -> dict:
    """One floating_wo_clip and one QAT train step of ResNet-18 from
    `settings["yaml"]`'s config, each from the init of settings["seed"], on
    this rank's contiguous shard of the global batch (all of it without a
    group); {kind: (params, state, momentum, metrics)} on the host.  `dtype`:
    the params', state's and images' type; `nudge`: every image element
    one ulp up (the QAT step's sensitivity)."""
    from f8net_tpu_torch.parallel import shard_batch

    cfg, tcfg, _ = from_flags(load_yaml(settings["yaml"]), settings["batch"])
    images, labels = dp_global_batch(settings["seed"] + 1, settings["batch"], tcfg.image_size,
                                     tcfg.num_classes)
    if nudge:
        images = torch.nextafter(images, torch.tensor(2.0))
    x = shard_batch(images, rank, world).to(device, dtype)
    y = shard_batch(labels, rank, world).to(device)
    cast = lambda tree: {l: {k: v.to(dtype) for k, v in sub.items()} for l, sub in tree.items()}
    out = {}
    for kind, kcfg in (("floating_wo_clip", cfg.replace(floating_wo_clip=True)), ("qat", cfg)):
        if kind not in kinds:
            continue
        model = get_model("resnet18", kcfg, num_classes=tcfg.num_classes,
                          image_size=tcfg.image_size)
        params, state = map(cast, model.init(torch.Generator().manual_seed(settings["seed"]),
                                             device=device))
        step = train_loop.make_train_step(model, kcfg, tcfg, group)
        params, state, opt, m = step(params, state, train_mod.sgd_init(params), x, y, DP_LR)
        out[kind] = (host_tree(params), host_tree(state), host_tree(opt.momentum),
                     {k: float(v) for k, v in m.items()})
    return out


def dp_rank(rank: int, world: int, port: int, settings: dict) -> None:
    """One rank of the dp phase, in a process of its own (spawned): joins
    the group over settings["backend"] (gloo: on card 0, which the ranks
    share; NCCL: on the card init_dist picks), runs dp_steps on its shard,
    then the CLI's train, resumed and int_op_only runs; writes what it saw
    to settings["out"]/rank<r>.pt."""
    from f8net_tpu_torch.parallel import data_group, init_dist

    device = torch.device(settings["device"])
    if device.type == "cuda" and settings["backend"] == "gloo":
        torch.cuda.set_device(0)
    torch.set_num_threads(settings["threads"])
    init_dist(f"tcp://127.0.0.1:{port}", rank, world, backend=settings["backend"])
    try:
        group = data_group()
        card = torch.cuda.current_device() if device.type == "cuda" else None
        res = {"steps": dp_steps(settings, device, group, rank, world), "card": card}
        writes, loaded, trained = [], [], []
        write, run_epoch, from_numpy = (train_ckpt._write, train_loop.Trainer.run_epoch,
                                        export_mod.qat_from_numpy)

        def recording_write(path, flat, meta):
            writes.append(os.path.basename(path))
            return write(path, flat, meta)

        def recording_epoch(self, *a, **kw):
            out = run_epoch(self, *a, **kw)
            if (a[6] if len(a) > 6 else kw.get("phase", "train")) == "train":
                trained.append(tree_digest(out[0]))
            return out

        def recording_load(*a, **kw):
            out = from_numpy(*a, **kw)
            loaded.append([tree_digest(t) for t in out])
            return out

        printed = []
        with patched(train_ckpt, "_write", recording_write), \
                patched(train_loop.Trainer, "run_epoch", recording_epoch), \
                patched(export_mod, "qat_from_numpy", recording_load):
            for name in ("train", "resume", "int"):
                buf = io.StringIO()
                reset_launches()
                with contextlib.redirect_stdout(buf):
                    result = cli.main([f"app:{settings[name]}", f"bs:{settings['batch']}"],
                                      device=device)
                printed.append(buf.getvalue())
        if device.type == "cuda":
            torch.cuda.synchronize()
        res.update(writes=writes, loaded=loaded, trained=trained, printed=printed,
                   int_result=result, int_launches=launches())
        torch.save(res, os.path.join(settings["out"], f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def step_gaps(got, want, p0) -> dict:
    """How far step result `got` is from `want` (both (params, state,
    momentum, metrics) from the same init p0): the loss's relative gap; per
    tensor, the gap of the BN running statistics, of the update (p0 - p)
    and of the momentum over the reference tensor's largest element, the
    largest over tensors (`update_at`: the tensor of the largest update
    gap); the fraclen EMAs that differ."""
    def worst(a, b, keys=None):
        m, at = 0.0, None
        for l, sub in b.items():
            for k, v in sub.items():
                if keys is None or k in keys:
                    scale = max(float(v.abs().max()), 1e-30)
                    gap = float((a[l][k] - v).abs().max()) / scale
                    m, at = (gap, f"{l}.{k}") if gap > m else (m, at)
        return m, at

    def l2(a, b):  # over all tensors at once
        num = sum(float(((a[l][k].double() - v.double()) ** 2).sum()) for l, sub in b.items()
                  for k, v in sub.items())
        den = sum(float((v.double() ** 2).sum()) for sub in b.values() for v in sub.values())
        return math.sqrt(num / max(den, 1e-300))

    upd = lambda p: {l: {k: p0[l][k].to(v.dtype) - v for k, v in sub.items()}
                     for l, sub in p.items()}
    update, update_at = worst(upd(got[0]), upd(want[0]))
    return dict(
        loss=abs(got[3]["loss"] - want[3]["loss"]) / abs(want[3]["loss"]),
        bn=worst(got[1], want[1], ("bn_mean", "bn_var"))[0],
        update=update, update_at=update_at,
        update_l2=l2(upd(got[0]), upd(want[0])),
        momentum=worst(got[2], want[2])[0],
        ema_differ=sum(not torch.equal(got[1][l]["input_fl_ema"].to(sub["input_fl_ema"].dtype),
                                       sub["input_fl_ema"])
                       for l, sub in want[1].items()),
        top1=(got[3]["top1"], want[3]["top1"]), n=(got[3]["n"], want[3]["n"]))


def dp_phase(seed: int, card: str, device="cuda", world: int = DP_WORLD,
             backend: str = "gloo") -> None:
    """The dp phase (module docstring): `world` ranks that share card 0
    over gloo, or (backend "nccl") each on a card of its own."""
    from f8net_tpu_torch.parallel import get_world_size, init_dist

    t_start = time.perf_counter()
    dev = torch.device(device)
    with tempfile.TemporaryDirectory() as tmp:
        # the ranks read everything from these files (spawned, they see this
        # module's defaults, not a caller's settings)
        settings = dict(
            seed=seed, batch=DP_BATCH, device=str(dev), out=tmp, threads=torch.get_num_threads(),
            yaml=train_yaml(tmp, "dp", TRAIN_CONFIG), train=train_yaml(tmp, "dp_train",
                                                                       TRAIN_CONFIG),
            resume=train_yaml(tmp, "dp_resume", TRAIN_CONFIG, num_epochs=TRAIN_EPOCHS + 1),
            int=train_yaml(tmp, "dp_int", INT_CONFIG,
                           pretrained_file=os.path.join(tmp, "log", "latest_checkpoint.npz"),
                           int_op_only_file_path=os.path.join(tmp, "export")),
            backend=backend)
        wait = spawn_ranks(dp_rank, world, settings, "dp", DP_TIMEOUT)
        # meanwhile the same steps in this process: twice (the run-to-run
        # spread of one process on this device), the float step in float64
        # (what both float32 steps approximate), the QAT step on images one
        # ulp up (how far its chaotic forward moves on its own)
        t0 = time.perf_counter()
        refs = [dp_steps(settings, dev) for _ in range(2)]
        refs.append(dp_steps(settings, dev, kinds=("floating_wo_clip",), dtype=torch.float64))
        refs.append(dp_steps(settings, dev, kinds=("qat",), nudge=True))
        t_ref = time.perf_counter() - t0
        ranks = wait()
        t_ranks = time.perf_counter() - t0
        cards = [r["card"] for r in ranks]
        if dev.type == "cuda" and cards != ([0] * world if backend == "gloo" else
                                            list(range(world))):
            raise AssertionError(f"dp: the ranks ran on cards {cards}")
        how = ("sharing the card over gloo" if backend == "gloo"
               else f"on cards {cards} over {backend}")
        cfg, tcfg, _ = from_flags(load_yaml(settings["yaml"]), DP_BATCH)
        init = get_model("resnet18", cfg, num_classes=tcfg.num_classes,
                         image_size=tcfg.image_size).init(torch.Generator().manual_seed(seed),
                                                          device="cpu")[0]
        for kind in ("floating_wo_clip", "qat"):
            a = ranks[0]["steps"][kind]
            for r, other in enumerate(ranks[1:], 1):
                b = other["steps"][kind]
                for j, what in enumerate(("params", "state", "momentum")):
                    same_trees(f"dp {kind}: rank {r}'s {what} against rank 0's", b[j], a[j])
                if a[3] != b[3]:
                    raise AssertionError(f"dp {kind}: the ranks' metrics differ: {a[3]} {b[3]}")
            text = lambda g: ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                                       for k, v in g.items())
            if kind == "floating_wo_clip":  # held against the float64 step
                ref, against = refs[2][kind], "one process in float64"
                other = f"one process in float32 against it: {text(step_gaps(refs[0][kind], ref, init))}"
            else:  # the chaotic QAT step: against one process in float32
                ref, against = refs[0][kind], "one process"
                other = (f"one process on images one ulp up against it: "
                         f"{text(step_gaps(refs[3][kind], ref, init))}")
            gaps = step_gaps(a, ref, init)
            log(f"dp: {kind} step, {tcfg.image_size} px, global batch {DP_BATCH} over "
                f"{world} ranks {how}: every rank's params, state and "
                f"momentum bitwise equal; against {against} on the global batch: {text(gaps)}; "
                f"{other}; one process against itself (run to run): "
                f"{text(step_gaps(refs[1][kind], refs[0][kind], init))} ({card})")
            limits = DP_LIMITS[kind]
            over = {k: gaps[k] for k in limits if gaps[k] > limits[k]}
            if gaps["ema_differ"] or gaps["n"] != (DP_BATCH, DP_BATCH) or over:
                raise AssertionError(f"dp {kind}: against {against} {gaps}; limits {limits}")
        a = ranks[0]
        for r, b in enumerate(ranks[1:], 1):
            if b["writes"] or any(b["printed"]):
                raise AssertionError(f"dp: rank {r} wrote {b['writes']} or printed")
            if a["trained"] != b["trained"]:
                raise AssertionError(f"dp: rank {r}'s params differ from rank 0's after a CLI "
                                     f"epoch")
            if a["loaded"] != b["loaded"]:
                raise AssertionError(f"dp: rank {r} loaded other tensors than rank 0")
            if a["int_result"] != b["int_result"]:
                raise AssertionError(f"dp: int_op_only's results differ: {a['int_result']} "
                                     f"{b['int_result']}")
        if not {"latest_checkpoint.npz", "int_op_only_model.npz"} <= set(a["writes"]):
            raise AssertionError(f"dp: rank 0 wrote {a['writes']}")
        want = f"Loaded checkpoint {os.path.join(tmp, 'log')} at epoch {TRAIN_EPOCHS}."
        if want not in a["printed"][1]:
            raise AssertionError(f"dp: the resumed CLI did not print {want!r}")
        if len(a["trained"]) != 2 or a["loaded"][0][0] != a["trained"][0]:
            raise AssertionError("dp: the resumed ranks loaded other tensors than were saved")
        n_val = max(TRAIN_SYNTHETIC // 4, 1)
        used = {r: {k: n for k, n in rk["int_launches"].items() if n} for r, rk in
                enumerate(ranks)}
        if a["int_result"]["images"] != n_val or (
                dev.type == "cuda" and not all(
                    {"int8_gemm", "conv_int8", "stem_pool"} <= set(u) for u in used.values())):
            raise AssertionError(f"dp: int_op_only took {a['int_result']}, launches {used}")
        log(f"dp: run.main on {world} ranks (a synthetic epoch of {TRAIN_SYNTHETIC} images at "
            f"global batch {DP_BATCH}, then resumed for one more, then int_op_only on the "
            f"checkpoint): rank 0 alone wrote ({', '.join(sorted(set(a['writes'])))}) and "
            f"printed; the resume loaded the same params and state on every rank, the params "
            f"those saved after the first epoch; every rank's params bitwise equal after each "
            f"epoch; int_op_only's reduced result alike on every rank ({a['int_result']}), "
            f"launches per rank {used}; the ranks' processes {t_ranks:.1f} s wall from their "
            f"start, the one-process steps {t_ref:.1f} s")

        # the CLI at world size 1 through init_dist: NCCL on a card
        backend = "nccl" if dev.type == "cuda" else "gloo"
        init_dist(f"tcp://127.0.0.1:{free_port()}", 0, 1, backend=backend)
        try:
            t0 = time.perf_counter()
            one = train_yaml(tmp, "dp_one", TRAIN_CONFIG, log_dir=os.path.join(tmp, "one"))
            _, lines, _ = run_cli("dp world 1", [f"app:{one}", f"bs:{TRAIN_BATCH}"], dev)
            if (get_world_size() != 1 or "Start training." not in lines
                    or not os.path.exists(os.path.join(tmp, "one", "latest_checkpoint.npz"))):
                raise AssertionError("dp: the CLI at world size 1 did not train and save")
            log(f"dp: run.main at world size 1 in a {torch.distributed.get_backend()} process "
                f"group joined through init_dist: trained an epoch and saved, "
                f"{time.perf_counter() - t0:.1f} s")
        finally:
            torch.distributed.destroy_process_group()
    log(f"dp phase: {time.perf_counter() - t_start:.1f} s wall ({card})")

# -- tpqat ---------------------------------------------------------------------


def timed_steps(step, params, state, opt, x, y, n: int, barrier=None):
    """`n` more train steps on (x, y), each timed alone on the wall clock
    (the card synchronised around it; with `barrier`, every rank starting
    together); (params, state, opt, [ms per step])."""
    walls = []
    for _ in range(n):
        if x.device.type == "cuda":
            torch.cuda.synchronize()
        if barrier is not None:
            barrier()
        t0 = time.perf_counter()
        params, state, opt, _ = step(params, state, opt, x, y, DP_LR)
        if x.device.type == "cuda":
            torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return params, state, opt, walls


def tpqat_mesh(settings: dict, mesh, device) -> dict:
    """One mesh of the tpqat phase on this rank (module docstring): the
    floating_wo_clip and QAT steps with params out-channel sharded
    (param_shardings, shard_params), gathered whole after each (digests
    on every rank, host copies on global rank 0), the mesh's collectives
    per step; settings["timed"] more QAT steps timed; the BN calibration
    (settings["calib"] calib-mode forwards on the mesh), bake_plan on the
    gathered params, IntEngine on the card and TPEngine on the mesh, every
    kernel call of the TP forward against its plain version, its logits
    against the single engine's on this data row."""
    from f8net_tpu_torch.engine import TPEngine
    from f8net_tpu_torch.parallel import gather_params, param_shardings, shard_params
    from f8net_tpu_torch.parallel.mesh import shard_batch

    cfg, tcfg, _ = from_flags(load_yaml(settings["yaml"]), settings["batch"])
    images, labels = dp_global_batch(settings["seed"] + 1, settings["batch"], tcfg.image_size,
                                     tcfg.num_classes)
    x, y = shard_batch(mesh, images).to(device), shard_batch(mesh, labels).to(device)
    lead = torch.distributed.get_rank() == 0
    out = {}
    for kind, kcfg in (("floating_wo_clip", cfg.replace(floating_wo_clip=True)), ("qat", cfg)):
        model = get_model("resnet18", kcfg, num_classes=tcfg.num_classes,
                          image_size=tcfg.image_size)
        params, state = model.init(torch.Generator().manual_seed(settings["seed"]), device=device)
        specs = param_shardings(model.graph, params, mesh, tensor_parallel=True)
        params = shard_params(params, specs, mesh)
        opt = train_mod.sgd_init(params)
        step = train_loop.make_train_step(model, kcfg, tcfg, mesh=mesh)
        mesh.reset_counts()
        params, state, opt, m = step(params, state, opt, x, y, DP_LR)
        counts = dict(mesh.counts)
        whole = (gather_params(params, specs, mesh), state,
                 gather_params(opt.momentum, specs, mesh))
        out[kind] = dict(digests=[tree_digest(t) for t in whole], counts=counts,
                         metrics={k: float(v) for k, v in m.items()},
                         trees=[host_tree(t) for t in whole] if lead else None,
                         cut=sum(v["w"] is not None for v in specs.values()))
    # the QAT model trains on: its steps timed, then calibrated and baked
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params, state, opt, walls = timed_steps(step, params, state, opt, x, y, settings["timed"],
                                            torch.distributed.barrier)
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
    icfg = cfg.replace(quant_bias=True, quant_avgpool=True, pool_fusing=True)
    imodel = get_model("resnet18", icfg, num_classes=tcfg.num_classes, image_size=tcfg.image_size)
    calib = train_loop.make_eval_step(imodel, icfg, tcfg, mode="calib", mesh=mesh)
    state = reset_bn_for_calib(state)
    for _ in range(settings["calib"]):
        state, _ = calib(params, state, x, y)
    plan, int_params = bake_plan(imodel, gather_params(params, specs, mesh), state)
    single = IntEngine(imodel, plan, int_params, device=device)
    xi = single.condition_input(images[:settings["engine_batch"]].to(device))
    want = single(xi).cpu()
    tp = TPEngine(imodel, plan, {n: {k: v.cpu() for k, v in d.items()} for n, d in int_params.items()},
                  mesh, device=device)
    mesh.reset_counts()
    served = checked_forward(tp, shard_batch(mesh, xi))
    served.update(table=tp.launch_table(), collectives=dict(mesh.counts),
                  equal=torch.equal(served["logits"], shard_batch(mesh, want)),
                  distinct=len({tuple(r) for r in want.tolist()}), rows=len(want),
                  plan=[(p.name, p.input_fl, p.weight_fl) for p in plan.layers])
    return dict(steps=out, walls=walls, peak_gib=peak, served=served)


def tpqat_rank(rank: int, world: int, port: int, settings: dict) -> None:
    """One rank of the tpqat phase, in a process of its own (spawned):
    joins the group over settings["backend"] (gloo: on card 0, which the
    ranks share; NCCL: on the card init_dist picks), builds every mesh of
    settings["meshes"] and runs tpqat_mesh on each; writes what it saw to
    settings["out"]/rank<r>.pt."""
    from f8net_tpu_torch.parallel import init_dist, make_mesh

    device = torch.device(settings["device"])
    if device.type == "cuda" and settings["backend"] == "gloo":
        torch.cuda.set_device(0)
    torch.set_num_threads(settings["threads"])
    init_dist(f"tcp://127.0.0.1:{port}", rank, world, backend=settings["backend"])
    try:
        meshes = [make_mesh(d, m, device=device) for d, m in settings["meshes"]]
        card = torch.cuda.current_device() if device.type == "cuda" else None
        res = {"card": card, "meshes": {}}
        for shape, mesh in zip(settings["meshes"], meshes):
            res["meshes"][tuple(shape)] = tpqat_mesh(settings, mesh, mesh.device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        torch.save(res, os.path.join(settings["out"], f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def one_process_qat_walls(settings: dict, device, n: int):
    """The QAT step of the tpqat phase in this process on the global
    batch: one step, then `n` timed; ([ms per step], peak GiB of the
    timed steps, or None on the CPU)."""
    cfg, tcfg, _ = from_flags(load_yaml(settings["yaml"]), settings["batch"])
    images, labels = dp_global_batch(settings["seed"] + 1, settings["batch"], tcfg.image_size,
                                     tcfg.num_classes)
    model = get_model("resnet18", cfg, num_classes=tcfg.num_classes, image_size=tcfg.image_size)
    params, state = model.init(torch.Generator().manual_seed(settings["seed"]), device=device)
    step = train_loop.make_train_step(model, cfg, tcfg)
    x, y = images.to(device), labels.to(device)
    params, state, opt, _ = step(params, state, train_mod.sgd_init(params), x, y, DP_LR)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    walls = timed_steps(step, params, state, opt, x, y, n)[3]
    return walls, (torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda"
                   else None)


def tpqat_phase(seed: int, card: str, device="cuda", world: int = MP_WORLD,
                backend: str = "gloo", meshes=None) -> dict:
    """The tpqat phase (module docstring): `world` ranks that share card 0
    over gloo on a (1, world) mesh, or (backend "nccl") each on a card of
    its own on every mesh of `meshes`.  Returns the TP forwards' launches
    by kernel, summed over ranks and meshes."""
    t_start = time.perf_counter()
    dev = torch.device(device)
    meshes = meshes or [(1, world)]
    with tempfile.TemporaryDirectory() as tmp:
        # the ranks read everything from here (spawned, they see this
        # module's defaults, not a caller's settings)
        settings = dict(seed=seed, batch=DP_BATCH, device=str(dev), out=tmp, backend=backend,
                        threads=torch.get_num_threads(), meshes=meshes,
                        yaml=train_yaml(tmp, "tpqat", TRAIN_CONFIG), timed=TPQAT_TIMED_STEPS,
                        calib=TPQAT_CALIB_STEPS, engine_batch=min(BATCH, DP_BATCH))
        # the references first, in this process on the global batch, as the
        # dp phase holds its ranks: the float step in float64, the QAT step
        # in float32, twice (run to run); then the one-process QAT step timed
        t0 = time.perf_counter()
        refs = [dp_steps(settings, dev) for _ in range(2)]
        refs.append(dp_steps(settings, dev, kinds=("floating_wo_clip",), dtype=torch.float64))
        one_walls, one_peak = one_process_qat_walls(settings, dev, TPQAT_TIMED_STEPS)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = spawn_ranks(tpqat_rank, world, settings, "tpqat")()
        t_ranks = time.perf_counter() - t0
        cfg, tcfg, _ = from_flags(load_yaml(settings["yaml"]), DP_BATCH)
    cards = [r["card"] for r in ranks]
    if dev.type == "cuda" and cards != ([0] * world if backend == "gloo" else list(range(world))):
        raise AssertionError(f"tpqat: the ranks ran on cards {cards}")
    how = ("sharing the card over gloo" if backend == "gloo"
           else f"on cards {cards} over {backend}")
    init = get_model("resnet18", cfg, num_classes=tcfg.num_classes,
                     image_size=tcfg.image_size).init(torch.Generator().manual_seed(seed),
                                                      device="cpu")[0]
    text = lambda g: ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                               for k, v in g.items())
    total = {name: 0 for name in KERNELS}
    for shape in meshes:
        shape = tuple(shape)
        label = f"tpqat (data, model) = {shape}, {world} ranks {how}"
        res = [rk["meshes"][shape] for rk in ranks]
        for kind in ("floating_wo_clip", "qat"):
            a = res[0]["steps"][kind]
            for r, other in enumerate(res[1:], 1):
                b = other["steps"][kind]
                if b["digests"] != a["digests"] or b["metrics"] != a["metrics"]:
                    raise AssertionError(f"{label} {kind}: rank {r}'s gathered params, state, "
                                         f"momentum or metrics differ from rank 0's")
            if kind == "floating_wo_clip":  # held against the float64 step
                ref, against = refs[2][kind], "one process in float64"
            else:  # the chaotic QAT step: against one process in float32
                ref, against = refs[0][kind], "one process"
            gaps = step_gaps((*a["trees"], a["metrics"]), ref, init)
            limits = DP_LIMITS[kind]
            over = {k: gaps[k] for k in limits if gaps[k] > limits[k]}
            counts = a["counts"]
            log(f"{label}: {kind} step, {tcfg.image_size} px, global batch {DP_BATCH}, "
                f"{a['cut']} of {len(init)} layers cut over the model line: every rank's gathered "
                f"params, state and momentum bitwise equal; against {against}: {text(gaps)}; "
                f"one process against itself (run to run): "
                f"{text(step_gaps(refs[1][kind], refs[0][kind], init))}; collectives per step "
                f"(rank 0, Mesh.counts): {counts} ({card})")
            if gaps["ema_differ"] or gaps["n"] != (DP_BATCH, DP_BATCH) or over:
                raise AssertionError(f"{label} {kind}: against {against} {gaps}; limits {limits}")
        one = statistics.median(one_walls)
        for r, rr in enumerate(res):
            peak = "" if rr["peak_gib"] is None else f", peak memory {rr['peak_gib']:.3f} GiB"
            log(f"{label}: rank {r} QAT step wall ms {' '.join(f'{v:.1f}' for v in rr['walls'])} "
                f"(median {statistics.median(rr['walls']):.1f}) against one process's "
                f"{' '.join(f'{v:.1f}' for v in one_walls)} (median {one:.1f}){peak}; "
                f"bytes per step {res[r]['steps']['qat']['counts']} ({card})")
        for r, rr in enumerate(res):
            sv = rr["served"]
            table = {name: sv["table"].get(name, 0) for name in KERNELS}
            if not sv["equal"]:
                raise AssertionError(f"{label} rank {r}: TPEngine's logits differ from "
                                     f"IntEngine's on the TP-trained bake")
            if sv["calls"] != table or (dev.type == "cuda" and sv["launches"] != table):
                raise AssertionError(f"{label} rank {r}: calls {sv['calls']}, launches "
                                     f"{sv['launches']}, its routing's table {table}")
            if sv["plan"] != res[0]["served"]["plan"]:
                raise AssertionError(f"{label} rank {r}: baked another plan than rank 0")
            for name in KERNELS:
                total[name] += sv["launches"][name]
        sv = res[0]["served"]
        log(f"{label}: {TPQAT_TIMED_STEPS} more QAT steps, {TPQAT_CALIB_STEPS} calib forwards on "
            f"the mesh, bake_plan on the gathered params (the same plan on every rank); "
            f"TPEngine on the mesh bitwise equal to IntEngine on one card on every rank "
            f"({sv['distinct']} distinct logit rows of {sv['rows']}); rank 0: {sv['n_calls']} "
            f"kernel calls equal to their plain versions, launches "
            f"{dict((k, v) for k, v in sv['launches'].items() if v)} as its routing's table; "
            f"collectives per forward {sv['collectives']}")
    peak = "" if one_peak is None else f", one process's peak memory {one_peak:.3f} GiB"
    log(f"tpqat phase: {time.perf_counter() - t_start:.1f} s wall (the one-process references "
        f"{t_ref:.1f} s, the ranks {t_ranks:.1f} s){peak} ({card})")
    return total

# -- tp and pp ----------------------------------------------------------------


def mp_payload(forwards, images, paths, timed: bool) -> dict:
    """What the tp and pp phases' ranks read: each path's bundle (plan
    records and int params on the host), its conditioned batch and each
    rung's single-card logits on it; with `timed`, the conditioned batch of
    every timed size too."""
    out = {"paths": {}, "timed": timed}
    for path in paths:
        eng = forwards[(path, None)][0]
        x = eng.condition_input(images[:BATCH])
        logits = {rung: forwards[(path, rung)][0](x).cpu() for rung in (None, *RUNGS)}
        out["paths"][path] = dict(
            image_size=32 * eng.model.pool_kernel, num_classes=eng.model.num_classes,
            records=[(p.name, p.input_fl, p.weight_fl, p.input_symmetric) for p in eng.plan.layers],
            params={n: {k: v.cpu() for k, v in d.items() if k in ("w", "b")}
                    for n, d in eng.params.items()},
            x=x.cpu(), logits=logits,
            timed={b: eng.condition_input(images[:b]).cpu() for b in TIMED_BATCHES} if timed else {})
    return out


def mp_model(path: str, entry: dict):
    model = get_model(path, CFG, num_classes=entry["num_classes"], image_size=entry["image_size"])
    return model, QuantPlan(tuple(LayerPlan(*r) for r in entry["records"]))


def checked_forward(eng, x) -> dict:
    """One forward of a rank's engine (`eng`: the TPEngine, or a PPEngine
    whose stage engine is recorded) with every launch counted (counts set
    to 0 just before it), then every kernel call it made held against its
    plain version.  Returns its logits (host), launches, calls and the
    largest error."""
    target = eng.engine if hasattr(eng, "engine") else eng
    rec = Recorder(target)
    reset_launches()
    logits = eng(x)
    if logits.device.type == "cuda":
        torch.cuda.synchronize()
    counts = launches()
    errs = [compare(name, args, kw)[1] for name, args, kw in rec.calls]
    recorded = {name: [c[0] for c in rec.calls].count(name) for name in KERNELS}
    return dict(logits=logits.cpu(), launches=counts, calls=recorded, n_calls=len(rec.calls),
                max_abs_err=max(errs, default=0))


def rank_wall_ms(mesh, forward, x, reps: int = 5) -> float:
    """Wall ms per forward on this rank, every rank starting together."""
    forward(x)
    torch.cuda.synchronize()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        forward(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def rank_device_ms(forward, x):
    """(device ms, port kernels' device ms) of one forward on this rank:
    everything torch.profiler records on its card, collectives included."""
    forward(x)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        forward(x)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    return (sum(e.self_device_time_total for e in ka) / 1e3,
            sum(e.self_device_time_total for e in ka if "f8::" in e.key) / 1e3)


def mp_rank(rank: int, world: int, port: int, settings: dict) -> None:
    """One rank of the tp and pp phases, in a process of its own (spawned):
    joins the group over settings["backend"] (gloo: on card 0, which the
    ranks share; NCCL: on the card init_dist picks), builds every mesh of
    the phase, and on each runs the TP engine on every path and rung and
    the PP engine on the pipelined paths, each forward checked
    (checked_forward); the tp_overlap primitives on the first TP mesh;
    over NCCL the int32 wrap check and, with settings["timed"], the
    timings.  Writes what it saw to settings["out"]/rank<r>.pt."""
    from f8net_tpu_torch.engine import PPEngine, TPEngine, make_pipe_mesh
    from f8net_tpu_torch.parallel import init_dist, make_mesh, tp_overlap
    from f8net_tpu_torch.parallel.mesh import shard_batch

    device = torch.device(settings["device"])
    if device.type == "cuda" and settings["backend"] == "gloo":
        torch.cuda.set_device(0)
    torch.set_num_threads(settings["threads"])
    init_dist(f"tcp://127.0.0.1:{port}", rank, world, backend=settings["backend"])
    try:
        data = torch.load(settings["payload"], weights_only=False)
        res = {"card": torch.cuda.current_device() if device.type == "cuda" else None,
               "tp": {}, "pp": {}, "timed": {}}
        rungs = (None, *RUNGS)
        tp_meshes = [make_mesh(d, m, device=device) for d, m in settings["tp_meshes"]]
        pp_meshes = [make_pipe_mesh(s, device=device) for s in settings["pp_stages"]]
        for mesh in tp_meshes:
            shape = (mesh.size("data"), mesh.size("model"))
            for path in settings["tp_paths"]:
                entry = data["paths"][path]
                model, plan = mp_model(path, entry)
                for rung in rungs:
                    eng = TPEngine(model, plan, entry["params"], mesh, device=device,
                                   **({rung: True} if rung else {}))
                    mesh.reset_counts()
                    out = checked_forward(eng, shard_batch(mesh, entry["x"]).to(device))
                    out.update(collectives=dict(mesh.counts), table=eng.launch_table(),
                               rows=sum(v == "row" for v in eng.modes.values()))
                    res["tp"][(shape, path, rung)] = out
        for mesh in pp_meshes:
            stages = mesh.size("pipe")
            micro = PP_MICRO if stages == 2 else 2 * stages
            for path in settings["pp_paths"]:
                entry = data["paths"][path]
                model, plan = mp_model(path, entry)
                for rung in rungs:
                    eng = PPEngine(model, plan, entry["params"], mesh, micro, device=device,
                                   **({rung: True} if rung else {}))
                    mesh.reset_counts()
                    out = checked_forward(eng, entry["x"].to(device))
                    table = eng.engine.launch_table()
                    out.update(collectives=dict(mesh.counts), wire=eng.wire_bytes, sent=eng.sent,
                               table={k: micro * v for k, v in table.items()}, layers=eng.layers,
                               micro=micro)
                    res["pp"][(stages, path, rung)] = out
        res["overlap"] = overlap_check(tp_meshes[0], tp_overlap, device, settings["seed"])
        res["wrap"] = wrap_check(tp_meshes[0], device)
        if data["timed"]:
            tp_mesh, pp_mesh = tp_meshes[0], pp_meshes[0]
            for path in MP_TIMED_PATHS:
                entry = data["paths"][path]
                model, plan = mp_model(path, entry)
                tp = TPEngine(model, plan, entry["params"], tp_mesh, device=device)
                pp = PPEngine(model, plan, entry["params"], pp_mesh, MP_TIMED_MICRO, device=device)
                for b, xb in entry["timed"].items():
                    xb = xb.to(device)
                    for kind, eng in (("tp", tp), ("pp", pp)):
                        res["timed"][(kind, path, b)] = (rank_wall_ms(tp_mesh, eng, xb),
                                                         *rank_device_ms(eng, xb))
        if device.type == "cuda":
            torch.cuda.synchronize()
        torch.save(res, os.path.join(settings["out"], f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def overlap_operands(seed: int, device):
    """A MobileNetV2-like expand/project pair (rows of 8 x 28 x 28 pixels):
    int8 operands and int32 biases, drawn on the host from the seed."""
    g = torch.Generator().manual_seed(seed)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=g, dtype=torch.int8).to(device)
    i32 = lambda n: torch.randint(-(1 << 14), 1 << 14, (n,), generator=g,
                                  dtype=torch.int32).to(device)
    m, k, n, o = 8 * 28 * 28, 32, 192, 32
    return dict(x=i8(m, k), w1=i8(k, n), b1=i32(n), w2=i8(n, o), b2=i32(o), w=i8(k, n), b=i32(n))


def overlap_check(mesh, tp_overlap, device, seed: int) -> dict:
    """tp_paired_matmul_int8 and tp_ring_matmul_int8 on the mesh's model
    axis against their one-process composition on this rank (the same
    kernels on the whole operands); raises unless bitwise equal.  Returns
    the collectives each made."""
    p, i = mesh.size("model"), mesh.index("model")
    op = overlap_operands(seed, device)
    n, kb = op["w1"].shape[1] // p, op["x"].shape[1] // p
    cols = slice(i * n, (i + 1) * n)
    kw1, kw2 = dict(net1=7, net2=8, signed1=False, signed2=True), dict(net=7, signed=True)
    mesh.reset_counts()
    paired = tp_overlap.tp_paired_matmul_int8(
        mesh, op["x"], op["w1"][:, cols].contiguous(), op["b1"][cols].contiguous(),
        op["w2"][cols].contiguous(), op["b2"], **kw1)
    paired_counts = dict(mesh.counts)
    mesh.reset_counts()
    ring = tp_overlap.tp_ring_matmul_int8(
        mesh, op["x"][:, i * kb:(i + 1) * kb].contiguous(), op["w"][:, cols].contiguous(),
        op["b"][cols].contiguous(), **kw2)
    ring_counts = dict(mesh.counts)
    h8 = tp_overlap.matmul_int8(op["x"], op["w1"], op["b1"], epilogue="requant8", net=7,
                                out_signed=False)
    want_p = tp_overlap.requant8(tp_overlap.matmul_int8(h8, op["w2"], op["b2"], epilogue="int32"),
                                  8, True)
    want_r = tp_overlap.requant8(tp_overlap.matmul_int8(op["x"], op["w"], op["b"],
                                                         epilogue="int32"), 7, True)[:, cols]
    if not (torch.equal(paired, want_p) and torch.equal(ring, want_r)):
        raise AssertionError(f"tp_overlap on rank {i} of {p}: the paired ({torch.equal(paired, want_p)}) "
                             f"or ring ({torch.equal(ring, want_r)}) matmul differs from its "
                             f"one-process composition")
    return dict(paired=paired_counts, ring=ring_counts)


def wrap_check(mesh, device) -> list:
    """An int32 all-reduce across INT32_MAX over the model axis, held to
    wrap_i32 of the int64 sum; returns the result."""
    from f8net_tpu_torch.ops.fxp import INT32_MAX, wrap_i32

    p, i = mesh.size("model"), mesh.index("model")
    rows = [[INT32_MAX, -INT32_MAX - 1, 5 + r, (1 << 30) + r, -(1 << 30) - r] for r in range(p)]
    t = torch.tensor(rows[i], dtype=torch.int32, device=device)
    got = mesh.all_reduce(t, "model").cpu()
    want = wrap_i32(torch.tensor(rows, dtype=torch.int64).sum(0))
    if not torch.equal(got, want):
        raise AssertionError(f"int32 all-reduce over {p} ranks: {got.tolist()}, wrapped int64 sum "
                             f"{want.tolist()}")
    return got.tolist()


def mp_phase(forwards, images, card: str, seed: int, device="cuda", world: int = MP_WORLD,
             backend: str = "gloo", timed: bool = False) -> dict:
    """The tp and pp phases (module docstring): `world` ranks that share
    card 0 over gloo, or (backend "nccl") each on a card of its own.
    Returns {"tp": launches, "pp": launches} by kernel, summed over ranks
    and forwards."""
    t_start = time.perf_counter()
    dev = torch.device(device)
    tp_meshes = [(1, world)] + ([(2, world // 2)] if world >= 4 else [])
    pp_stages = [world]
    with tempfile.TemporaryDirectory() as tmp:
        payload = os.path.join(tmp, "payload.pt")
        paths = sorted(set(MP_TP_PATHS) | set(MP_PP_PATHS), key=list(LAUNCHES_PER_FORWARD).index)
        torch.save(mp_payload(forwards, images, paths, timed), payload)
        settings = dict(device=str(dev), backend=backend, out=tmp, payload=payload, seed=seed,
                        threads=torch.get_num_threads(), tp_meshes=tp_meshes, pp_stages=pp_stages,
                        tp_paths=MP_TP_PATHS, pp_paths=MP_PP_PATHS)
        single = {}
        if timed:  # the single-card engine first, on card 0 alone
            data = torch.load(payload, weights_only=False)
            for path in MP_TIMED_PATHS:
                eng = forwards[(path, None)][0]
                for b, xb in data["paths"][path]["timed"].items():
                    xb = xb.to(dev)
                    wall = time_ms(lambda: eng(xb), reps=5, rounds=3)
                    single[(path, b)] = (wall, device_ms(lambda: eng(xb), reps=3)[0])
        ranks = spawn_ranks(mp_rank, world, settings, "tp/pp")()
        data = torch.load(payload, weights_only=False)
    cards = [r["card"] for r in ranks]
    if dev.type == "cuda" and cards != ([0] * world if backend == "gloo" else list(range(world))):
        raise AssertionError(f"tp/pp: the ranks ran on cards {cards}")
    how = ("sharing the card over gloo" if backend == "gloo"
           else f"on cards {cards} over {backend}")
    total = {"tp": {name: 0 for name in KERNELS}, "pp": {name: 0 for name in KERNELS}}
    for kind in ("tp", "pp"):
        for key in ranks[0][kind]:
            for r, rk in enumerate(ranks):
                if key not in rk[kind]:
                    continue
                out = rk[kind][key]
                mesh_of, path, rung = key
                label = f"{kind} {path} {RUNGS.get(rung, 'strict')} {mesh_of} rank {r}"
                want = data["paths"][path]["logits"][rung]
                if kind == "tp":
                    d, m = mesh_of
                    per = want.shape[0] // d
                    want = want[(r // m) * per:(r // m + 1) * per]
                if not torch.equal(out["logits"], want):
                    raise AssertionError(f"{label}: logits differ from the single-card engine's "
                                         f"(max {(out['logits'] - want).abs().max().item()})")
                table = {name: out["table"].get(name, 0) for name in KERNELS}
                if out["calls"] != table or (dev.type == "cuda" and out["launches"] != table):
                    raise AssertionError(f"{label}: calls {out['calls']}, launches "
                                         f"{out['launches']}, its routing's table {table}")
                col = out["collectives"]
                if kind == "tp" and (col.get("all_reduce", 0) != (out["rows"] if mesh_of[1] > 1 else 0)
                                     or "all_gather" in col):
                    raise AssertionError(f"{label}: collectives {col}, {out['rows']} row layers")
                for name in KERNELS:
                    total[kind][name] += out["launches"][name]
            first = ranks[0][kind][key]
            if kind == "tp":
                log(f"tp {key[1]} {RUNGS.get(key[2], 'strict')} (data, model) = {key[0]}, "
                    f"{world} ranks {how}: every rank's logits bitwise equal to the single-card "
                    f"engine's; rank 0: {first['n_calls']} kernel calls equal to their plain "
                    f"versions, launches {dict((k, v) for k, v in first['launches'].items() if v)} "
                    f"as its routing's table; {first['collectives'].get('all_reduce', 0)} "
                    f"all-reduces ({first['rows']} row layers, "
                    f"{first['collectives'].get('all_reduce_bytes', 0)} bytes), no all-gather")
            else:
                wire = sum(rk["pp"][key]["wire"] for rk in ranks if key in rk["pp"])
                dtypes = sorted({str(dt).split(".")[-1] for rk in ranks if key in rk["pp"]
                                 for dt, _ in rk["pp"][key]["sent"]})
                log(f"pp {key[1]} {RUNGS.get(key[2], 'strict')} {key[0]} stages, "
                    f"{first['micro']} microbatches, {how}: logits bitwise equal to the single-card "
                    f"engine's on every rank; every stage's kernel calls equal to their plain "
                    f"versions and its launches its table; wire {wire} bytes per forward "
                    f"(boundaries as {', '.join(dtypes)})")
    for r, rk in enumerate(ranks):
        ov = rk["overlap"]
        if ov["paired"].get("all_reduce") != 1 or ov["ring"].get("send") != world - 1:
            raise AssertionError(f"tp_overlap rank {r}: collectives {ov}")
    log(f"tp_overlap on {world} ranks {how}: tp_paired_matmul_int8 (one all-reduce) and "
        f"tp_ring_matmul_int8 ({world - 1} sends per rank) bitwise equal to their one-process "
        f"composition on every rank")
    log(f"{backend} int32 all-reduce across INT32_MAX over {world} ranks {how}: "
        f"{ranks[0]['wrap']}, equal to wrap_i32 of the int64 sum: its int32 sum wraps")
    for (kind, path, b), _ in sorted(ranks[0]["timed"].items()):
        walls = [rk["timed"][(kind, path, b)][0] for rk in ranks]
        dev_ms = [rk["timed"][(kind, path, b)][1] for rk in ranks]
        ours = [rk["timed"][(kind, path, b)][2] for rk in ranks]
        s_wall, s_dev = single[(path, b)]
        how_t = f"TP (1, {world})" if kind == "tp" else f"PP {world} stages, {MP_TIMED_MICRO} microbatches"
        log(f"mp timing {path} batch {b} {how_t}: wall {max(walls):.3f} ms per forward (slowest "
            f"rank), device ms per rank {' '.join(f'{v:.3f}' for v in dev_ms)} (port kernels "
            f"{' '.join(f'{v:.3f}' for v in ours)}); single card: wall {s_wall:.3f} ms, device "
            f"{s_dev:.3f} ms ({card})")
    log(f"tp and pp phases: {time.perf_counter() - t_start:.1f} s wall, {world} ranks {how} ({card})")
    return total


def mp_engines(seed: int, images, device) -> dict:
    """The engines --mp-cards compares with: each path's synthetic bundle
    (the engine phase's) in each rung, {(path, rung): (engine,)}."""
    out = {}
    for path in LAUNCHES_PER_FORWARD:
        model, plan, params, _ = load_synthetic_model(seed, IMAGE_SIZE, 1000, device,
                                                       images[:BATCH], model_name=path)
        for rung in (None, *RUNGS):
            out[(path, rung)] = (IntEngine(model, plan, params, device=device,
                                           **({rung: True} if rung else {})),)
    return out


# -- xserve --------------------------------------------------------------------


def xserve_pool(seed: int, side: int) -> np.ndarray:
    """The xserve phase's images: XSERVE_POOL distinct random uint8 images,
    each with its index in its first pixel (image_id)."""
    rng = np.random.RandomState(seed + 13)
    shape = (XSERVE_POOL, side, side, 3)
    pool = np.frombuffer(rng.bytes(math.prod(shape)), np.uint8).reshape(shape).copy()
    ids = np.arange(XSERVE_POOL)
    pool[:, 0, 0] = np.stack([ids % 256, ids // 256 % 256, ids // 65536], 1)
    return pool


def xserve_traffic(pool, seed: int, slot: int, slots: int, per_host: int):
    """One ingesting rank's requests, slices of the pool in a region of its
    own: XSERVE_CLIENTS clients of XSERVE_REQUESTS requests of 1-4 images,
    then (CrossHost's waves) one image and one request of the per-host
    shard.  Returns (clients, waves)."""
    region = len(pool) // slots
    k = slot * region
    clients = []
    for sizes in np.random.RandomState(seed + 17 + slot).randint(1, 5, (XSERVE_CLIENTS,
                                                                       XSERVE_REQUESTS)):
        reqs = []
        for n in sizes:
            reqs.append(pool[k:k + n])
            k += n
        clients.append(reqs)
    if k + 1 + per_host > (slot + 1) * region:
        raise ValueError("xserve: a rank's requests overflow its region of the pool")
    return clients, [pool[k:k + 1], pool[k + 1:k + 1 + per_host]]


class XServeEngine:
    """A rank's engine behind a server in the xserve phase: counts each
    forward's launches (its table: the routing's), and holds every kernel
    call of the first XSERVE_CHECKED forwards against its plain version
    (those comparisons' own launches counted apart)."""

    def __init__(self, engine):
        self.engine, self.device = engine, engine.device
        self.rec = Recorder(engine)
        self.deltas, self.checked, self.max_err, self.extra = [], 0, 0, {n: 0 for n in KERNELS}

    def __call__(self, x):
        self.rec.calls = []
        before = launches()
        y = self.engine(x)
        after = launches()
        self.deltas.append({k: after[k] - before[k] for k in after})
        if self.checked < XSERVE_CHECKED:
            self.checked += 1
            for name, args, kw in self.rec.calls:
                self.max_err = max(self.max_err, compare(name, args, kw)[1])
                self.extra[name] += 1
        self.rec.calls = []
        return y


def xserve_rows(label, want, served) -> int:
    """Every served row bitwise the single-card engine's for its image."""
    for req, y, *_ in served:
        if not np.array_equal(y, want[image_id(req)]):
            raise AssertionError(f"{label}: a request of images {image_id(req).tolist()} differs "
                                 f"from the single-card engine's rows")
    return sum(len(r[0]) for r in served)


def xserve_rank(rank: int, world: int, port: int, settings: dict) -> None:
    """One rank of the xserve phase, in a process of its own (spawned): joins
    the group, builds each case's mesh, engine and server, drives it (the
    ingesting ranks send their clients' traffic: a checked window, then a
    measured one), checks every served row and every forward's launches,
    and writes what it saw to settings["out"]/rank<r>.pt."""
    from f8net_tpu_torch.engine import CrossHostServingEngine, TPEngine
    from f8net_tpu_torch.parallel import init_dist, make_mesh

    device = torch.device(settings["device"])
    if device.type == "cuda" and settings["backend"] == "gloo":
        torch.cuda.set_device(0)
    torch.set_num_threads(settings["threads"])
    init_dist(f"tcp://127.0.0.1:{port}", rank, world, backend=settings["backend"])
    if device.type == "cuda":  # the card init_dist chose, for the servers' threads too
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        data = torch.load(settings["payload"], weights_only=False)
        entry = data["entry"]
        model, plan = mp_model("resnet18", entry)
        pool = xserve_pool(settings["seed"], entry["image_size"])
        meshes, res = {}, {}
        for kind, shape, rung in settings["cases"]:
            if shape not in meshes:
                meshes[shape] = make_mesh(*shape, device=device)
            mesh = meshes[shape]
            kw = {rung: True} if rung else {}
            eng = (TPEngine(model, plan, entry["params"], mesh, device=device, **kw) if shape[1] > 1
                   else IntEngine(model, plan, entry["params"], device=device, **kw))
            table = {name: eng.launch_table().get(name, 0) for name in KERNELS}
            probe = XServeEngine(eng)
            label = f"xserve {kind} {shape} {RUNGS.get(rung, 'strict')} rank {rank}"
            mesh.reset_counts()
            reset_launches()
            if kind == "serve":
                srv = ServingEngine(probe, mesh=mesh, buckets=SERVE_BUCKETS,
                                    max_wait_ms=SERVE_WAIT_MS, ring_capacity=SERVE_RING,
                                    image_shape=pool.shape[1:], image_dtype=np.uint8)
                ingest = srv.front
                slot, slots = 0, 1
            else:
                srv = CrossHostServingEngine(probe, mesh, buckets=SERVE_BUCKETS,
                                             tick_ms=XSERVE_TICK_MS, image_shape=pool.shape[1:],
                                             image_dtype=np.uint8)
                ingest = srv.leader
                slot, slots = mesh.index("data"), mesh.size("data")
            out = {}
            srv.start()
            try:
                if ingest:
                    clients, waves = xserve_traffic(pool, settings["seed"], slot, slots,
                                                    max(SERVE_BUCKETS) // slots)
                    served = []
                    if kind == "xhost":  # low load, then one full per-host shard
                        for req in waves:
                            served.append((req, srv.infer(req, timeout=SERVE_TIMEOUT)))
                    _, checked = run_clients(srv, clients)
                    r0 = srv.stats["images"] + srv.stats["padded"]
                    wall, measured = run_clients(srv, clients)
                    rows = srv.stats["images"] + srv.stats["padded"] - r0
                    n = xserve_rows(label, data["want"][rung], served + checked + measured)
                    p50, p99 = latency_ms(measured)
                    out.update(images_s=sum(len(m[0]) for m in measured) / wall,
                               rows_s=rows / wall, served_rows=n, p50=p50, p99=p99)
            finally:
                srv.stop()
            if srv._thread.is_alive():
                raise AssertionError(f"{label}: the server's loop did not end")
            if device.type == "cuda":
                torch.cuda.synchronize()
                for i, d in enumerate(probe.deltas):
                    if d != table:
                        raise AssertionError(f"{label}: forward {i} launched {d}, its routing's "
                                             f"table {table}")
                total = {k: sum(d[k] for d in probe.deltas) + probe.extra[k] for k in KERNELS}
                if launches() != total:
                    raise AssertionError(f"{label}: counters {launches()}, forwards and checks "
                                         f"{total}")
            if probe.checked < min(XSERVE_CHECKED, len(probe.deltas)):
                raise AssertionError(f"{label}: {probe.checked} forwards checked")
            out.update(stats=dict(srv.stats) if ingest else None, counts=dict(mesh.counts),
                       forwards=len(probe.deltas), table=table, max_err=probe.max_err,
                       checked_calls=sum(probe.extra.values()), checked=probe.checked,
                       launches={k: sum(d[k] for d in probe.deltas) for k in KERNELS})
            res[(kind, shape, rung)] = out
            del srv, probe, eng
        if device.type == "cuda":
            torch.cuda.synchronize()
        torch.save(res, os.path.join(settings["out"], f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def xserve_single(eng: IntEngine, pool, clients, want) -> dict:
    """One card's ServingEngine on the front end's traffic (a warm-up
    window, then the measured one), its rows checked: images/s, p50, p99."""
    srv = ServingEngine(eng, buckets=SERVE_BUCKETS, max_wait_ms=SERVE_WAIT_MS,
                        ring_capacity=SERVE_RING, image_shape=pool.shape[1:], image_dtype=np.uint8)
    srv.start()
    try:
        run_clients(srv, clients)
        wall, measured = run_clients(srv, clients)
    finally:
        srv.stop()
    xserve_rows("xserve single card", want, measured)
    p50, p99 = latency_ms(measured)
    return dict(images_s=sum(len(m[0]) for m in measured) / wall, p50=p50, p99=p99)


def xserve_phase(forwards, card: str, seed: int, device="cuda", world: int = MP_WORLD,
                 backend: str = "gloo") -> dict:
    """The xserve phase (module docstring): `world` ranks sharing card 0
    over gloo, or (backend "nccl") each on a card of its own.  Returns the
    launches by kernel, summed over ranks and forwards."""
    t_start = time.perf_counter()
    dev = torch.device(device)
    rungs = (None, "bf16_boundary")
    meshes = [(world, 1), (1, world) if world == 2 else (2, world // 2)]
    cases = ([("serve", m, r) for m in meshes for r in rungs]
             + [("xhost", (world, 1), r) for r in rungs])
    base = forwards[("resnet18", None)][0]
    side = 32 * base.model.pool_kernel
    pool = xserve_pool(seed, side)
    want = {}
    for rung in rungs:
        eng = forwards[("resnet18", rung)][0]
        want[rung] = torch.cat([eng(torch.from_numpy(pool[i:i + 64]).to(dev)).cpu()
                                for i in range(0, len(pool), 64)]).numpy()
    clients, _ = xserve_traffic(pool, seed, 0, 1, max(SERVE_BUCKETS))
    single = {r: xserve_single(forwards[("resnet18", r)][0], pool, clients, want[r])
              for r in rungs}
    with tempfile.TemporaryDirectory() as tmp:
        payload = os.path.join(tmp, "payload.pt")
        torch.save(dict(want=want, entry=dict(
            image_size=side, num_classes=base.model.num_classes,
            records=[(p.name, p.input_fl, p.weight_fl, p.input_symmetric) for p in base.plan.layers],
            params={n: {k: v.cpu() for k, v in d.items() if k in ("w", "b")}
                    for n, d in base.params.items()})), payload)
        settings = dict(device=str(dev), backend=backend, out=tmp, payload=payload, seed=seed,
                        threads=torch.get_num_threads(), cases=cases)
        ranks = spawn_ranks(xserve_rank, world, settings, "xserve")()
    how = "sharing the card over gloo" if backend == "gloo" else f"a card each over {backend}"
    total = {name: 0 for name in KERNELS}
    for key in cases:
        kind, shape, rung = key
        outs = [rk[key] for rk in ranks]
        for o in outs:
            for name in KERNELS:
                total[name] += o["launches"][name]
        name = f"xserve {kind} (data, model) = {shape} {RUNGS.get(rung, 'strict')}"
        ingest = [r for r, o in enumerate(outs) if o["stats"] is not None]
        st = outs[ingest[0]]["stats"]
        rounds = st["batches"] + st.get("idle_rounds", 0)
        c0 = outs[0]["counts"]
        per_round = ", ".join(f"{k} {c0[k] / rounds:.2f}" for k in sorted(c0) if not k.endswith("_bytes"))
        per_round_b = ", ".join(f"{k[:-6]} {c0[k] / rounds:.0f} B" for k in sorted(c0)
                                if k.endswith("_bytes"))
        launched = {k: v for k, v in outs[0]["table"].items() if v}
        log(f"{name}, {world} ranks {how}: {sum(o['served_rows'] for o in outs if 'served_rows' in o)} "
            f"served rows bitwise equal to the single-card engine's; each rank's "
            f"{', '.join(str(o['forwards']) for o in outs)} forwards launched its routing's "
            f"table ({launched} on rank 0); {sum(o['checked_calls'] for o in outs)} kernel calls of "
            f"{sum(o['checked'] for o in outs)} checked forwards equal to their plain versions")
        log(f"{name}: rank 0's mesh collectives per round ({rounds} rounds): {per_round}; "
            f"{per_round_b}")
        if kind == "xhost":
            ticks = {outs[r]["stats"]["coord_ticks"] for r in ingest}
            if len(ticks) != 1:
                raise AssertionError(f"{name}: the leaders ran {ticks} coordination ticks")
            hits = st["bucket_hits"]
            if not (hits.get(min(SERVE_BUCKETS)) and hits.get(max(SERVE_BUCKETS))):
                raise AssertionError(f"{name}: the low-load round or the per-host shard missed "
                                     f"its bucket: {st}")
            coord = (1e3 * st.get("coord_s_steady", 0.0) / max(st.get("coord_ticks_steady", 0), 1))
            log(f"{name}: every leader {ticks.pop()} coordination ticks; bucket hits {hits}; "
                f"coordination {coord:.4f} ms per tick in steady state (rank 0; the all-reduce "
                f"and the wait for the slowest leader) ({card})")
        for r in ingest:
            o = outs[r]
            log(f"{name} rank {r}: {XSERVE_CLIENTS} closed-loop clients, {o['images_s']:.1f} "
                f"images/s served ({o['rows_s']:.1f} rows/s computed), latency p50 {o['p50']:.3f} "
                f"ms p99 {o['p99']:.3f} ms; stats {o['stats']} ({card})")
        sc = single[rung]
        log(f"{name}: one card's ServingEngine on rank 0's traffic: {sc['images_s']:.1f} images/s, "
            f"p50 {sc['p50']:.3f} ms p99 {sc['p99']:.3f} ms ({card})")
    log(f"xserve phase: {time.perf_counter() - t_start:.1f} s wall, {world} ranks {how} ({card})")
    return total


# -- bf16train: cfg.train_conv_bf16 on TF32 tensor cores ------------------------


def qat_convs(path: str, side: int, device) -> dict:
    """Each distinct conv of `path`'s QAT forward at `side` px, 1000
    classes: {(in, out, kernel, stride, padding, groups, h, w): (spec,
    [layer names])}, from one train-mode forward at batch 1."""
    model = get_model(path, CFG, num_classes=1000, image_size=side)
    params, state = model.init(torch.Generator().manual_seed(0), device=device)
    seen, conv = {}, nn_runner.Runner.conv

    def record(self, name, act):
        spec, x = self.graph[name], ql.as_act(act).x
        key = (spec.in_ch, spec.out_ch, spec.kernel, spec.stride, spec.padding, spec.groups,
               x.shape[1], x.shape[2])
        seen.setdefault(key, (spec, []))[1].append(name)
        return conv(self, name, act)

    with patched(nn_runner.Runner, "conv", record), torch.no_grad():
        model.apply(params, state, torch.rand((1, side, side, 3), device=device), mode="train")
    return seen


def _conv64(x, w, spec):
    """NHWC x HWIO conv in float64."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=spec.stride,
                    padding=spec.padding, groups=spec.groups).permute(0, 2, 3, 1)


def _gemm_tf32(x, w, spec):
    """The NHWC x HWIO conv as an im2col GEMM (one per group) on cuBLAS's
    TF32 tensor cores: the bf16train phase's witness."""
    n, g = x.shape[0], spec.groups
    cols = F.unfold(x.permute(0, 3, 1, 2), spec.kernel, padding=spec.padding,
                    stride=spec.stride)
    cols = cols.view(n, g, -1, cols.shape[-1])
    wk = w.permute(3, 2, 0, 1).reshape(g, spec.out_ch // g, -1)
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y = torch.einsum("ngkl,gok->ngol", cols, wk)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
    (kh, kw), (sh, sw), (ph, pw) = spec.kernel, spec.stride, spec.padding
    ho, wo = (x.shape[1] + 2 * ph - kh) // sh + 1, (x.shape[2] + 2 * pw - kw) // sw + 1
    return y.reshape(n, spec.out_ch, ho, wo).permute(0, 2, 3, 1)


def bf16_conv_row(path, key, spec, names, batch, device, card: str, seed: int):
    """One conv of the QAT step with the flag (ql.conv2d_bf16, inside
    float32_exact as the train step runs it: bfloat16-rounded operands on
    TF32 tensor cores) against the float64 conv of the same rounded
    operands, held as the constants' comment says: bitwise on small-grid
    operands; on the batch-statistics conv's operands within
    BF16_CONV_BOUND of each output's sqrt(sum of squared products) with
    cudnn.benchmark off and, on a card, on; the float32 conv's (TF32 off)
    and the TF32 GEMM witness's errors logged beside it; on a card the
    float32 conv's, the flagged conv's and F.conv2d's in bf16
    (channels_last) CUDA-event ms and the TF32 bound.  Returns (its row,
    the flagged call on those operands, for bf16_kernels)."""
    h, w_ = key[6], key[7]
    kh, kw = spec.kernel
    k = kh * kw * spec.in_ch // spec.groups
    cuda = device.type == "cuda"
    g = torch.Generator(device=device).manual_seed(seed)
    xg = torch.randint(0, 8, (BF16_GRID_BATCH, h, w_, spec.in_ch), generator=g,
                       device=device) / 8.0
    wg = torch.randint(-3, 4, spec.weight_shape(), generator=g, device=device) / 4.0
    with float32_exact():
        exact = torch.equal(ql.conv2d_bf16(xg, wg, spec).double(),
                            _conv64(xg.double(), wg.double(), spec))
    del xg, wg
    # fix_scaling * x (>= 0, on no grid) and raw weights (He std)
    x = torch.randn((batch, h, w_, spec.in_ch), generator=g, device=device).abs_().mul_(3.0)
    w = torch.randn(spec.weight_shape(), generator=g, device=device) * math.sqrt(2.0 / k)
    xb, wb = ql.bf16_round(x), ql.bf16_round(w)
    ref = _conv64(xb.double(), wb.double(), spec)
    l2 = _conv64(xb.double().square_(), wb.double().square_(), spec).sqrt_().clamp_min_(1e-300)

    def dist(y):
        return float(((y.double() - ref).abs_() / l2).max())

    def flagged():
        with float32_exact():
            return ql.conv2d_bf16(x, w, spec)

    errs, autotune = {}, torch.backends.cudnn.benchmark
    try:
        for bench in ((False, True) if cuda else (False,)):
            torch.backends.cudnn.benchmark = bench
            errs[bench] = dist(flagged())  # with benchmark on, the autotuner's search
    finally:
        torch.backends.cudnn.benchmark = autotune
    with float32_exact():
        err32 = dist(ql.conv2d_nhwc(xb, wb, spec))
    err_gemm = dist(_gemm_tf32(xb, wb, spec))
    n_out = ref.numel()
    flops = 2 * n_out * k
    del xb, wb, ref, l2
    err = max(errs.values())
    row = dict(path=path, shape=f"{spec.in_ch}->{spec.out_ch} {kh}x{kw}/s{spec.stride[0]}"
               f"{' dw' if spec.groups > 1 else ''} at {h}x{w_}", layers=len(names), k=k,
               exact=exact, err=err, err32=err32, err_gemm=err_gemm, flops=flops)
    text = (f"bf16train conv {path} {row['shape']} (x{len(names)}: {names[0]}), batch {batch}, "
            f"K {k}: small-grid operands {'bitwise' if exact else 'NOT bitwise'} the float64 "
            f"conv; max |flagged - float64| / sqrt(sum p^2) "
            + ", ".join(f"{e:.3e} (cudnn.benchmark {'on' if b else 'off'})"
                        for b, e in errs.items())
            + f", bound {BF16_CONV_BOUND:.3e}; the float32 conv (TF32 off) {err32:.3e}, the "
            f"im2col GEMM on TF32 tensor cores {err_gemm:.3e}")
    if cuda:
        xl = x.permute(0, 3, 1, 2).to(torch.bfloat16)
        wl = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        row.update(
            f32_ms=time_ms(lambda: ql.conv2d_nhwc(x, w, spec), reps=5, rounds=3),
            bf16_ms=time_ms(flagged, reps=5, rounds=3),
            lib_ms=time_ms(lambda: F.conv2d(xl, wl, stride=spec.stride, padding=spec.padding,
                                            groups=spec.groups), reps=5, rounds=3),
            bound_ms=1e3 * max(flops / H100_PEAK_OPS["tf32"],
                               4 * (x.numel() + w.numel() + n_out) / HBM_BYTES_PER_S))
        text += (f"; f32 {row['f32_ms']:.4f} ms, flagged {row['bf16_ms']:.4f} ms (the rounding "
                 f"included), F.conv2d in bf16 {row['lib_ms']:.4f} ms, TF32 bound "
                 f"{row['bound_ms']:.4f} ms")
    log(text + f" ({card})")
    if not exact or err > BF16_CONV_BOUND:
        raise AssertionError(f"bf16train: {path} {row['shape']}: the flagged conv is "
                             f"{'' if exact else 'not '}exact on small-grid operands, "
                             f"{err:.3e} from the float64 conv of its rounded operands (bound "
                             f"{BF16_CONV_BOUND:.3e})")
    return row, flagged


def bf16_kernels(path: str, runs, card: str) -> None:
    """The kernels `path`'s flagged convs (`runs`, each searched by the
    autotuner already) launch with cudnn.benchmark off and on, in one
    torch.profiler session; raises on a BF16_REFUSED one."""
    autotune = torch.backends.cudnn.benchmark

    def run():
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            for flagged in runs:
                flagged()

    try:
        names = {e.key for e in profile(run) if e.self_device_time_total > 0}
    finally:
        torch.backends.cudnn.benchmark = autotune
    refused = sorted(n for n in names if any(r in n.lower() for r in BF16_REFUSED))
    log(f"bf16train: {path}'s {len(runs)} flagged convs, cudnn.benchmark off and on, launched "
        f"{sorted(n[:64] for n in names if 'elementwise' not in n.lower())} beside the "
        f"rounding's elementwise kernels ({card})")
    if refused:
        raise AssertionError(f"bf16train: {path}'s flagged convs launched {refused}: their "
                             f"products are not exact")


def bf16_step_profile(label, model, trainer, params, state, opt, images, labels, card: str):
    """One QAT step of `trainer` profiled (device ms, convolution and GEMM
    ms) and its forward alone (train mode, autograd on: the forward's conv
    and GEMM ms), the step's conv FLOPs forward (aten.convolution) and
    backward (aten.convolution_backward), each over its device ms.  Returns
    (step device ms, forward conv ms, backward conv ms)."""
    from torch.utils.flop_counter import FlopCounterMode

    def step():
        trainer.train_step(params, state, opt, images, labels, 1e-4)

    leaves = [p for sub in params.values() for p in sub.values()]
    x = train_loop.condition_input(images, trainer.cfg)

    def forward():
        for p in leaves:
            p.requires_grad_(True)
        try:
            with float32_exact():
                model.forward(params, state, x, "train", trainer.cfg)
        finally:
            for p in leaves:
                p.requires_grad_(False)

    step_kinds, fwd_kinds = by_kind(profile(step)), by_kind(profile(forward))
    busy = sum(v[0] for v in step_kinds.values())
    fwd_ms = fwd_kinds[CONV_KIND][0]
    bwd_ms = step_kinds[CONV_KIND][0] - fwd_ms
    counter = FlopCounterMode(display=False)
    with counter:
        step()
    by_op = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    fwd_fl, bwd_fl = by_op.get("aten.convolution", 0), by_op.get("aten.convolution_backward", 0)
    peak = "tf32" if trainer.cfg.train_conv_bf16 else "float32"
    log(f"bf16train: {label} step device ms {busy:.2f}; convolutions and GEMMs "
        f"{step_kinds[CONV_KIND][0]:.2f} ms ({step_kinds[CONV_KIND][1]} kernels): forward "
        f"{fwd_ms:.2f} ms for {fwd_fl / 1e12:.4f} TFLOP, {fwd_fl / fwd_ms / 1e9:.2f} TFLOP/s = "
        f"{fwd_fl / fwd_ms / 1e9 / (H100_PEAK_OPS[peak] / 1e12):.3f} of the H100's "
        f"{H100_PEAK_OPS[peak] / 1e12:.1f} TFLOP/s {peak} dense peak; backward {bwd_ms:.2f} ms "
        f"for {bwd_fl / 1e12:.4f} TFLOP, {bwd_fl / bwd_ms / 1e9:.2f} TFLOP/s = "
        f"{bwd_fl / bwd_ms / 1e9 / (H100_PEAK_OPS['float32'] / 1e12):.3f} of the "
        f"{H100_PEAK_OPS['float32'] / 1e12:.1f} TFLOP/s float32 peak; elementwise and other "
        f"{step_kinds['elementwise and other'][0]:.2f} ms ({card})")
    return busy, fwd_ms, bwd_ms


def bf16train_phase(seed: int, images, card: str, device="cuda"):
    """cfg.train_conv_bf16 on the card (module docstring).  Returns
    (launches per forward, checked kernel calls) of the flag-trained bake's
    engine."""
    dev = torch.device(device)
    t0 = time.time()
    rows = []
    for path in BF16_PATHS:
        runs = []
        for i, (key, (spec, names)) in enumerate(qat_convs(path, IMAGE_SIZE, dev).items()):
            row, flagged = bf16_conv_row(path, key, spec, names, TRAIN_BATCH, dev, card, seed + i)
            rows.append(row)
            runs.append(flagged)
        if dev.type == "cuda":
            bf16_kernels(path, runs, card)
        del runs
    if dev.type == "cuda":
        for path in BF16_PATHS:
            mine = [r for r in rows if r["path"] == path]
            tot = {k: sum(r[k] * r["layers"] for r in mine)
                   for k in ("f32_ms", "bf16_ms", "lib_ms", "bound_ms")}
            log(f"bf16train: {path}'s {sum(r['layers'] for r in mine)} QAT convs "
                f"({len(mine)} distinct), one forward conv each at batch {TRAIN_BATCH}: f32 "
                f"{tot['f32_ms']:.3f} ms, flagged {tot['bf16_ms']:.3f} ms "
                f"({tot['f32_ms'] / tot['bf16_ms']:.2f}x), F.conv2d in bf16 "
                f"{tot['lib_ms']:.3f} ms, TF32 bound {tot['bound_ms']:.3f} ms; every conv "
                f"bitwise on small-grid operands, no Winograd or FFT kernel; largest error "
                f"over sqrt(sum p^2) {max(r['err'] for r in mine):.3e}, "
                f"{max(r['err'] for r in mine) / BF16_CONV_BOUND:.3f} of the bound (float32, "
                f"TF32 off: {max(r['err32'] for r in mine):.3e}; the TF32 GEMM witness: "
                f"{max(r['err_gemm'] for r in mine):.3e}) ({card})")
    t1 = time.time()

    # the QAT step, flag off and on in interleaved rounds, on one set of params
    with tempfile.TemporaryDirectory() as tmp:
        cfg, tcfg, _ = from_flags(load_yaml(train_yaml(tmp, "bf16", TRAIN_CONFIG)), TRAIN_BATCH)
    model = get_model("resnet18", cfg, num_classes=tcfg.num_classes, image_size=tcfg.image_size)
    trainers = {flag: train_loop.Trainer(model, cfg.replace(train_conv_bf16=flag), tcfg,
                                         log=lambda *a: None, device=dev)
                for flag in (False, True)}
    params, state, opt = trainers[True].init(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    side = tcfg.image_size
    x = torch.rand((TRAIN_BATCH, side, side, 3), generator=g).to(dev)
    y = torch.randint(0, model.num_classes, (TRAIN_BATCH,), generator=g).to(dev)
    walls, peak = {False: [], True: []}, {False: 0, True: 0}
    name = {False: "flag off", True: "flag on"}
    for flag in (False, True):  # warm-up (cuDNN's algorithm search included)
        trainers[flag].train_step(params, state, opt, x, y, 1e-4)
    for r in range(BF16_ROUNDS if dev.type == "cuda" else 1):
        for flag in ((False, True) if r % 2 == 0 else (True, False)):
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            for _ in range(BF16_ROUND_STEPS):
                t = time.perf_counter()
                trainers[flag].train_step(params, state, opt, x, y, 1e-4)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                walls[flag].append((time.perf_counter() - t) * 1e3)
            if dev.type == "cuda":
                peak[flag] = max(peak[flag], torch.cuda.max_memory_allocated())
    if dev.type == "cuda":
        med = {}
        for flag in (False, True):
            med[flag] = statistics.median(walls[flag])
            q1, _, q3 = statistics.quantiles(walls[flag], n=4)
            log(f"bf16train: QAT step ({TRAIN_CONFIG}, batch {TRAIN_BATCH}, {side} px), "
                f"{name[flag]}: {med[flag]:.2f} ms wall (median of {len(walls[flag])} in "
                f"{BF16_ROUNDS} interleaved rounds; quartiles {q1:.2f} / {q3:.2f}: "
                + " ".join(f"{v:.2f}" for v in walls[flag])
                + f"), {TRAIN_BATCH / med[flag] * 1e3:.1f} images/s, peak memory "
                f"{peak[flag] / 2**30:.3f} GiB ({card})")
        prof = {flag: bf16_step_profile(name[flag], model, trainers[flag], params, state, opt,
                                        x, y, card) for flag in (False, True)}
        log(f"bf16train: flag on against off: wall {med[True] / med[False]:.3f}x, device ms "
            f"{prof[True][0] / prof[False][0]:.3f}x, forward convs {prof[True][1]:.2f} against "
            f"{prof[False][1]:.2f} ms, backward convs {prof[True][2]:.2f} against "
            f"{prof[False][2]:.2f} ms ({card})")
    t2 = time.time()

    # run.main with the flag in its YAML, as a user trains with it
    flagged, real = [], ql.conv2d_bf16
    with tempfile.TemporaryDirectory() as tmp, \
            patched(ql, "conv2d_bf16", lambda *a: flagged.append(1) or real(*a)):
        path = train_yaml(tmp, "bf16", TRAIN_CONFIG, train_conv_bf16=True)
        _, lines, wall = run_cli("bf16", [f"app:{path}", f"bs:{TRAIN_BATCH}"], dev)
        saved = os.path.exists(os.path.join(tmp, "log", "latest_checkpoint.npz"))
    if "Start training." not in lines or not flagged or not saved:
        raise AssertionError(f"bf16train: run.main with train_conv_bf16 did not train with it "
                             f"({len(flagged)} flagged convs, checkpoint written: {saved})")
    log(f"bf16train: run.main with train_conv_bf16 in its YAML trained {TRAIN_EPOCHS} epoch of "
        f"{TRAIN_SYNTHETIC} synthetic images through {len(flagged)} flagged convs and wrote "
        f"latest_checkpoint, {wall:.1f} s wall ({card})")

    # a flag-trained ResNet-18: more flagged steps, flagged calibration, bake
    trainer = trainers[True]
    for _ in range(BF16_TRAIN_STEPS):
        params, state, opt, _ = trainer.train_step(params, state, opt, x, y, 1e-4)
    state = reset_bn_for_calib(state)
    for _ in range(BF16_CALIB_STEPS):
        state, _ = trainer.calib_step(params, state, x, y)
    plan, int_params = bake_plan(model, params, state)
    eng = IntEngine(model, plan, int_params, device=dev)
    _, counts, checked = drive("resnet18 bf16-trained", "resnet18", eng, images,
                               log_calls=False, gate=False)
    log(f"bf16train: the flag-trained ResNet-18 baked: fraclens "
        + " ".join(f"{p.name}={p.input_fl}/{p.weight_fl}" for p in plan.layers))
    log(f"bf16train phase: {time.time() - t0:.1f} s wall (the convs {t1 - t0:.1f} s, the steps "
        f"{t2 - t1:.1f} s, the CLI and the bake {time.time() - t2:.1f} s) ({card})")
    return counts, checked


# -- pad: IntEngine(pad_channels_to=N) ------------------------------------------


def pad_phase(forwards, images, card: str, device="cuda") -> dict:
    """Every path and rung again through IntEngine(..., pad_channels_to=N)
    on the same bundle, for each N of PAD_TO that pads a channel (module
    docstring).  Returns {kernel: launches} summed over the padded
    forwards."""
    dev = torch.device(device)
    t0 = time.time()
    total = {name: 0 for name in KERNELS}
    base_ms = {}
    for path in LAUNCHES_PER_FORWARD:
        padded = False  # at a smaller N, in every rung
        for to in PAD_TO:
            for rung in (None, *RUNGS) if not padded else (None,):
                base = forwards[(path, rung)][0]
                eng = IntEngine(base.model, base.plan, base.params, device=dev,
                                pad_channels_to=to, **({rung: True} if rung else {}))
                label = f"{path} {RUNGS.get(rung, 'strict')} pad {to}"
                widened = sum(a != b for a, b in zip(base.graph, eng.graph))
                if not widened:
                    log(f"{label}: no channel below {to}; the padded graph is the model's")
                    continue
                x = eng.condition_input(images[:BATCH])
                logits, ref, counts, calls, _ = engine_phase(eng, x)
                for name, cargs, kw in calls:
                    compare(name, cargs, kw)
                check_logits(logits, ref, x.shape[0], eng.model.num_classes)
                if not torch.equal(logits, base(x)):
                    raise AssertionError(f"{label}: logits differ from the unpadded engine's")
                table = eng.launch_table()
                recorded = {n: [c[0] for c in calls].count(n) for n in table}
                if recorded != table or (dev.type == "cuda"
                                         and {k: v for k, v in counts.items() if v} != table):
                    raise AssertionError(f"{label}: launches {counts}, calls {recorded}, "
                                         f"routing's table {table}")
                total = {k: total[k] + counts[k] for k in KERNELS}
                padded = True
                log(f"{label}: {widened} layers widened; all {len(calls)} kernel calls equal to "
                    f"their plain versions, logits bitwise equal to the unpadded engine's; "
                    f"launches {table} (unpadded {LAUNCHES_PER_FORWARD[path]})")
                if dev.type != "cuda":
                    continue
                cells = []
                for b in TIMED_BATCHES:
                    xb = eng.condition_input(images[:b])
                    if (path, rung, b) not in base_ms:
                        base_ms[(path, rung, b)] = device_ms(lambda: base(xb), PAD_REPS)[0]
                    ms = device_ms(lambda: eng(xb), PAD_REPS)[0]
                    cells.append(f"batch {b}: {ms:.4f} device ms per forward against "
                                 f"{base_ms[(path, rung, b)]:.4f} unpadded "
                                 f"({ms / base_ms[(path, rung, b)]:.3f}x)")
                log(f"  pad | {label} | " + "; ".join(cells) + f" ({card})")
    log(f"pad phase: {time.time() - t0:.1f} s wall; launches {total} ({card})")
    return total



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dp-cards", type=int, default=0,
                    help="run the dp phase alone, its ranks one per card over NCCL on this many "
                         "cards (at least 2)")
    ap.add_argument("--mp-cards", type=int, default=0,
                    help="run the tp, pp, xserve and tpqat phases alone, their ranks one per card "
                         "over NCCL on this many cards (at least 2, even), with their timings")
    args = ap.parse_args(argv)
    t_script = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi("name,power.limit")
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.time()
    build_logs = _build.build_all()
    log(f"build: {len(build_logs)} sources compiled in {time.time() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    if args.dp_cards:
        if not 2 <= args.dp_cards <= torch.cuda.device_count():
            print(f"chip_smoke: --dp-cards {args.dp_cards} with "
                  f"{torch.cuda.device_count()} card(s)", file=sys.stderr)
            return 1
        dp_phase(args.seed, card, device, world=args.dp_cards, backend="nccl")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0

    rng = np.random.RandomState(args.seed)
    images = torch.from_numpy(
        rng.rand(max(TIMED_BATCHES), IMAGE_SIZE, IMAGE_SIZE, 3).astype(np.float32)
    ).to(device)
    if args.mp_cards:
        n = args.mp_cards
        if not 2 <= n <= torch.cuda.device_count() or n % 2:
            print(f"chip_smoke: --mp-cards {n} with {torch.cuda.device_count()} card(s)",
                  file=sys.stderr)
            return 1
        engines = mp_engines(args.seed, images, device)
        mp_phase(engines, images, card, args.seed, device, world=n, backend="nccl", timed=True)
        xserve_phase(engines, card, args.seed, device, world=n, backend="nccl")
        tpqat_phase(args.seed, card, device, world=n, backend="nccl", meshes=[(1, n), (2, n // 2)])
        log(f"chip_smoke --mp-cards {n}: {time.time() - t_script:.1f} s wall ({card})")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0
    strict = {path: check_path(path, args.seed, images, device) for path in LAUNCHES_PER_FORWARD}
    paths = {path: r[:3] for path, r in strict.items()}
    # every forward: (path, rung) -> (engine, launches, checked calls); rung
    # None is the strict one
    forwards = {(path, None): r for path, r in paths.items()}
    for path in LAUNCHES_PER_FORWARD:
        for rung in RUNGS:
            forwards[(path, rung)] = check_rung(path, rung, strict[path], images)

    for (path, rung), (_, counts, checked) in forwards.items():
        n = k7_against_k1(checked)
        if n != counts["int8_gemm_v2"]:
            raise AssertionError(f"{path}: {n} of {counts['int8_gemm_v2']} K7 calls held to K1")
        log(f"{path} {RUNGS.get(rung, 'strict')}: all {n} int8_gemm_v2 calls bitwise equal to "
            f"int8_gemm on the same inputs")
    flat, flat_counts = flat_phase(paths)
    for label, k6_calls, _ in flat:
        log(f"kernel conv_flat_int8 {label}: {len(k6_calls)} call(s) equal to its plain version "
            f"on every row and, unpacked, to conv_int8")

    # K1's requant8 epilogue at ResNet-50's 1x1-conv shape (M = 8*56*56,
    # K = 64, N = 256): checked and timed, not a main-path call
    g = torch.Generator(device="cpu").manual_seed(args.seed)
    extra = (
        torch.randint(-128, 128, (8 * 56 * 56, 64), generator=g, dtype=torch.int8).to(device),
        torch.randint(-40, 41, (64, 256), generator=g, dtype=torch.int8).to(device),
        torch.randint(-(1 << 14), 1 << 14, (256,), generator=g, dtype=torch.int32).to(device),
    )
    extra_kw = dict(epilogue="requant8", net=9, out_signed=False)
    extra_out, _ = compare("int8_gemm", extra, extra_kw)
    log(f"kernel int8_gemm {describe(extra, extra_kw)}: equal to its plain version")

    bake_counts, bake_calls, baked = bake_phase(args.seed, images, card)
    log(f"resnet18 baked: all {len(bake_calls)} kernel calls equal to their plain versions; "
        f"launches {bake_counts}")

    t0 = time.time()
    traffic = serve_traffic(args.seed)
    serve_counts = {name: 0 for name in KERNELS}
    for rung, label in ((None, "resnet18 strict"), ("bf16_boundary", "resnet18 bf16")):
        counts = serve_rung(label, forwards[("resnet18", rung)][0], traffic, card)
        serve_counts = {k: serve_counts[k] + counts[k] for k in KERNELS}
    t1 = time.time()
    export_phase(*baked, images, card)
    log(f"serve and export phases: {t1 - t0:.1f} s and {time.time() - t1:.1f} s wall ({card})")

    clocks = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
    log(f"clocks before timing ({clocks}): {smi(clocks)}")
    table = timing_phase(forwards, paths, (flat, flat_counts), (extra, extra_kw, extra_out),
                         images, device, card)
    log(f"clocks after timing ({clocks}): {smi(clocks)}")
    pad_launches = pad_phase(forwards, images, card, device)
    t0 = time.time()
    train_launches, _, train_calls = train_phase(args.seed, card, device)
    log(f"train phase: {time.time() - t0:.1f} s wall; the int_op_only CLI run launched "
        f"{train_launches}; all {len(train_calls)} kernel calls of chip_smoke's engine on the "
        f"trained checkpoint equal to their plain versions ({card})")
    bf16_launches, bf16_calls = bf16train_phase(args.seed, images, card, device)
    log(f"bf16train: the flag-trained bake's engine launched {bf16_launches}; all "
        f"{len(bf16_calls)} kernel calls equal to their plain versions ({card})")
    dp_phase(args.seed, card, device)
    tpqat_launches = tpqat_phase(args.seed, card, device)
    mp_launches = mp_phase(forwards, images, card, args.seed, device)
    xserve_launches = xserve_phase(forwards, card, args.seed, device)
    kernels = []
    for name, k in KERNELS.items():
        row = table[name]
        extra_keys = {key: row[key] for key in ("k1_ms", "k2_ms") if key in row}
        kernels.append(dict(
            name=name, route="cuda", source=k["source"], replaces=k["replaces"],
            launches=sum(counts[name] for _, counts, _ in forwards.values())
            + sum(counts[name] for counts in flat_counts.values()),
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"],
            bound_by="bytes" if row["t_bytes"] > row["t_ops"] else "operations",
            library_ms=row["library_ms"], **extra_keys, serve_launches=serve_counts[name],
            tp_launches=mp_launches["tp"][name], pp_launches=mp_launches["pp"][name],
            xserve_launches=xserve_launches[name], tpqat_launches=tpqat_launches[name],
            pad_launches=pad_launches[name], bf16train_launches=bf16_launches[name],
            by_path=row["by_path"],
        ))
    log(f"chip_smoke: {time.time() - t_script:.1f} s wall ({card})")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
