"""Timing and speed-of-light accounting on the card (the port of
`f8net_tpu/utils/profiling.py`).

Steady-state timers on CUDA events, per-model FLOP accounting, and a
model's achieved rate as a share of the card's published peak.  The peaks
are NVIDIA's data sheet for the H100 SXM (dense, no sparsity, at its full
700 W power limit); a card set to a lower limit runs below them, so state
its `nvidia-smi` power limit beside a share.  No other device has a peak
here: on any other device `speed_of_light` gives NaN for the share.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# NVIDIA H100 SXM data sheet, dense rates (operations per second)
H100_PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "tf32": 495e12, "float32": 67e12}
H100_HBM_BYTES_PER_S = 3.35e12


def chip_kind(device="cuda") -> str:
    """'h100' for an H100 card, else the card's name lowercased, or 'cpu'."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(dev).lower()
    return "h100" if "h100" in name else name


def steady_state_time(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Seconds per call of fn(*args) on the card: CUDA events around
    `iters` back-to-back calls after `warmup` calls.  Needs a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("steady_state_time times the card; no CUDA device found")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def conv_flops(spec, h_out: int, w_out: int, batch: int) -> float:
    kh, kw = spec.kernel
    return 2.0 * batch * h_out * w_out * spec.out_ch * kh * kw * (spec.in_ch // spec.groups)


def model_flops(model, image_size: int, batch: int) -> float:
    """MAC-based FLOP count of the conv/linear stack (2*MACs)."""
    total = 0.0
    g = model.graph
    head = g["head"]
    cur = (image_size + 2 * head.padding[0] - head.kernel[0]) // head.stride[0] + 1
    total += conv_flops(head, cur, cur, batch)
    if model.name.startswith("resnet"):
        cur = (cur + 2 * 1 - 3) // 2 + 1  # maxpool
    for meta in model.blocks:
        for cname in meta.body:
            spec = g[cname]
            cur = (cur + 2 * spec.padding[0] - spec.kernel[0]) // spec.stride[0] + 1
            total += conv_flops(spec, cur, cur, batch)
        sc = getattr(meta, "shortcut", None)
        if sc:
            total += conv_flops(g[sc], cur, cur, batch)
    if model.name == "mobilenet_v2":
        total += conv_flops(g["tail"], cur, cur, batch)
    cls = g["classifier"]
    total += 2.0 * batch * cls.in_features * cls.out_features
    return total


def speed_of_light(model, image_size: int, batch: int, seconds_per_batch: float,
                   dtype: str = "int8", device="cuda", bytes_per_batch: float = 0.0):
    """(achieved tera-operations per second, share of the H100's roofline)
    for a timed forward.  The roofline time is the larger of the forward's
    operations over the published dense peak for `dtype` and
    `bytes_per_batch` over 3.35 TB/s; the share is that time over the
    measured one, NaN on any other device."""
    flops = model_flops(model, image_size, batch)
    if chip_kind(device) != "h100":
        return flops / seconds_per_batch / 1e12, float("nan")
    bound = max(flops / H100_PEAK_OPS[dtype], bytes_per_batch / H100_HBM_BYTES_PER_S)
    return flops / seconds_per_batch / 1e12, bound / seconds_per_batch


@contextlib.contextmanager
def trace(log_dir: str = "f8net_trace"):
    """torch.profiler scope over the host and the card; writes a Chrome
    trace into `log_dir` and yields the profiler (its key_averages() give
    device time by kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{int(time.time())}.json"))


def annotate(name: str):
    """Named region for the profiler timeline."""
    return torch.profiler.record_function(name)

