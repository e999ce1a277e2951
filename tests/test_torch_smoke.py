"""CPU rehearsal of chip_smoke.py's phases at a small size, for each main
path: the synthetic bundle round trip, the engine run twice (kernels'
wrappers and plain versions, which are the same code on the CPU), the
comparisons with the float network, the recorded kernel calls of one
forward, and the non-degenerate activations the calibration promises."""

import numpy as np
import torch

import chip_smoke
from f8net_tpu_torch.engine import IntEngine


def _rehearse(path, n_requants):
    images = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    model, plan, params, float_logits = chip_smoke.load_synthetic_model(
        0, 64, 10, "cpu", images, model_name=path
    )
    assert model.name == path and float_logits.shape == (2, 10)
    eng = IntEngine(model, plan, params, device="cpu")
    logits, ref, counts, calls, stats = chip_smoke.engine_phase(eng, eng.condition_input(images))
    chip_smoke.check_logits(logits, ref, 2, 10)
    chip_smoke.float_agreement(path, logits, plan, float_logits)
    chip_smoke.block_errors(path, eng, images)
    assert not {"block", "block_mbv2"} & set(vars(eng))  # the hook is gone again
    assert counts == {name: 0 for name in chip_smoke.KERNELS}  # the CPU launches no kernel
    names = [c[0] for c in calls]
    assert {n: names.count(n) for n in set(names)} == chip_smoke.LAUNCHES_PER_FORWARD[path]
    for name, args, kw in calls:
        out, err = chip_smoke.compare(name, args, kw)
        nb, ops = chip_smoke.work(name, args, kw, out)
        assert err == 0 and nb > 0 and ops > 0
        assert chip_smoke.describe(args, kw)
    assert len(stats) == n_requants
    for name, clamped, zero in stats:
        assert clamped < chip_smoke.MAX_CLAMPED and zero < chip_smoke.MAX_ZERO, (name, clamped, zero)


def test_smoke_phases_on_cpu():
    # ResNet-18, 20 requants: 8 fused epilogues, 8 block-input packs for
    # body.0, 3 for the shortcuts, 1 for the classifier
    _rehearse("resnet18", 20)


def test_smoke_mobilenet_v2_phases_on_cpu():
    # MobileNetV2, 50 requants: 10 fused epilogues of the 5 per-layer blocks,
    # 15 packs of an int32 block output for the next block's first conv
    # (10 residual K5 blocks, 2 other K5 blocks, 3 stride-2 blocks), 1 for
    # the classifier, and 2 inside each of the 12 K5 blocks
    _rehearse("mobilenet_v2", 50)
