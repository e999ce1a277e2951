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


def test_smoke_resnet50_phases_on_cpu():
    # ResNet-50, 53 requants: 32 fused epilogues (body.0 -> body.1 and
    # body.1 -> body.2 in each of 16 blocks), 16 block-input packs for
    # body.0, 4 for the shortcuts (stage 0's 1x1/s1 and three 1x1/s2), 1 for
    # the classifier
    _rehearse("resnet50", 53)


def test_smoke_k7_and_flat_phases_on_cpu():
    """K1 on every K7 call of a ResNet-50 forward, and the K6 phase on the
    recorded activations of ResNet-50's 13 stride-1 3x3 convs and
    ResNet-18's 5 stride-1 BasicBlocks: on the CPU each call is the plain
    version, which must equal K2's plain version unpacked."""
    images = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    paths = {}
    for path in ("resnet18", "resnet50"):
        model, plan, params, _ = chip_smoke.load_synthetic_model(
            0, 64, 10, "cpu", images, model_name=path
        )
        eng = IntEngine(model, plan, params, device="cpu")
        _, _, counts, calls, _ = chip_smoke.engine_phase(eng, eng.condition_input(images))
        checked = [(n, a, kw, *chip_smoke.compare(n, a, kw)) for n, a, kw in calls]
        paths[path] = (eng, counts, checked)
    assert chip_smoke.k7_against_k1(paths["resnet50"][2]) == 33
    flat = chip_smoke.flat_phase(paths)
    assert [len(k6) for _, k6, _ in flat] == [1] * 13 + [2] * 5
    assert sum(label.startswith("resnet18") for label, _, _ in flat) == 5
    for _, k6, k2 in flat:
        assert len(k6) == len(k2)
        for (args, kw, out, err), (args2, kw2) in zip(k6, k2):
            nb, ops = chip_smoke.work("conv_flat_int8", args, kw, out)
            assert err == 0 and out.shape[0] == args[0].shape[0] and nb > 0 and ops > 0
            out2 = chip_smoke.KERNELS["conv_int8"]["plain"](*args2, **kw2)
            ops2 = chip_smoke.work("conv_int8", args2, kw2, out2)[1]
            # a masked ring's rows need no taps: then K6 does K2's operations
            assert ops == ops2 if kw["mask_pad"] else ops > ops2
