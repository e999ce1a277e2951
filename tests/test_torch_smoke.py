"""CPU rehearsal of chip_smoke.py's phases at a small size, for each main
path: the synthetic bundle round trip, the engine run twice (kernels'
wrappers and plain versions, which are the same code on the CPU), the
comparisons with the float network, the recorded kernel calls of one
forward, and the non-degenerate activations the calibration promises; the
serve and export phases on ResNet-18 with fewer, smaller requests; the
offline tools' step."""

import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

import chip_smoke
from f8net_tpu_torch.engine import IntEngine
from f8net_tpu_torch.models import get_model


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
    # MobileNetV2, 51 requants: 10 fused epilogues of the 5 per-layer blocks,
    # 15 packs of an int32 block output for the next block's first conv
    # (10 residual K5 blocks, 2 other K5 blocks, 3 stride-2 blocks), 1 for
    # the classifier, 2 inside each of the 12 K5 blocks, and the requant8
    # output of the one K5 block that packs for its unique consumer
    _rehearse("mobilenet_v2", 51)


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
    flat, flat_counts = chip_smoke.flat_phase(paths)
    assert list(flat_counts) == ["resnet50", "resnet18"]
    assert all(n == 0 for counts in flat_counts.values() for n in counts.values())  # no card
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


# 8-bit operands the clamp and zero gates see per forward of each relaxed
# rung at 64 px, where every shortcut reads the same grid as its block's
# body.0 (so no repack):
#   int8: ResNet-18 17 = 8 fused epilogues + the stem's pack + 7 block
#   outputs packed for the next block + the classifier's pack; ResNet-50 49
#   = 32 + 1 + 15 + 1; MobileNetV2 51 = 10 fused epilogues of the per-layer
#   blocks + the 4 stride-2 blocks' outputs packed for the residual block
#   after them + the classifier's pack + 2 inside each of the 12 K5 blocks +
#   the 12 K5 outputs, all requant8 (10 of them packed carries);
#   bf16: the strict rung's counts (ResNet-18 20, MobileNetV2 51, ResNet-50
#   53), each pack of an int32 block output now a pack of a bf16 value.
RUNG_REQUANTS = {
    "resnet18": {"int8": 17, "bf16": 20},
    "mobilenet_v2": {"int8": 51, "bf16": 51},
    "resnet50": {"int8": 49, "bf16": 53},
}


@pytest.mark.parametrize("path", ["resnet18", "mobilenet_v2", "resnet50"])
def test_smoke_rung_phases_on_cpu(path, capsys):
    """chip_smoke.py's phases of the relaxed rungs on the CPU: each rung's
    forward through the wrappers and through the plain versions (the same
    code here), every recorded call against its plain version, the kernel
    calls per forward of the strict table, the clamp and zero gates on
    every 8-bit operand, K7 against K1, the distances to the strict and
    float logits, and K5's new forms where MobileNetV2 calls it."""
    images = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    model, plan, params, float_logits = chip_smoke.load_synthetic_model(
        0, 64, 10, "cpu", images, model_name=path
    )
    eng = IntEngine(model, plan, params, device="cpu")
    logits, counts, checked = chip_smoke.drive(path, path, eng, images)
    strict = (eng, counts, checked, logits, float_logits)
    for rung in chip_smoke.RUNGS:
        reng, rcounts, rchecked = chip_smoke.check_rung(path, rung, strict, images)
        assert getattr(reng, rung) and rcounts == {name: 0 for name in chip_smoke.KERNELS}
        names = [c[0] for c in rchecked]
        assert {n: names.count(n) for n in set(names)} == chip_smoke.LAUNCHES_PER_FORWARD[path]
        assert all(err == 0 for *_, err in rchecked)
        assert chip_smoke.k7_against_k1(rchecked) == chip_smoke.LAUNCHES_PER_FORWARD[path].get(
            "int8_gemm_v2", 0)
        forms = {(chip_smoke.k5_carry(a), kw["out"]) for n, a, kw, _, _ in rchecked
                 if n == "ir_block"}
        if path == "mobilenet_v2":
            assert forms == ({("int8", "requant8"), ("none", "requant8")}
                             if rung == "int8_boundary" else {("none", "bf16"), ("none", "requant8")})
    out = capsys.readouterr().out
    for rung in chip_smoke.RUNGS.values():
        gated = [ln for ln in out.splitlines() if ln.startswith(f"  {path} {rung} requant -> ")]
        assert len(gated) == RUNG_REQUANTS[path][rung], (rung, len(gated))
        assert f"{path} {rung} engine: top-1 agreement with the strict rung" in out
        assert f"{path} {rung} engine: top-1 agreement with the float network" in out


def test_serve_and_export_phases_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's serve phase in both rungs (3 clients of 4 requests
    of 32-px images, buckets (2, 4, 8), an int32 request in four, one of 13
    images; one round in the measured window) and its export phase, on the
    CPU: every check of the card's run but the launch counts, the pipeline's
    overlap on the card and the profiler's busy share."""
    for name, value in dict(SERVE_BUCKETS=(2, 4, 8), SERVE_RING=32, SERVE_CLIENTS=3,
                            SERVE_REQUESTS=4, SERVE_COPY_EVERY=4, SERVE_OVERSIZED=13,
                            SERVE_TRICKLE=2, SERVE_ROUNDS=1).items():
        monkeypatch.setattr(chip_smoke, name, value)
    images = torch.from_numpy(np.random.RandomState(0).rand(8, 32, 32, 3).astype(np.float32))
    model, plan, params, _ = chip_smoke.load_synthetic_model(0, 32, 10, "cpu", images)
    traffic = chip_smoke.serve_traffic(0, image_size=32)
    trickle, clients = traffic
    assert [len(c) for c in clients] == [5, 4, 4] and sum(r.dtype == np.int32 for c in clients
                                                          for r in c) == 3
    ids = np.concatenate([chip_smoke.image_id(r) for r in trickle + clients[0]])
    assert len(set(ids.tolist())) == len(ids)
    for rung in (None, "bf16_boundary"):
        eng = IntEngine(model, plan, params, device="cpu", **({rung: True} if rung else {}))
        counts = chip_smoke.serve_rung(f"resnet18 {rung}", eng, traffic, "cpu")
        assert counts == {name: 0 for name in chip_smoke.KERNELS}
    eng = IntEngine(model, plan, params, device="cpu")
    chip_smoke.export_phase(model, plan, params, eng, images, "cpu")
    out = capsys.readouterr().out
    assert out.count("requests bitwise equal to the engine on their images alone") == 1
    assert "export: TorchScript at 32 px bitwise equal" in out
    assert "export: F8NB bundle read back" in out


def test_train_phase_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's train phase on the CPU at 32 px, 16 classes, batch 8:
    the overfit, the update rule (here the CPU against itself), the CLI's
    train, resume, bn-calib and int_op_only runs with their checkpoint
    checks, chip_smoke's own engine on the trained checkpoint against the
    CLI's engine (input and logits bitwise) and top-1 error, and the parity
    dry run (integize's logits bitwise int_op_only's); not the card's
    timings and launch counts."""
    for name, value in dict(TRAIN_BATCH=8, TRAIN_SYNTHETIC=32, TRAIN_WORKERS=2,
                            OVERFIT_STEPS=12, PARITY_BATCH=8,
                            TRAIN_OVERRIDES={"image_size": 32, "num_classes": 16}).items():
        monkeypatch.setattr(chip_smoke, name, value)
    _, counts, checked = chip_smoke.train_phase(0, "cpu", device="cpu")
    assert counts == {name: 0 for name in chip_smoke.KERNELS}
    names = [c[0] for c in checked]
    assert {n: names.count(n) for n in set(names)} == chip_smoke.LAUNCHES_PER_FORWARD["resnet18"]
    out = capsys.readouterr().out
    for want in ("train: overfit 8 images with random labels, 12 steps",
                 "bitwise equal to the CPU's", "wrote latest_checkpoint and best_model",
                 "Loaded checkpoint", "resumed at epoch 1", "train: bn_calib | Start calibration.",
                 "equal to chip_smoke's engine on the same bake",
                 "integize's logits bitwise equal to int_op_only's", "train: wall s per phase"):
        assert want in out, want


def test_dp_phase_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's dp phase on the CPU at 32 px, 16 classes, a global
    batch of 8 over two ranks (gloo): both ranks' steps bitwise alike and
    within the limits of one process's, the CLI on two ranks (rank 0 alone
    writes, the resume loads what was saved, the ranks' params equal) and
    at world size 1 through init_dist."""
    for name, value in dict(TRAIN_BATCH=8, DP_BATCH=8, TRAIN_SYNTHETIC=16, TRAIN_WORKERS=1,
                            TRAIN_OVERRIDES={"image_size": 32, "num_classes": 16}).items():
        monkeypatch.setattr(chip_smoke, name, value)
    chip_smoke.dp_phase(0, "cpu", device="cpu")
    out = capsys.readouterr().out
    for kind in ("floating_wo_clip", "qat"):
        assert f"dp: {kind} step, 32 px, global batch 8 over 2 ranks" in out, kind
    for want in ("rank 0 alone wrote", "run.main at world size 1 in a gloo process group",
                 "dp phase:"):
        assert want in out, want


def test_tpqat_phase_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's tpqat phase on the CPU at 32 px, 16 classes, a
    global batch of 4 on a (1, 2) mesh of two gloo ranks, on the plain
    versions: both steps with the params out-channel sharded, every rank's
    gathered trees bitwise alike and within the dp phase's limits of one
    process's, the calibration and bake on the mesh, TPEngine bitwise
    IntEngine with every call held against its plain version and its
    table; not the card's launches."""
    for name, value in dict(DP_BATCH=4, TPQAT_TIMED_STEPS=1,
                            TRAIN_OVERRIDES={"image_size": 32, "num_classes": 16}).items():
        monkeypatch.setattr(chip_smoke, name, value)
    launches = chip_smoke.tpqat_phase(0, "cpu", device="cpu")
    assert launches == {name: 0 for name in chip_smoke.KERNELS}
    out = capsys.readouterr().out
    label = "tpqat (data, model) = (1, 2), 2 ranks sharing the card over gloo"
    for kind in ("floating_wo_clip", "qat"):
        assert f"{label}: {kind} step, 32 px, global batch 4, 21 of 21 layers cut" in out, kind
    for want in ("rank 1 QAT step wall ms", "TPEngine on the mesh bitwise equal to IntEngine",
                 "'all_gather': 41", "tpqat phase:"):
        assert want in out, want


def test_tools_phase_on_cpu(capsys):
    """chip_smoke.py's offline-tools step on the CPU: a ResNet-18 at 32 px
    from Model.init, the fits on the CPU against themselves, the folded
    weight stats and the profile table (one row per layer)."""
    model = get_model("resnet18", chip_smoke.CFG.replace(pool_fusing=False), num_classes=10,
                      image_size=32)
    params, state = model.init(torch.Generator().manual_seed(0), device="cpu")
    chip_smoke.tools_phase(model, params, state, "cpu")
    out = capsys.readouterr().out
    assert "tools: fit_all_metrics (n 10000) on cpu" in out and "signed std 45.1" in out
    assert "tools: folded_weight_stats of 20 convs within rtol 1e-6" in out
    assert "tools: profile_table of the card's fraclen report: 21 layers" in out
    assert "the CPU copy's table the same text" in out


def test_pad_phase_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's pad phase on the CPU at 32 px, batch 2, ResNet-18 and
    MobileNetV2 in every rung: the padded engines' calls against their plain
    versions, logits bitwise the unpadded engine's, the calls the padded
    routing's table; ResNet-18 pads nothing at 64; not the card's times."""
    paths = {p: chip_smoke.LAUNCHES_PER_FORWARD[p] for p in ("resnet18", "mobilenet_v2")}
    monkeypatch.setattr(chip_smoke, "LAUNCHES_PER_FORWARD", paths)
    monkeypatch.setattr(chip_smoke, "BATCH", 2)
    images = torch.from_numpy(np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32))
    forwards = {}
    for path in paths:
        model, plan, params, _ = chip_smoke.load_synthetic_model(0, 32, 10, "cpu", images,
                                                                 model_name=path)
        for rung in (None, *chip_smoke.RUNGS):
            forwards[(path, rung)] = (IntEngine(model, plan, params, device="cpu",
                                                **({rung: True} if rung else {})),)
    launches = chip_smoke.pad_phase(forwards, images, "cpu", "cpu")
    assert launches == {name: 0 for name in chip_smoke.KERNELS}
    out = capsys.readouterr().out
    for want in ("resnet18 strict pad 64: no channel below 64",
                 "resnet18 bf16 pad 128: 7 layers widened; all 21 kernel calls equal",
                 "mobilenet_v2 int8 pad 64: 14 layers widened; all 29 kernel calls equal",
                 "'int8_gemm_v2': 10, 'ir_block': 12, 'int8_gemm': 1}", "pad phase:"):
        assert want in out, want
    # MobileNetV2's rungs were padded at 64: at 128 the strict rung alone
    assert "mobilenet_v2 strict pad 128:" in out and "mobilenet_v2 int8 pad 128" not in out


def test_bf16train_phase_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's bf16train phase on the CPU at 32 px, batch 4, 16
    classes: every distinct QAT conv of ResNet-18 and MobileNetV2 with the
    flag within its bound of the float64 conv of the rounded operands, the
    train config's steps with the flag off and on, the flag-trained bake's
    engine against its plain path; not the card's times."""
    for name, value in dict(IMAGE_SIZE=32, TRAIN_BATCH=4, BATCH=2, BF16_ROUND_STEPS=1,
                            TRAIN_SYNTHETIC=16, TRAIN_WORKERS=1,
                            TRAIN_OVERRIDES={"image_size": 32, "num_classes": 16}).items():
        monkeypatch.setattr(chip_smoke, name, value)
    images = torch.from_numpy(np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32))
    counts, checked = chip_smoke.bf16train_phase(0, images, "cpu", "cpu")
    assert counts == {name: 0 for name in chip_smoke.KERNELS}
    names = [c[0] for c in checked]
    assert {n: names.count(n) for n in set(names)} == chip_smoke.LAUNCHES_PER_FORWARD["resnet18"]
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if ln.startswith("bf16train conv ")]
    assert all("small-grid operands bitwise the float64 conv" in ln for ln in rows)
    for path, layers in (("resnet18", 20), ("mobilenet_v2", 52)):  # every QAT conv once
        mine = [ln for ln in rows if ln.startswith(f"bf16train conv {path} ")]
        assert sum(int(ln.split("(x")[1].split(":")[0]) for ln in mine) == layers, path
    assert all("cudnn.benchmark off), bound 6.104e-05; the float32 conv" in ln for ln in rows)
    for want in ("bf16train conv resnet18 3->64 7x7/s2 at 32x32 (x1: head)",
                 "resnet18 bf16-trained engine: logits bitwise equal to the plain path",
                 "bf16train: the flag-trained ResNet-18 baked", "bf16train phase:",
                 "bf16train: run.main with train_conv_bf16 in its YAML trained"):
        assert want in out, want
