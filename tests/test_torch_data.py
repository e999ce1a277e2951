"""The port's input pipeline, flags, meters, importers, fraclen report and
parity harness against the JAX package's.

All exact: the Loader's batches bitwise equal to the JAX Loader's on each
of its paths -- native (JPEG decoded by libjpeg or PIL, resized in C++)
and PIL (both packages' native libraries switched off by monkeypatching
their `native.imageops_available`) -- `from_flags` field for field on
every YAML under configs/, the importers' params bitwise, the fraclen
report's text line for line, and the parity dry run's integize and
int_op_only modes equal.
"""

import dataclasses
import glob
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

import f8net_tpu.data as jax_data
import f8net_tpu.importers as jax_importers
import f8net_tpu.native as jax_native
from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.nn.spec import ConvBNSpec as JaxConvBNSpec
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu.utils import flags as jax_flags
from f8net_tpu.utils import meters as jax_meters
from f8net_tpu.utils.reporting import fraclen_report as jax_fraclen_report
from f8net_tpu_torch import data as port_data
from f8net_tpu_torch import importers as port_importers
from f8net_tpu_torch import native as port_native
from f8net_tpu_torch.export import qat_from_numpy, qat_to_numpy
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.parity import MODES, evaluate_parity, print_table
from f8net_tpu_torch.utils import QuantConfig, flags as port_flags, meters as port_meters
from f8net_tpu_torch.utils.reporting import fraclen_report, parse_fraclen_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QAT = dict(format_from_metric=True, metric="std")


@pytest.fixture
def pil_only(monkeypatch):
    """Both Loaders on their PIL paths."""
    monkeypatch.setattr(jax_native, "imageops_available", lambda: False)
    monkeypatch.setattr(port_native, "imageops_available", lambda: False)


def _same_batches(port_loader, jax_loader):
    got, want = list(port_loader), list(jax_loader)
    assert len(got) == len(want) == len(port_loader) == len(jax_loader)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype == np.float32 and gl.dtype == wl.dtype == np.int32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    return got


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("normalize", [False, True])
def test_loader_synthetic_equals_jax(pil_only, train, normalize):
    kw = dict(batch_size=5, train=train, normalize=normalize, image_size=24, num_workers=3,
              seed=11)
    for shard in (0, 1):
        ports = port_data.Loader(port_data.SyntheticDataset(23, 40, 7, seed=2), shard=shard,
                                 num_shards=2, **kw)
        jaxs = jax_data.Loader(jax_data.SyntheticDataset(23, 40, 7, seed=2), shard=shard,
                               num_shards=2, **kw)
        for epoch in (0, 3):
            ports.set_epoch(epoch)
            jaxs.set_epoch(epoch)
            got = _same_batches(ports, jaxs)
            assert sum(len(b[1]) for b in got) == (12 if shard == 0 else 11)
            assert ports.path == "pil"


def _image_folder(root, ext):
    rng = np.random.RandomState(0 if ext == "png" else 1)
    for i in range(14):
        h, w = (50, 37) if i % 2 else (33, 61)
        d = os.path.join(root, f"class{i % 3}")
        os.makedirs(d, exist_ok=True)
        img = Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8))
        img.save(os.path.join(d, f"im{i:02d}.{ext}"), **({"quality": 85} if ext == "jpg" else {}))
    return root


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_loader_image_folder_equals_jax(pil_only, tmp_path, ext):
    root = _image_folder(str(tmp_path / ext), ext)
    pds, jds = port_data.ImageFolderDataset(root), jax_data.ImageFolderDataset(root)
    assert pds.samples == jds.samples and pds.classes == jds.classes
    for train in (True, False):
        for shard in (0, 1):
            kw = dict(batch_size=4, train=train, image_size=32, shard=shard, num_shards=2,
                      num_workers=2, seed=5)
            _same_batches(port_data.Loader(pds, **kw), jax_data.Loader(jds, **kw))


def _native_tree(root, ext, seed=3):
    """An ImageFolder tree for the native path: sizes from 33 to 201 px;
    among the JPEGs one CMYK file, which the native decoder rejects and
    both packages take through PIL."""
    rng = np.random.RandomState(seed)
    sizes = [(200, 150), (47, 61), (150, 201), (90, 120), (64, 40), (180, 180), (33, 75)]
    for i in range(13):
        h, w = sizes[i % len(sizes)]
        d = os.path.join(root, f"class{i % 3}")
        os.makedirs(d, exist_ok=True)
        img = Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8))
        if ext == "jpg":
            img = img.convert("CMYK") if i == 4 else img
            img.save(os.path.join(d, f"im{i:02d}.jpg"), quality=85)
        else:
            img.save(os.path.join(d, f"im{i:02d}.png"))
    return root


@pytest.mark.parametrize("ext", ["png", "jpg"])
@pytest.mark.parametrize("normalize", [False, True])
def test_loader_native_equals_jax(tmp_path, ext, normalize):
    """The port's Loader on its native path against the JAX Loader on its
    own (not forced to PIL): train and eval, shards 0 and 1 of 2, two
    epochs, bitwise."""
    root = _native_tree(str(tmp_path / ext), ext)
    pds, jds = port_data.ImageFolderDataset(root), jax_data.ImageFolderDataset(root)
    assert jax_native.imageops_available() and jax_native.jpeg_available()
    for train in (True, False):
        for shard in (0, 1):
            kw = dict(batch_size=3, train=train, normalize=normalize, image_size=16,
                      shard=shard, num_shards=2, num_workers=2, seed=5, decode_threads=2)
            ports, jaxs = port_data.Loader(pds, **kw), jax_data.Loader(jds, **kw)
            for epoch in (0, 1):
                ports.set_epoch(epoch)
                jaxs.set_epoch(epoch)
                got = _same_batches(ports, jaxs)
                assert ports.path == "native_jpeg"
                assert sum(len(b[1]) for b in got) == (7 if shard == 0 else 6)


@pytest.mark.parametrize("train", [True, False])
def test_loader_native_synthetic_and_forced_pil_decode_equal_jax(monkeypatch, tmp_path, train):
    """A dataset of PIL images (no file bytes) takes the native resize with
    PIL's decode, as does an ImageFolder where the library has no JPEG
    decode (both packages' `native.jpeg_available` switched off, as on a
    host without libjpeg); both bitwise the JAX Loader's under the same
    conditions."""
    kw = dict(batch_size=4, train=train, normalize=True, image_size=24, num_workers=2, seed=2)
    ports = port_data.Loader(port_data.SyntheticDataset(10, 40, 7, seed=4), **kw)
    _same_batches(ports, jax_data.Loader(jax_data.SyntheticDataset(10, 40, 7, seed=4), **kw))
    assert ports.path == "native"
    monkeypatch.setattr(jax_native, "jpeg_available", lambda: False)
    monkeypatch.setattr(port_native, "jpeg_available", lambda: False)
    root = _native_tree(str(tmp_path / "jpg"), "jpg")
    kw.update(image_size=16)
    ports = port_data.Loader(port_data.ImageFolderDataset(root), **kw)
    _same_batches(ports, jax_data.Loader(jax_data.ImageFolderDataset(root), **kw))
    assert ports.path == "native"


def test_loader_raises_a_workers_error(monkeypatch):
    """A worker's exception reaches the consumer (the reference's Loader
    would wait for the worker forever)."""
    def broken(*a, **k):
        raise OSError("unreadable")

    ds = port_data.SyntheticDataset(8, 16, 3)
    monkeypatch.setattr(ds, "load", broken)
    with pytest.raises(RuntimeError, match="worker") as err:
        list(port_data.Loader(ds, batch_size=2, image_size=16, num_workers=2))
    assert isinstance(err.value.__cause__, OSError)


def test_loader_stops_its_workers_when_left_early():
    before = set(threading.enumerate())
    ld = port_data.Loader(port_data.SyntheticDataset(64, 16, 3), batch_size=2, image_size=16,
                          num_workers=2)
    it = iter(ld)
    next(it)
    started = set(threading.enumerate()) - before
    it.close()  # as a finetune_iters break does: the workers were blocked on a full queue
    assert started and not any(t.is_alive() for t in started)


def _yamls():
    return sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yml"), recursive=True))


def test_from_flags_equals_jax_on_every_config():
    paths = _yamls()
    assert len(paths) >= 36
    for path in paths:
        for bs in (None, 64, 1024):
            q, t, e = port_flags.load_experiment(path, bs)
            jq, jt, je = jax_flags.load_experiment(path, bs)
            assert dataclasses.asdict(q) == dataclasses.asdict(jq), path
            assert dataclasses.asdict(t) == dataclasses.asdict(jt), path
            assert e == je, path
            assert port_flags.experiment_setting(q, t, e) == jax_flags.experiment_setting(jq, jt, je)
    assert port_flags.parse_argv(["app:x.yml", "bs:8", "device:cpu"]) == jax_flags.parse_argv(
        ["app:x.yml", "bs:8", "device:cpu"])


def test_meters_equal_jax():
    values = [0.1, 0.25, 1.0 / 3.0, 2.5]
    for reduction in ("avg", "sum", "max", "min"):
        pm, jm = port_meters.ScalarMeter("x"), jax_meters.ScalarMeter("x")
        pm.cache_list(values)
        jm.cache_list(values)
        assert port_meters.flush_scalar_meters({"x": pm}, reduction) == \
            jax_meters.flush_scalar_meters({"x": jm}, reduction)


# -- importers ---------------------------------------------------------------------


def _port_init(name, classes=10, size=32):
    model = get_model(name, QuantConfig(**QAT), num_classes=classes, image_size=size)
    params, state = model.init(torch.Generator().manual_seed(3), device="cpu")
    jmodel = jax_get_model(name, JaxQuantConfig(**QAT), classes, size)
    return model, jmodel, params, state


def _same_import(port_out, jax_out):
    (pp, ps), (jp, js) = port_out, jax_out
    for got, want in ((pp, jp), (ps, js)):
        assert list(got) == list(want)
        for lname, sub in want.items():
            assert set(got[lname]) == set(sub), lname
            for k, v in sub.items():
                assert got[lname][k].dtype == torch.float32, (lname, k)
                np.testing.assert_array_equal(got[lname][k].numpy(), np.asarray(v),
                                              err_msg=f"{lname}/{k}")


def _reference_sd(model, rng):
    """A reference F8Net state dict (torch names and layouts), random."""
    sd = {}
    for lname in model.graph.names():
        spec = model.graph[lname]
        r = f"{lname}.0" if lname in ("head", "tail", "classifier") else lname
        if isinstance(spec, JaxConvBNSpec):
            kh, kw = spec.kernel
            sd[f"{r}.conv.weight"] = rng.randn(spec.out_ch, spec.in_ch // spec.groups, kh, kw)
            for suffix in ("bn.weight", "bn.bias", "bn.running_mean"):
                sd[f"{r}.{suffix}"] = rng.randn(spec.out_ch)
            sd[f"{r}.bn.running_var"] = np.abs(rng.randn(spec.out_ch)) + 0.5
            sd[f"{r}.alpha"] = np.float64(rng.rand() * 10)
            sd[f"{r}.input_fraclen"] = np.float32(rng.randint(0, 8))
        else:
            sd[f"{r}.weight"] = rng.randn(spec.out_features, spec.in_features)
            sd[f"{r}.bias"] = rng.randn(spec.out_features)
            sd[f"{r}.alpha"] = np.float32(3.0)
            sd[f"{r}.input_fraclen"] = np.float32(5.0)
    return {f"module.{k}": np.asarray(v, np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("name", ["mobilenet_v2", "resnet18"])
def test_reference_checkpoint_import_equals_jax(name, tmp_path):
    """The reference dialect, as a state dict and as a torch.save'd
    {'model': ...} file read with weights_only."""
    model, jmodel, params, state = _port_init(name)
    pnp, snp = qat_to_numpy(params, state)
    sd = _reference_sd(jmodel, np.random.RandomState(0))
    want = jax_importers.load_reference_checkpoint(jmodel, sd, pnp, snp)
    _same_import(port_importers.load_reference_checkpoint(model, sd, params, state), want)
    path = str(tmp_path / "best_model.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "last_epoch": 9}, path)
    _same_import(port_importers.load_reference_checkpoint(model, path, params, state), want)


def _plain_sd(jmodel, rng, extra=False):
    """pytorchcv-style (features.i.conv / bn, output) state dict; with
    `extra`, HAWQ's quantization entries beside each weight."""
    sd = {}
    for i, lname in enumerate(jmodel.conv_order):
        spec = jmodel.graph[lname]
        if isinstance(spec, JaxConvBNSpec):
            kh, kw = spec.kernel
            sd[f"features.{i}.conv.weight"] = rng.randn(spec.out_ch, spec.in_ch // spec.groups,
                                                        kh, kw)
            if extra:
                sd[f"features.{i}.conv.weight_integer"] = np.round(rng.randn(spec.out_ch) * 9)
                sd[f"features.{i}.conv.conv_scaling_factor"] = rng.rand(spec.out_ch)
                sd[f"features.{i}.quant_act.x_min"] = np.float32(-1)
                sd[f"features.{i}.quant_act.x_max"] = np.float32(1)
            for suffix in ("weight", "bias", "running_mean"):
                sd[f"features.{i}.bn.{suffix}"] = rng.randn(spec.out_ch)
            sd[f"features.{i}.bn.running_var"] = np.abs(rng.randn(spec.out_ch)) + 0.5
            sd[f"features.{i}.bn.num_batches_tracked"] = np.int64(7)
        else:
            sd["output.weight"] = rng.randn(spec.out_features, spec.in_features)
            sd["output.bias"] = rng.randn(spec.out_features)
    return {k: np.asarray(v).astype(np.int64 if k.endswith("tracked") else np.float32)
            for k, v in sd.items()}


def test_ptcv_and_hawq_import_equal_jax(tmp_path):
    model, jmodel, params, state = _port_init("mobilenet_v1")
    pnp, snp = qat_to_numpy(params, state)
    sd = _plain_sd(jmodel, np.random.RandomState(1))
    entries = port_importers.parse_plain_cnn_state_dict(sd)
    jentries = jax_importers.parse_plain_cnn_state_dict(sd)
    assert [e[0] for e in entries] == [e[0] for e in jentries]
    _same_import(port_importers.load_ordered_conv_bn_fc(model, entries, params, state),
                 jax_importers.load_ordered_conv_bn_fc(jmodel, jentries, pnp, snp))
    # the same dict from a .pt file
    path = str(tmp_path / "ptcv.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    loaded = port_importers.load_torch_file(path)
    assert list(loaded) == list(sd) and all(np.array_equal(loaded[k], sd[k]) for k in sd)
    hawq = _plain_sd(jmodel, np.random.RandomState(2), extra=True)
    _same_import(port_importers.load_hawq_checkpoint(model, hawq, params, state),
                 jax_importers.load_hawq_checkpoint(jmodel, hawq, pnp, snp))
    bad = list(entries)
    bad[0] = ("conv", np.zeros((10, 3, 7, 7), np.float32), None)
    with pytest.raises(AssertionError):
        port_importers.load_ordered_conv_bn_fc(model, bad, params, state)


def _nvidia_name(lname):
    """Our ResNet-50 layer name -> its NVIDIA DeepLearningExamples prefix."""
    if lname == "head":
        return "conv1", "bn1"
    if lname == "classifier":
        return "fc", None
    stage, layer = lname.split(".")[0].split("_")[1::2]
    block = f"layer{int(stage) + 1}.{layer}"
    if ".shortcut." in lname:
        return f"{block}.downsample.0", f"{block}.downsample.1"
    k = int(lname.split(".")[-1]) + 1
    return f"{block}.conv{k}", f"{block}.bn{k}"


def test_nvidia_import_equals_jax():
    model, jmodel, params, state = _port_init("resnet50", size=32)
    pnp, snp = qat_to_numpy(params, state)
    rng = np.random.RandomState(3)
    sd = {}
    for lname in jmodel.conv_order:
        spec = jmodel.graph[lname]
        conv, bn = _nvidia_name(lname)
        if bn is None:
            sd["fc.weight"] = rng.randn(spec.out_features, spec.in_features).astype(np.float32)
            sd["fc.bias"] = rng.randn(spec.out_features).astype(np.float32)
            continue
        kh, kw = spec.kernel
        sd[f"{conv}.weight"] = rng.randn(spec.out_ch, spec.in_ch, kh, kw).astype(np.float32)
        for suffix in ("weight", "bias", "running_mean"):
            sd[f"{bn}.{suffix}"] = rng.randn(spec.out_ch).astype(np.float32)
        sd[f"{bn}.running_var"] = (np.abs(rng.randn(spec.out_ch)) + 0.5).astype(np.float32)
        sd[f"{bn}.num_batches_tracked"] = np.int64(3)
    entries = port_importers.parse_nvidia_state_dict(sd)
    jentries = jax_importers.parse_nvidia_state_dict(sd)
    assert len(entries) == len(jentries) == 2 * 53 + 1
    _same_import(port_importers.load_ordered_conv_bn_fc(model, entries, params, state),
                 jax_importers.load_ordered_conv_bn_fc(jmodel, jentries, pnp, snp))


# -- fraclen report and parity harness ---------------------------------------------------


def test_fraclen_report_text_equals_jax():
    """Both reports on the same (params, state), EMA fraclens, alphas and
    BN statistics spread from their init, line for line."""
    cfg = dict(QAT, quant_avgpool=True, pool_fusing=True)
    model = get_model("mobilenet_v2", QuantConfig(**cfg), num_classes=10, image_size=32)
    params, state = model.init(torch.Generator().manual_seed(4), device="cpu")
    rng = np.random.RandomState(4)
    pnp, snp = qat_to_numpy(params, state)
    for lname in pnp:
        pnp[lname]["alpha"] = np.float32(rng.uniform(2, 10))
        snp[lname]["input_fl_ema"] = rng.uniform(2, 7, snp[lname]["input_fl_ema"].shape).astype(
            np.float32)
        if "bn_var" in snp[lname]:
            snp[lname]["bn_mean"] = rng.randn(*snp[lname]["bn_mean"].shape).astype(np.float32)
            snp[lname]["bn_var"] = rng.uniform(0.5, 2, snp[lname]["bn_var"].shape).astype(
                np.float32)
    got, want = [], []
    fraclen_report(model, *qat_from_numpy(pnp, snp, device="cpu"), print_fn=got.append)
    jmodel = jax_get_model("mobilenet_v2", JaxQuantConfig(**cfg), 10, 32)
    jax_fraclen_report(jmodel, pnp, snp, print_fn=want.append)
    assert got == want
    assert sum(ln.startswith("weight_fraclen:") for ln in got) == len(model.graph.names())
    parsed = parse_fraclen_report("\n".join(got))
    assert list(parsed) == model.graph.names()


def test_parity_dry_run_on_cpu(capsys):
    results, total, fraclen_check = evaluate_parity(
        "resnet18", "conventional", synthetic=True, batch_size=8, limit_batches=2,
        image_size=32, num_classes=16, device="cpu",
    )
    assert total == 16 and fraclen_check is None and set(results) == set(MODES)
    for m in MODES:
        assert 0.0 <= results[m]["top1"] <= results[m]["top5"] <= 100.0
    assert results["integize"] == results["int_op_only"]
    print_table("resnet18", "conventional", results, total)
    out = capsys.readouterr().out
    assert "71.0" in out and "int_op_only" in out and "cross-mode top-1 spread" in out


@pytest.mark.parametrize("name", ["resnet18", "mobilenet_v2", "resnet50"])
def test_profiling_flops_equal_jax_and_device_numbers_need_a_card(name, tmp_path):
    """model_flops equal to the JAX package's; on the CPU the card's
    numbers are refused (steady_state_time raises, the roofline share is
    NaN) and the profiler scope still writes its trace."""
    from f8net_tpu.utils.profiling import model_flops as jax_model_flops
    from f8net_tpu_torch.utils import profiling

    model = get_model(name, QuantConfig(**QAT), num_classes=1000, image_size=224)
    jmodel = jax_get_model(name, JaxQuantConfig(**QAT), 1000, 224)
    flops = profiling.model_flops(model, 224, 8)
    assert flops == jax_model_flops(jmodel, 224, 8) > 1e9
    assert profiling.chip_kind("cpu") == "cpu"
    achieved, share = profiling.speed_of_light(model, 224, 8, 0.01, device="cpu")
    assert achieved == flops / 0.01 / 1e12 and np.isnan(share)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profiling.steady_state_time(lambda: None)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("step"):
            torch.ones(4).sum()
    assert prof is not None and os.listdir(tmp_path / "trace")
