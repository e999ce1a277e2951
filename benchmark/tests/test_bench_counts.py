"""Operations and bytes from the configurations' shapes."""

import json

import pytest

from benchmark.harness import counts
from benchmark.manifest import HERE


def cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_one_conv_by_hand():
    # ResNet-50's stage-0 3x3 conv: 56x56x64 -> 56x56x64, pad 1, batch 2
    c = cfg("resnet50")
    macs, nbytes = counts.layer_work(c, 224, 2)["stage_0_layer_0.body.1"]
    assert macs == 2 * 56 * 56 * 64 * (3 * 3 * 64)
    assert nbytes == 2 * 56 * 56 * 64 + 3 * 3 * 64 * 64 + 2 * 56 * 56 * 64
    # the head: 224 -> 112, 7x7 over 3 channels
    macs, nbytes = counts.layer_work(c, 224, 1)["head"]
    assert macs == 112 * 112 * 64 * 7 * 7 * 3
    assert nbytes == 224 * 224 * 3 + 7 * 7 * 3 * 64 + 112 * 112 * 64
    # a depthwise conv counts one input channel per output
    m = cfg("mobilenet_v2")
    macs, _ = counts.layer_work(m, 224, 1)["stage_1_layer_0.body.1"]
    assert macs == 56 * 56 * 96 * 9


@pytest.mark.parametrize("name,published", [("resnet50", 4.1e9), ("mobilenet_v2", 0.30e9)])
def test_macs_match_the_published_count(name, published):
    assert abs(counts.macs(cfg(name), 224) - published) < 0.02 * published


def test_bound_takes_the_larger_of_compute_and_bytes():
    c = cfg("resnet50")
    work = counts.layer_work(c, 224, 64)
    want = sum(max(2 * m / 1979e12, b / 3.35e12) for m, b in work.values())
    assert counts.bound_s(c, 224, 64) == pytest.approx(want)
    assert counts.bound_s(c, 224, 64) > 2 * counts.macs(c, 224, 64) / 1979e12
