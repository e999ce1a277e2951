"""A later PR adds a cell, a mix, a generator, a configuration, a family or a
metric as new files alone.  Here throwaway ones go into a copy of the
benchmark, which runs from a checkout of its own: every part is found by
its name there, as in the checkout a later PR makes."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import manifest

STEADY = '''"""Evenly spaced requests over the poisson mix's pool: a generator of
the test."""

import numpy as np

from ..harness.weights import sub_seed
from . import Schedule
from .poisson import pool  # noqa: F401


def schedule(mix, seed, seconds, what="window"):
    n = max(int(round(float(mix["rate_rps"]) * seconds)), 1)
    rng = np.random.default_rng(sub_seed(seed, f"steady:{what}"))
    size = np.resize(np.arange(int(mix["images_min"]), int(mix["images_max"]) + 1), n)
    start = rng.integers(0, int(mix["pool_images"]) - size + 1)
    return Schedule(np.arange(n) * seconds / n, start, size, float(seconds))
'''

RESNET_AGAIN = '''"""The ResNet walk under another name: a family of the test."""

from . import body, first_convs


def forward(ops, cfg, x):
    p = cfg["stem_pool"]
    a = ops.max_pool(ops.relu(ops.conv("head", x)), p["kernel"], p["stride"], p["padding"])
    a = ops.carry(a, cfg["blocks"][0]["body"][0])
    for block, target in zip(cfg["blocks"], first_convs(cfg, None)):
        r = body(ops, block, a)
        s = a if block["shortcut"] is None else ops.conv(block["shortcut"], a)
        a = ops.carry(ops.relu(ops.add(r, s)), target)
    return a
'''


def write_json(path, obj):
    path.write_text(json.dumps(obj))


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A checkout holding a copy of the benchmark with the new files, and
    its BENCHMARK.json built from them."""
    root = tmp_path_factory.mktemp("checkout")
    base = root / "benchmark"
    shutil.copytree(manifest.HERE, base, ignore=shutil.ignore_patterns("__pycache__", "out"))
    # a cell on a new mix of an existing generator
    write_json(base / "traffic" / "offline_b8.json",
               {"generator": "batches", "batch": 8, "distinct_batches": 3})
    write_json(base / "workloads" / "resnet50.int8.offline_b8.json", {
        "config": "resnet50", "traffic": "offline_b8", "path": "offline", "rung": "int8",
        "engine": {"int8_boundary": True}, "control": {"reference": {"operand_bits": 4}},
        "chips": 1, "why": "a throwaway cell of the test"})
    # a cell on a new generator and a configuration of a new family
    (base / "traffic" / "steady.py").write_text(STEADY)
    write_json(base / "traffic" / "steady_r4.json", {
        "generator": "steady", "rate_rps": 4.0, "images_min": 1, "images_max": 2,
        "pool_images": 16})
    (base / "families" / "resnet_again.py").write_text(RESNET_AGAIN)
    cfg = json.loads((base / "configs" / "resnet50.json").read_text())
    write_json(base / "configs" / "resnet50_again.json", dict(cfg, family="resnet_again"))
    write_json(base / "workloads" / "resnet50_again.strict.steady_r4.json", {
        "config": "resnet50_again", "traffic": "steady_r4", "path": "serve", "rung": "strict",
        "engine": {}, "control": {"engine": {"int8_boundary": True}},
        "server": {"buckets": [8, 16, 64], "max_wait_ms": 5.0, "ring_capacity": 256},
        "chips": 1, "why": "a throwaway cell of the test"})
    bench = manifest.build(base)
    write_json(root / "BENCHMARK.json", bench)
    return root, bench


def rehearse_there(root, cell: str) -> list:
    """A rehearsal of `cell` in a process whose `benchmark` is the copy."""
    env = dict(os.environ, PYTHONPATH=str(manifest.ROOT))  # the program, after the copy
    out = subprocess.run([sys.executable, "-m", "benchmark.tests.rehearse", cell, "9"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.strip().splitlines()[-2:]]


def test_a_cell_added_as_files_alone_is_built_and_runs(checkout):
    root, bench = checkout
    assert "resnet50.int8.offline_b8" in [w["name"] for w in bench["workloads"]]
    ips = next(m for m in bench["end_to_end"] if m["name"] == "images_per_s")
    assert "resnet50.int8.offline_b8" in ips["workloads"]
    old = manifest.build()
    assert all(m in bench["per_layer"] or m["workloads"] != [] for m in old["per_layer"])
    res, mods = rehearse_there(root, "resnet50.int8.offline_b8")
    assert res["correct"] and set(res["metrics"]) == {"setup_s", "images_per_s"}
    assert mods == {"forbidden_modules": []}


def test_a_generator_and_a_family_added_as_files_alone_run(checkout):
    root, bench = checkout
    cell = "resnet50_again.strict.steady_r4"
    cfg = next(c for c in bench["configs"] if c["name"] == "resnet50_again")
    assert cfg["file"] == "benchmark/configs/resnet50_again.json"
    p95 = next(m for m in bench["end_to_end"] if m["name"] == "latency_p95_ms")
    assert cell in p95["workloads"]
    res, _ = rehearse_there(root, cell)
    assert res["correct"] and set(res["metrics"]) == {"setup_s", "latency_p95_ms"}
    assert res["checks"]["requests_compared"]["value"] >= 4
