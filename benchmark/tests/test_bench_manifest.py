"""BENCHMARK.json: built from the benchmark's files, and within the limits
every later check holds it to."""

import json
import re

import pytest

from benchmark import manifest

ROOT = manifest.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_is_built_from_the_files():
    assert BENCH == manifest.build()
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_top_level_keys_command_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert one_line(word) and not word.startswith("/") and ".." not in word


def test_run_seconds_fits_the_check_with_24_cells():
    s = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            if "why" in e:
                assert one_line(e["why"]), e["name"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and c["source"].startswith("https://")
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == [] and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"]) and NAME.match(w["config"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_and_who_reports_them():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        allowed = {"name", "unit", "better", "bound", "source", "workloads"}
        assert set(m) <= allowed and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25

    def reports(cell, metric):
        return cell in e2e[metric].get("workloads", cells)

    for cell in cells:
        assert sum(reports(cell, n) for n in e2e) >= 2, cell
        assert any(cell in m["workloads"] for m in BENCH["per_layer"]), cell
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and one_line(m["layer"])
        assert m["moves"] in e2e
        assert m["workloads"] and all(reports(c, m["moves"]) for c in m["workloads"])
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert 1 <= len(BENCH["per_layer"]) <= 128


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_files_hold_the_table(name):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    assert cfg["name"] == name and cfg["reduced"] == []
    assert cfg["image_size"] == 224 and cfg["num_classes"] == 1000
    names = [l["name"] for l in cfg["layers"]]
    assert len(names) == len(set(names))
    for b in cfg["blocks"]:
        assert set(b["body"]) <= set(names)


def test_every_file_under_paths_is_named_from_a_name():
    for p in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", str(p.relative_to(ROOT))), p
