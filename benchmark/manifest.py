"""BENCHMARK.json and the files it is built from.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, found by name:

  configs/<config>.json        the layer table, family, source, quantization, reduced, why
  families/<family>.py         the walk of a family's layer table
  traffic/<mix>.json           a mix's parameters; `generator` names traffic/<gen>.py
  traffic/<generator>.py       a general generator
  workloads/<cell>.json        config, traffic, path, rung, engine, control (and
                               server), chips, why
  paths/<path>.py              the driver of a path (offline, serve)
  reference/rungs/<rung>.py    the reference's carry rule of a rung
  end_to_end/<metric>.json     unit, better, bound, source and the paths that report it
  metrics/<metric>.py          a per-layer metric's reader and its declarations
  settings.json                run_seconds

`build()` makes BENCHMARK.json's contents from them (`python3
benchmark/manifest.py --write` writes it); a test holds the committed file
to it.  An end-to-end or per-layer metric lists the cells whose path reports
it, so a cell added as files alone joins every metric of its path."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
COMMAND = ["python3", "benchmark/run.py"]


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def names(kind: str, suffix: str, base: Path = HERE) -> list:
    return sorted(p.name[: -len(suffix)] for p in (base / kind).glob("*" + suffix)
                  if not p.name.startswith("_"))


def load_reader(name: str, base: Path = HERE):
    """The module of metrics/<name>.py (a file name may hold dots)."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(base: Path = HERE) -> dict:
    cells = {n: _json(base / "workloads" / f"{n}.json") for n in names("workloads", ".json", base)}
    used = sorted({c["config"] for c in cells.values()})
    configs = []
    for name in used:
        cfg = _json(base / "configs" / f"{name}.json")
        configs.append({"name": name, "source": cfg["source"],
                        "file": f"{base.name}/configs/{name}.json",
                        "reduced": cfg["reduced"], "why": cfg["why"]})
    workloads = [{"name": n, "config": c["config"], "traffic": c["traffic"], "chips": c["chips"],
                  "why": c["why"]} for n, c in cells.items()]

    def cells_of(paths):
        return [n for n, c in cells.items() if c["path"] in paths]

    e2e = []
    for name in ["setup_s"] + [n for n in names("end_to_end", ".json", base) if n != "setup_s"]:
        m = _json(base / "end_to_end" / f"{name}.json")
        entry = {"name": name, "unit": m["unit"], "better": m["better"], "bound": m["bound"],
                 "source": m["source"]}
        if m.get("paths") is not None:
            entry["workloads"] = cells_of(m["paths"])
        e2e.append(entry)
    per_layer = []
    for name in names("metrics", ".py", base):
        r = load_reader(name, base)
        per_layer.append({"name": name, "unit": r.UNIT, "better": r.BETTER, "source": r.SOURCE,
                          "layer": r.LAYER, "moves": r.MOVES, "workloads": cells_of(r.PATHS)})
    settings = _json(base / "settings.json")
    return {"command": COMMAND, "paths": [base.name], "run_seconds": settings["run_seconds"],
            "configs": configs, "workloads": workloads, "end_to_end": e2e,
            "per_layer": per_layer}


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<mix>.json
    end_to_end: list  # BENCHMARK.json's entries this cell reports
    per_layer: list


def load_cell(name: str, overrides: dict = None, base: Path = HERE) -> Cell:
    """The cell `name` as BENCHMARK.json at the checkout's root lists it,
    with its files; `overrides` ({"config": {...}, "traffic": {...},
    "workload": {...}}) replaces keys, for a rehearsal at a small size."""
    bench = _json(base.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}: not in BENCHMARK.json")
    over = overrides or {}
    wl = dict(_json(base / "workloads" / f"{name}.json"), **over.get("workload", {}))
    cfg = dict(_json(base / "configs" / f"{entry['config']}.json"), **over.get("config", {}))
    mix = dict(_json(base / "traffic" / f"{entry['traffic']}.json"), **over.get("traffic", {}))
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name, wl, cfg, mix, e2e, layer)


if __name__ == "__main__":
    text = json.dumps(build(), indent=1) + "\n"
    if sys.argv[1:] == ["--write"]:
        (ROOT / "BENCHMARK.json").write_text(text)
    else:
        sys.stdout.write(text)
