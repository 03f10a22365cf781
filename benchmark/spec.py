"""What ``BENCHMARK.json`` says of a cell, and the files it names.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:

- ``BENCHMARK.json``'s ``configs[].file``: the configuration's sizes;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters, among them
  the ``driver`` that runs it (``benchmark/drivers/<driver>.py``);
- ``benchmark/limits/<workload>.json``: the limits of the numbers that
  decide ``correct`` in that cell;
- ``benchmark/metrics/<metric>.py``: a per-layer metric's reader.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with what it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises ``KeyError``
    for a cell it does not hold."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def load_module(path: Path) -> ModuleType:
    """The Python file ``path`` as a module (names may hold dots)."""
    name = "benchmark._loaded." + path.parent.name + "." + path.stem.replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def driver(traffic: dict) -> ModuleType:
    return load_module(HERE / "drivers" / f"{traffic['driver']}.py")


def reader(metric: str) -> ModuleType:
    return load_module(HERE / "metrics" / f"{metric}.py")
