"""The benchmark's data, found by the names in ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``); its correctness limits are in
``limits/<cell>.json``; every metric is read by ``metrics/<metric>.py``;
a configuration's ``family`` names its layout, work and port config,
``families/<family>.py``, and its plain reference, ``reference/<family>.py``.  Adding a cell or a metric adds files here and
entries in ``BENCHMARK.json``; no code changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: List[dict]      # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> Cell:
    man = manifest()
    found = [w for w in man["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in man['workloads']]}")
    w = found[0]
    return Cell(name=name,
                config=load_json(BENCH / "configs" / f"{w['config']}.json"),
                traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(BENCH / "limits" / f"{name}.json"),
                chips=w["chips"],
                end_to_end=[m for m in man["end_to_end"] if reports(m, name)],
                per_layer=[m for m in man["per_layer"] if reports(m, name)])


def metric_reader(name: str) -> Callable[[dict], object]:
    """``read(record)`` of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cardbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def family(name: str):
    """A family's weights, closed forms and port config: ``families/<name>.py``."""
    return importlib.import_module(f"families.{name}")


def reference(family: str):
    """The plain reference of a family: ``reference/<family>.py``."""
    return importlib.import_module(f"reference.{family}")


def readers(metrics: List[dict]) -> Dict[str, Callable[[dict], object]]:
    return {m["name"]: metric_reader(m["name"]) for m in metrics}
