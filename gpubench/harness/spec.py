"""The cell's files, found by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration and a traffic
mix.  The configuration's entry gives its file (configs/<name>.json:
the job, the command-line flags, what was assumed); the traffic mix is
traffic/<name>.json (the simulation's parameters); every metric is a
reader of its own, metrics/<name>.py, with a function `read(m)` that
takes the run's measures and returns a number or None.  Adding a cell,
a mix or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable[[dict], Optional[float]]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration's file
    traffic: dict           # the traffic mix's file
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str, bench_dir: str = HERE) -> Callable:
    """metrics/<name>.py's `read`."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"gpubench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None,
              root: str = ROOT, bench_dir: str = HERE) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `bench`)."""
    if bench is None:
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     f"{w['traffic']}.json"))

    def metrics(entries):
        return [Metric(m["name"], m["unit"], reader(m["name"], bench_dir))
                for m in entries if _applies(m, name)]

    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=metrics(bench["end_to_end"]),
                per_layer=metrics(bench["per_layer"]))
