"""What the benchmark finds by name: cells and metrics in
`BENCHMARK.json`, and a file of its own for each configuration
(`configs/`), traffic mix (`traffic/`), cell's correctness limits
(`checks/`) and per-layer metric's reader (`metrics/`).  Adding a cell
or a metric adds files and entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


@dataclass(frozen=True)
class Cell:
    """One workload of BENCHMARK.json with everything it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    """The workload `name`: its configuration, traffic mix and limits
    read from their files, and the metrics it reports."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; have {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        check=_json(os.path.join(HERE, "checks", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str) -> Callable:
    """The `read` function of metrics/<metric>.py."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "flamebench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(metrics: List[dict], ctx) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every per-layer metric whose reader
    finds something to read in `ctx`."""
    out = {}
    for m in metrics:
        value: Optional[float] = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
