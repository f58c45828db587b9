"""Finding a cell's parts by name.

Everything is found from ``BENCHMARK.json`` at the root: the cell (an
entry of ``workloads``) names its configuration (an entry of ``configs``,
whose ``file`` holds it) and its traffic mix (``traffic/<name>.json``
beside this file); its ``correct`` comparison's sample sizes and limits
are ``checks/<cell>.json``; each metric that applies to it (an entry of
``end_to_end`` or ``per_layer`` without a ``workloads`` key, or one that
lists the cell) is read by ``metrics/<metric>.py``, a module with a
function ``read(run)`` that returns a number or None (see
``harness.Run``).  A new cell, configuration, traffic mix or metric is
new files and new entries, never an edit of a file that is there.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_reader(name: str, bench_dir: str = HERE) -> Callable:
    """``read`` of ``metrics/<name>.py`` under ``bench_dir``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: str = ROOT, bench_dir: str = HERE) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json with its configuration,
    traffic, checks and metric readers."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError("no workload %r in BENCHMARK.json" % name)
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == entry["config"])
    cell = Cell(
        name=name, chips=int(entry["chips"]),
        config=load_json(os.path.join(root, conf_entry["file"])),
        traffic=load_json(os.path.join(bench_dir, "traffic",
                                       entry["traffic"] + ".json")),
        checks=load_json(os.path.join(bench_dir, "checks", name + ".json")))
    e2e_here = {m["name"] for m in bench["end_to_end"] if _applies(m, name)}
    for m in bench["end_to_end"]:
        if m["name"] in e2e_here:
            cell.end_to_end.append(Metric(m["name"], m["unit"],
                                          load_reader(m["name"], bench_dir)))
    for m in bench["per_layer"]:
        if m["moves"] in e2e_here and _applies(m, name):
            cell.per_layer.append(Metric(m["name"], m["unit"],
                                         load_reader(m["name"], bench_dir)))
    return cell


def metric_values(metrics: List[Metric], run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the metrics whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = m.read(run)
        if value is not None:
            out[m.name] = {"value": value, "unit": m.unit}
    return out
