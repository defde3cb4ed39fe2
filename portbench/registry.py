"""Where the harness finds a cell's parts, by name.

`BENCHMARK.json` (at the checkout's root) lists the cells and metrics.  A
cell names a configuration and a traffic mix; each is a file of its own:

    portbench/configs/<config>.json      the sizes the program runs at
    portbench/workloads/<traffic>.json   the traffic's parameters
    portbench/limits/<cell>.json         the limits of the correctness check
    portbench/metrics/<metric>.py        a per-layer metric's reader

A later cell, configuration or metric is a new file and a new entry; no
file that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str, bench: dict = None) -> dict:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (cells: "
                   f"{', '.join(w['name'] for w in bench['workloads'])})")


def config(name: str) -> dict:
    return _json(os.path.join(HERE, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    return _json(os.path.join(HERE, "workloads", f"{name}.json"))


def limits(cell_name: str) -> dict:
    return _json(os.path.join(HERE, "limits", f"{cell_name}.json"))


def reports(metric: dict, cell: dict, bench: dict) -> bool:
    """Whether `cell` reports `metric`: listed in its `workloads`, or,
    without that key, every cell that reports the end-to-end metric it
    moves (or, for an end-to-end metric, every cell)."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    for m in bench["end_to_end"]:
        if m["name"] == moves:
            return reports(m, cell, bench)
    return False


def end_to_end(cell: dict, bench: dict) -> List[dict]:
    return [m for m in bench["end_to_end"] if reports(m, cell, bench)]


def per_layer(cell: dict, bench: dict) -> List[dict]:
    return [m for m in bench["per_layer"] if reports(m, cell, bench)]


def reader(metric_name: str):
    """The `read(record) -> float | None` of portbench/metrics/<name>.py
    (loaded by path: a metric's name may hold dots)."""
    path = os.path.join(HERE, "metrics", f"{metric_name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric_name.replace(".", "_").replace(
            "-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def listed(kind: str) -> Dict[str, str]:
    """{name: path} of the files of one kind ("configs", "workloads",
    "limits", "metrics")."""
    d = os.path.join(HERE, kind)
    out = {}
    for f in sorted(os.listdir(d)):
        stem, ext = os.path.splitext(f)
        if ext in (".json", ".py") and not f.startswith("_"):
            out[stem] = os.path.join(d, f)
    return out
