"""Finds the benchmark's pieces by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
the cells and the metrics. Each piece has a file of its own, found by the
name given there:

* a configuration: the file its entry names (``configs/<name>.json``);
* a traffic mix: ``workloads/<traffic>.json``;
* a metric: its reader, ``metrics/<name>.py``.

Adding a piece is adding its file and its entry; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass, field
from typing import List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find(kind: str, name: str, bench_dir: str = BENCH_DIR) -> str:
    """The file of piece `name` of `kind` ("configs", "workloads" or
    "metrics"); raises where the name is not valid or the file is absent."""
    if not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    path = os.path.join(bench_dir, kind, name + (".py" if kind == "metrics" else ".json"))
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


@dataclass
class Cell:
    """One entry of ``workloads``: a configuration under a traffic mix, with
    the metrics it reports."""

    name: str
    config_name: str
    config: dict             # the configuration's file
    traffic_name: str
    traffic: dict            # the traffic mix's file
    chips: int
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def reports(metric: dict, cell: str, reported=None) -> bool:
    """Whether `cell` reports `metric`: it is named in the metric's
    ``workloads``, or the metric has none and (for a per-layer metric) the
    cell reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def cell(name: str, bench: dict = None, root: str = ROOT) -> Cell:
    bench = bench if bench is not None else benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(find("workloads", entry["traffic"], os.path.join(root, "benchmark")))
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, entry["config"], config, entry["traffic"], traffic, int(entry["chips"]),
                e2e, per_layer)


def reader(name: str, bench_dir: str = BENCH_DIR):
    """The module of metric `name`'s reader: ``read(run)`` gives the
    metric's value, or None where the run holds nothing to read."""
    key = "benchmark.metrics." + name
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, find("metrics", name, bench_dir))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod

