"""Finds the benchmark's pieces by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
the cells and the metrics. Each piece has a file of its own, found by the
name given there:

* a configuration: the file its entry names (``configs/<name>.json``);
* a traffic mix: ``workloads/<traffic>.json``;
* a metric: its reader, ``metrics/<name>.py``;
* a configuration's own plain reference, where its file names one under
  ``"reference"``: ``reference/<name>.py``.

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
    """The file of piece `name` of `kind` ("configs", "workloads", "metrics"
    or "reference"); raises where the name is not valid or the file is
    absent."""
    if not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    suffix = ".py" if kind in ("metrics", "reference") else ".json"
    path = os.path.join(bench_dir, kind, name + suffix)
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
    bench_dir: str = BENCH_DIR   # the checkout's benchmark directory the cell was found in


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
    bench_dir = os.path.join(root, "benchmark")
    traffic = load_json(find("workloads", entry["traffic"], bench_dir))
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, entry["config"], config, entry["traffic"], traffic, int(entry["chips"]),
                e2e, per_layer, bench_dir)


def _module(kind: str, name: str, bench_dir: str):
    """Piece `name` of `kind` loaded from its file under `bench_dir`; loaded
    once a process, and anew where another checkout's file has the name."""
    path = find(kind, name, bench_dir)
    key = f"benchmark.{kind}.{name}"
    mod = sys.modules.get(key)
    if mod is not None and getattr(mod, "__file__", None) == path:
        return mod
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, bench_dir: str = BENCH_DIR):
    """The module of metric `name`'s reader: ``read(run)`` gives the
    metric's value, or None where the run holds nothing to read."""
    return _module("metrics", name, bench_dir)


def reference(name: str, bench_dir: str = BENCH_DIR):
    """The plain reference module `name` that a configuration names: it
    gives ``build(config, seed)`` (the scene), ``Model(scene, device)``
    (``names``, ``start``, ``frame``, ``margins``), ``GROUPS`` (group ->
    field names, compared by the largest absolute gap a world) and
    ``EXACT`` (field names compared exactly). Raises as `find` does, and
    where the module lacks one of these."""
    mod = _module("reference", name, bench_dir)
    missing = [k for k in ("build", "Model", "GROUPS", "EXACT") if not hasattr(mod, k)]
    if missing:
        raise AttributeError(f"reference {name!r} gives no {missing}")
    return mod

