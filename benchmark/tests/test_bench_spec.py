"""BENCHMARK.json against the rules a benchmark file keeps, and each piece found by name."""
import json
import os
import re
import shutil

import pytest

from benchmark.harness import spec

BENCH = spec.benchmark()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
LINE = re.compile(r"[^\n\t]{1,200}\Z")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head).*|.*(_dim|_rank)\Z")


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP_KEYS
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(spec.ROOT, p))
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word.split("/")


@pytest.mark.parametrize("kind", sorted(ENTRY_KEYS))
def test_entries_have_exactly_the_allowed_keys(kind):
    entries = BENCH[kind]
    assert entries
    for e in entries:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[kind] <= set(e) <= ENTRY_KEYS[kind] | extra, e


def test_names_and_units_are_valid():
    names = {}
    for kind in ENTRY_KEYS:
        for e in BENCH[kind]:
            assert spec.NAME.match(e["name"]), e["name"]
            names.setdefault(kind, []).append(e["name"])
            if "unit" in e:
                assert spec.UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer") + (("source",) if kind == "configs" else ()):
                if key in e:
                    assert LINE.match(e[key]), (key, e[key])
    metrics = names["end_to_end"] + names["per_layer"]
    assert len(set(metrics)) == len(metrics)
    for kind in ("configs", "workloads"):
        assert len(set(names[kind])) == len(names[kind])


def test_metrics_follow_the_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_cells_configs_and_chips():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for c in configs.values():
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert spec.NAME.match(key) and not WIDTH.match(key)
        on_disk = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert on_disk["source"] == c["source"] and on_disk["reduced"] == c["reduced"]


def test_every_cell_reports_set_up_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"], BENCH)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_every_piece_is_found_by_name():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"], BENCH)
        assert cell.config["builder"] and cell.traffic["worlds"] > 0
        assert set(cell.config["limits"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
    with pytest.raises(FileNotFoundError):
        spec.find("metrics", "no_such_metric")
    with pytest.raises(ValueError):
        spec.find("workloads", "../w4096")


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    """A later change adds a traffic file and an entry: nothing else changes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "crowd.w64", "config": "skinned_crowd", "traffic": "w64",
                               "chips": 1, "why": "a small batch"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = spec.load_json(spec.find("workloads", "w4096"))
    (root / "benchmark" / "workloads" / "w64.json").write_text(json.dumps({**traffic,
                                                                            "worlds": 64}))
    cell = spec.cell("crowd.w64", root=str(root))
    assert cell.traffic["worlds"] == 64 and cell.config_name == "skinned_crowd"
    assert {m["name"] for m in cell.end_to_end} == {m["name"] for m in BENCH["end_to_end"]}
    assert "physics.device_ms" not in {m["name"] for m in cell.per_layer}
    assert "frame.torch_ops" in {m["name"] for m in cell.per_layer}
