"""BENCHMARK.json against the benchmark's contract, and every file it
names present under portbench/."""

import importlib
import json
import os
import re

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["portbench"]
    assert 1 <= len(m["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024


def test_names_units_and_entry_keys():
    m = manifest()
    names = []
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(w["name"])
    for metric in m["end_to_end"] + m["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= ({"bound"} if metric in m["end_to_end"]
                    else {"layer", "moves"})
        assert set(metric) <= allowed
        assert UNIT.match(metric["unit"])
        assert metric["better"] in ("lower", "higher")
        assert metric["source"] in SOURCES
        names.append(metric["name"])
    assert all(NAME.match(n) for n in names)
    assert len({c["name"] for c in m["configs"]}) == len(m["configs"])
    assert len({w["name"] for w in m["workloads"]}) == len(m["workloads"])
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({x["name"] for x in metrics}) == len(metrics)


def test_bounds():
    m = manifest()
    bounds = {x["name"]: x["bound"] for x in m["end_to_end"]}
    assert bounds["setup_s"] <= 0.25
    assert all(0.01 <= b <= 0.25 for b in bounds.values())
    assert all(x["source"] in ("host_clock", "device_trace")
               for x in m["end_to_end"])


def _reported(m, cell):
    return {x["name"] for x in m["end_to_end"]
            if cell in x.get("workloads", [cell])}


def test_every_cell_reports_setup_another_metric_and_a_layer():
    m = manifest()
    for w in m["workloads"]:
        e2e = _reported(m, w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in x["workloads"] for x in m["per_layer"])


def test_per_layer_moves_a_metric_each_of_its_cells_reports():
    m = manifest()
    cells = {w["name"] for w in m["workloads"]}
    for x in m["per_layer"]:
        assert x["moves"] in {e["name"] for e in m["end_to_end"]}
        assert x["workloads"] and set(x["workloads"]) <= cells
        for cell in x["workloads"]:
            assert x["moves"] in _reported(m, cell), (x["name"], cell)
    layers = {}
    for x in m["per_layer"]:
        layers.setdefault(x["moves"], set()).add(x["layer"])
    assert all(x["layer"].strip() == x["layer"] for x in m["per_layer"])


def test_every_configuration_has_a_cell_and_its_files():
    m = manifest()
    used = {w["config"] for w in m["workloads"]}
    files = set()
    for c in m["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["source"].startswith("https://")


@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_cell_files_and_modules(cell):
    m = manifest()
    w = {x["name"]: x for x in m["workloads"]}[cell]
    with open(os.path.join(ROOT, "portbench", "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    importlib.import_module("portbench.entries." + traffic["entry"])
    with open(os.path.join(ROOT, "portbench", "limits", cell + ".json")) as f:
        limits = json.load(f)
    assert limits and all("limit" in v for v in limits.values())
    for x in m["per_layer"]:
        if cell in x["workloads"]:
            assert hasattr(importlib.import_module(
                "portbench.metrics." + x["name"]), "read")


def test_at_most_a_quarter_of_cells_on_four_chips():
    m = manifest()
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)
