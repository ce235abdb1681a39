"""BENCHMARK.json against the benchmark's contract, and the harness's
files found by the names it gives."""

import json
import os
import re

import pytest

from bench_util import BENCH_DIR, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(spec["command"]) <= 32
    assert all(_line(w) for w in spec["command"])
    for w in spec["command"]:
        if w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in spec["paths"])
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51


def test_run_seconds_fits_the_check_with_24_cells(spec):
    s = spec["run_seconds"]
    cells = 24
    total = (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_allowed(spec, section):
    names = [e["name"] for e in spec[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_fields(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    cell_names = {w["name"] for w in spec["workloads"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert 1 <= len(spec["per_layer"]) <= 128
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        # every cell the metric names reports the metric it moves
        for w in m.get("workloads", cell_names):
            moved = e2e[m["moves"]]
            assert w in moved.get("workloads", cell_names)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"}
        assert set(m.get("workloads", [])) <= cell_names


def test_layers_are_spelled_alike(spec):
    by_layer = {}
    for m in spec["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_cells(spec):
    configs = {c["name"] for c in spec["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert 1 <= len(spec["workloads"]) <= 24
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(spec["workloads"]) // 4)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])
    assert configs == {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])


def test_every_cell_reports_setup_another_e2e_and_a_layer(spec):
    for w in spec["workloads"]:
        name = w["name"]
        e2e = [m["name"] for m in spec["end_to_end"]
               if name in m.get("workloads", [name])]
        layer = [m["name"] for m in spec["per_layer"]
                 if name in m.get("workloads", [name])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer


def test_files_are_found_by_name(spec):
    from harness import cells

    for w in spec["workloads"]:
        cell = cells.load(w["name"])
        assert cell.config["name"] == w["config"]
        assert {"source", "reduced", "assumed", "slam_config",
                "driver"} <= set(cell.config)
        assert callable(cells.module("drivers", cell.config["driver"]).make)
        assert callable(cells.module(
            "worlds", cell.traffic["world"]["kind"]).render)
        assert callable(cells.module(
            "trajectories", cell.traffic["trajectory"]["kind"]).poses)
        assert cell.limits["limits"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cells.reader(m["name"]))
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def test_file_names_use_name_characters():
    for dirpath, _, files in os.walk(BENCH_DIR):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
