"""A cell's files, found by the names ``BENCHMARK.json`` gives.

- ``benchmark/configs/<config>.json``: the deployment: its rig, the
  driver it runs (``driver``), that driver's ``SlamConfig`` as run and
  its arguments.
- ``benchmark/drivers/<driver>.py``: how the harness builds and calls
  that driver of the program (``make``, ``step``, ``results``, the
  answers the check compares; ``drivers/streaming_vo.py`` documents
  them).
- ``benchmark/traffic/<traffic>.json``: the stream: its world, its
  trajectory, its replay and its feed.
- ``benchmark/worlds/<kind>.py``, ``benchmark/trajectories/<kind>.py``:
  the kinds of world and trajectory a traffic file names
  (``stream.build``).
- ``benchmark/limits/<workload>.json``: the correctness limits of the
  cell, with the readings they were set from.
- ``benchmark/metrics/<metric>.py``: one reader per metric, ``read(run)``
  returning a number or None (nothing to read in this cell).

Adding a configuration, a driver, a traffic mix, a world or trajectory
kind, a cell or a metric is adding these files and the entries in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)


def _json(*parts):
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the workload's entry in BENCHMARK.json
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    limits: dict         # limits/<workload>.json
    end_to_end: list     # the end-to-end metric entries this cell reports
    per_layer: list      # the per-layer metric entries this cell reports


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, spec_path: str | None = None) -> Cell:
    """The cell named ``workload`` of ``BENCHMARK.json`` (at the checkout's
    root unless ``spec_path`` is given), with its files."""
    with open(spec_path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    entries = {w["name"]: w for w in spec["workloads"]}
    if workload not in entries:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(there are {sorted(entries)})")
    entry = entries[workload]
    return Cell(
        name=workload, entry=entry,
        config=_json("configs", entry["config"] + ".json"),
        traffic=_json("traffic", entry["traffic"] + ".json"),
        limits=_json("limits", workload + ".json"),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)])


_MODULES = {}


def module(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py`` (a driver, a world or
    trajectory kind, a metric's reader), loaded once."""
    key = (kind, name)
    if key not in _MODULES:
        path = os.path.join(BENCH_DIR, kind, name + ".py")
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        mod_name = f"benchmark_{kind}_" + name.replace(".", "_") \
            .replace("-", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def reader(metric_name: str):
    """The ``read`` function of ``metrics/<metric_name>.py``."""
    return module("metrics", metric_name).read
