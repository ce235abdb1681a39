"""The harness on the CPU: its output, what it refuses, what it imports,
and that a new cell or metric needs only new files and entries."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from bench_util import BENCH_DIR, ROOT

FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|vslam_tpu)(\s|\.|,|$)", re.M)


def test_no_source_of_the_harness_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not FORBIDDEN.search(fh.read()), f


def test_forbidden_names_are_compared_whole(monkeypatch):
    import run as bench_run

    fake = sys.modules["os"]
    for name in ("vslam_tpu_torch.probe", "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vslam_tpu.ops", fake)
    monkeypatch.setitem(sys.modules, "jaxlib", fake)
    assert bench_run.forbidden_modules() == ["jaxlib", "vslam_tpu"]


def _run_child(code, cwd=ROOT, timeout=600):
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="4")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_a_rehearsal_loads_no_jax_and_prints_the_contract_line():
    """A small hover run through ``measure`` and ``report`` in a fresh
    process: no JAX or JAX package loaded, the last line one JSON object
    with the contract's keys and its checks last."""
    code = f"""
import sys
sys.path[:0] = [{BENCH_DIR!r} + '/tests']
from bench_util import cpu_cell, cpu_measure
import run
cell = cpu_cell('vo_hover', frames=64, width=320, height=240, small=True)
res, checks, counters = cpu_measure(cell, calls=24, trace=1)
run.report(res, checks, counters)
print('FORBIDDEN', run.forbidden_modules(), file=sys.stderr)
"""
    p = _run_child(code)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "FORBIDDEN []" in p.stderr
    lines = p.stdout.strip().splitlines()
    assert lines[-2].startswith("counters: ")
    last = json.loads(lines[-1])
    assert list(last)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device",
            "breakdown"} <= set(last)
    assert last["attempted"] == 24
    for name, c in last["checks"].items():
        assert set(c) == {"value", "limit"}
        assert f"check {name}: " in p.stderr
    assert "graph_capture_s" not in last["metrics"]   # eager on the CPU
    assert "check feat_miss: " in p.stderr
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_main_refuses_without_a_card():
    import torch

    import run as bench_run

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert bench_run.main(["--workload", "vo_hover", "--seed", "1",
                           "--seconds", "1", "--trace", "0"]) == 2


def test_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "vo_corridor", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A copy of the checkout gains a configuration with a driver of its
    own, a traffic mix with a world kind and a trajectory kind of its own,
    a per-layer metric and a cell, by new files and new entries in
    BENCHMARK.json alone; the harness finds and runs them, and no file
    that was there changes."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "vslam_tpu_torch"),
               tmp_path / "vslam_tpu_torch")
    b = tmp_path / "benchmark"

    def files():
        return {os.path.relpath(os.path.join(d, f), tmp_path): open(
            os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(b) for f in fs if "__pycache__" not in d}

    before = files()
    (b / "drivers" / "vo_copy.py").write_text(
        (b / "drivers" / "streaming_vo.py").read_text())
    with open(b / "configs" / "euroc_vo.json") as f:
        config = json.load(f)
    config.update(name="euroc_vo_copy", driver="vo_copy")
    (b / "configs" / "euroc_vo_copy.json").write_text(json.dumps(config))
    (b / "trajectories" / "side_sway.py").write_text(
        "import numpy as np\n"
        "from harness import geometry\n\n\n"
        "def poses(spec, n):\n"
        "    f = np.arange(n, dtype=np.float64)\n"
        "    pos = np.zeros((n, 3))\n"
        "    pos[:, 0] = spec['amp'] * np.sin(2 * np.pi * f / spec['period'])\n"
        "    return np.concatenate([pos, geometry.yaw_quat(0 * f)], -1)\n")
    (b / "worlds" / "sprites_dense.py").write_text(
        "from harness import cells\n\n\n"
        "def render(spec, rig, poses, rng, device):\n"
        "    spec = dict(spec, points_per_m3=2 * spec['points_per_m3'])\n"
        "    return cells.module('worlds', 'sprites').render(\n"
        "        spec, rig, poses, rng, device)\n")
    with open(b / "traffic" / "vo_hover.json") as f:
        traffic = json.load(f)
    traffic["world"]["kind"] = "sprites_dense"
    traffic["trajectory"] = dict(kind="side_sway", amp=0.08, period=160.0)
    traffic["rendered_frames"] = 160
    (b / "traffic" / "vo_sway_slow.json").write_text(json.dumps(traffic))
    (b / "limits" / "vo_sway_slow.json").write_text(
        (b / "limits" / "vo_hover.json").read_text())
    (b / "metrics" / "window_calls.py").write_text(
        "def read(run):\n    return float(len(run.latencies_s))\n")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append(dict(spec["configs"][0], name="euroc_vo_copy",
                                file="benchmark/configs/euroc_vo_copy.json"))
    spec["workloads"].append(dict(name="vo_sway_slow", config="euroc_vo_copy",
                                  traffic="vo_sway_slow", chips=1,
                                  why="a slower, sideways sway"))
    spec["per_layer"].append(dict(name="window_calls", unit="calls",
                                  better="higher", source="host_clock",
                                  layer="driver (pipeline/streaming)",
                                  moves="frames_per_s",
                                  workloads=["vo_sway_slow"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = f"""
import sys
sys.path[:0] = [{str(b / 'tests')!r}]
from bench_util import cpu_cell, cpu_measure
cell = cpu_cell('vo_sway_slow', frames=64, width=320, height=240, small=True)
res, checks, counters = cpu_measure(cell, calls=8, trace=1)
from harness import cells
print(sorted(m.__file__.split('/benchmark/')[1] for m in cells._MODULES.values()))
print(res['metrics']['window_calls']['value'])
"""
    p = _run_child(code, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    used, calls = p.stdout.strip().splitlines()[-2:]
    assert calls == "8.0"
    for f in ("drivers/vo_copy.py", "trajectories/side_sway.py",
              "worlds/sprites_dense.py", "metrics/window_calls.py"):
        assert f in used, used
    after = files()
    assert all(after[k] == v for k, v in before.items())


def test_trace_arithmetic():
    from harness import trace

    busy, merged = trace._union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)])
    assert busy == 4 and merged == [[0, 3], [5, 6]]
    host = [(3, 5, "cudaEventSynchronize"), (0, 10, "outer")]
    assert trace._gap_label(3, 5, host) == "cudaEventSynchronize"
    assert trace._gap_label(11, 12, host) == "host, no traced call"
