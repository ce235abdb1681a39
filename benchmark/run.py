"""One run of one cell of the port's benchmark.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds ``vslam_tpu_torch``: builds the
cell's world from the seed, constructs the program's driver, warms it up
(graph captures included), measures ``--seconds`` seconds closed loop,
reads the end-to-end metrics (``--trace 0``) or the per-layer ones
(``--trace 1``, with a profiled stretch after the window), checks the
program's answers against the plain reference, and prints one JSON object
as the last line of standard output. Exits non-zero, printing no result,
without enough CUDA devices, without the program, or if JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)
# the program's build and kernel caches stay inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "vslam_tpu")
TRACE_CALLS = 32     # profiled calls after the window (--trace 1)
PIN_CORE = 2         # the index, among the cores the process may use, of
#                      the one core every thread of a run is held to


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``vslam_tpu_torch`` is not ``vslam_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def steady_host():
    """Hold the run's host work to one thread and one core: ATen's and
    OpenMP's pools at one thread, and every thread of the process (the
    CUDA driver's too; threads started later inherit it) on the same
    fixed core, so that no run's host work depends on how many threads
    another run's scheduler gave it. It does not remove the two speeds
    of the host's graph launches (PERF.md, section 2)."""
    import torch

    torch.set_num_threads(1)
    cores = sorted(os.sched_getaffinity(0))
    core = {cores[min(PIN_CORE, len(cores) - 1)]}
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), core)
        except OSError:     # a thread that has ended since
            pass


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def trace_calls(cell) -> int:
    """Profiled calls: ``TRACE_CALLS`` frames' worth."""
    return max(1, TRACE_CALLS // cell.traffic.get("frames_per_call", 1))


def evaluate(session, seed: int, controls=False):
    """Free the driver and compare its answers with the reference: the
    readings of every number ``check`` defines, and with ``controls`` the
    controls' readings (the plain frontend in bfloat16 put in the
    program's place; the frozen pose answers)."""
    import numpy as np
    import torch

    from harness import check

    run, cell = session.run, session.cell
    rng = np.random.default_rng([abs(seed), 7])
    answers = check.answers(
        run, session.adapter.keyframe_answers(session.driver, run.first_frame),
        rng, cell.traffic["check_keyframes"])
    truth = session.truth(run.first_frame, len(run.poses))
    origin = session.truth(0, 1)[0]
    session.driver = None
    gc.collect()
    if session.device.type == "cuda":
        torch.cuda.empty_cache()
    which = [(f, cam) for f, cam, *_ in answers]
    refs = check.reference_features(session.world, which, session.cfg,
                                    session.device)
    readings = dict(feat_miss=check.frontend_reading(answers, refs),
                    compared_images=len(which),
                    **check.pose_readings(run.poses, truth, origin))
    if controls:
        low = check.reference_features(session.world, which, session.cfg,
                                       session.device, torch.bfloat16)
        readings["control_feat_miss"] = check.frontend_reading(
            check.control_answers(which, low), refs)
        readings.update(check.pose_controls(run.poses, truth, origin,
                                            run.held_pose))
    return readings


def measure(workload, seed, seconds, trace, device="cuda", spec_path=None,
            cell=None, max_calls=None):
    """Run one cell; returns (result dict, checks, counters). ``max_calls``
    ends the window early (CPU rehearsals)."""
    import torch

    from harness import cells, check
    from harness.drive import Session

    cell = cell or cells.load(workload, spec_path)
    session = Session(cell, seed, device, T_START)
    session.window(seconds, max_calls)
    if trace:
        session.traced(trace_calls(cell))
    run = session.run
    counters = session.counters()
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cells.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = session.device
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": cell.entry.get("chips", 1),
        "memory_peak_bytes": run.peak_reserved_bytes}
    breakdown = None
    if trace and run.trace is not None:
        device_info.update(busy_s=run.trace.busy_s,
                           window_s=run.trace.window_s)
        breakdown = {"device_ops": run.trace.device_ops,
                     "idle_gaps": run.trace.idle_gaps}
    readings = evaluate(session, seed)
    correct, checks = check.judge(readings, cell.limits)
    result = {"correct": correct, "attempted": run.frames,
              "failed": int((~run.tracked).sum()), "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    extra = {k: v for k, v in readings.items() if k not in checks}
    return result, checks, dict(counters, readings=extra,
                                setup_phases_s=session.setup_phases,
                                keyframes_in_window=int(run.is_keyframe.sum()),
                                frames_in_window=run.frames,
                                launches=run.launches,
                                median_ms_by_third=run.median_ms_by_third,
                                capture_stats=run.capture_stats)


def main(argv=None):
    args = parse(argv)
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
    import torch

    try:
        from harness import cells
        cell = cells.load(args.workload)
    except FileNotFoundError as e:
        print(f"benchmark: a file of the cell is missing: {e}", file=sys.stderr)
        return 2
    need = cell.entry.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: the cell needs {need} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import vslam_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is not in this checkout: {e}",
              file=sys.stderr)
        return 2
    steady_host()
    result, checks, counters = measure(args.workload, args.seed,
                                       args.seconds, args.trace, cell=cell)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}; the benchmark may load "
              f"neither JAX nor the JAX package", file=sys.stderr)
        return 3
    report(result, checks, counters)
    return 0


def report(result, checks, counters):
    """The run's output: the counters on an earlier line, each compared
    number beside its limit as the last lines of standard error, and the
    result as the last line of standard output, its checks last."""
    print("counters: " + json.dumps(counters, default=float), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(dict(result, checks=checks)), flush=True)


if __name__ == "__main__":
    sys.exit(main())
