"""The global BA at the scale of a whole run's map (port of the
repository's ``tools/bench_gba_scale.py``).

The scale axis of the workload is the global bundle adjustment over every
keyframe (the reference's ``global_bundle_adjustment``,
loop_closure_utils.h:672-748, runs Ceres SPARSE_SCHUR over every camera
and observation). For each ``--pairs`` the orbit problem of
``synthetic.make_big_problem`` (2 cameras per pair, 16 landmarks per
pair, 16 observations per landmark: 4096 pairs is 1,048,576
observations) is solved with the matrix-free LM-CG solver
(``solvers/ba_cg.py``) after one untimed solve with the same settings:
ms per LM iteration over the iterations that ran (``iterations``; the
solver stops early when it converges) and peak device memory
(``torch.cuda.max_memory_allocated``, reset before each row).

Writes ``artifacts/gba_scale_cuda.json``:
  [{"n_pairs", "cams", "landmarks", "observations", "solver", "lm_iters",
    "iterations", "iter_ms", "total_s", "initial_cost", "final_cost",
    "peak_hbm_mb", "backend", "device_name"}, ...]

    python -m vslam_tpu_torch.tools.bench_gba_scale [--pairs 512,1024,4096]
        [--lm-iters 3] [--cg-iters 8] [--out PATH] [--device cpu]

Runs on the card unless ``--device cpu`` is given (an error where there is
no card; ``peak_hbm_mb`` is then None).
"""

from __future__ import annotations

import argparse
import json
import os
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def bench_row(n_pairs: int, lm_iters: int, cg_iters: int, device="cuda"):
    """One row: build the problem, solve once untimed, then time a
    solve."""
    import torch

    from .. import interop, resolve_device, synthetic
    from ..solvers import ba, ba_cg
    from ..utils.profiling import sync

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    t0 = time.time()
    arrays, _, _ = synthetic.make_big_problem(n_pairs=n_pairs)
    prob = interop.from_arrays(ba.BAProblem, arrays, dev)
    print(f"n_pairs={n_pairs}: problem built in {time.time() - t0:.0f}s "
          f"(K={prob.poses.shape[0]}, L={prob.points.shape[0]}, "
          f"O={prob.obs_cam.shape[0]})", flush=True)

    def solve():
        return ba_cg.solve_ba_cg(prob, cam_name="pinhole", huber=2.0,
                                 max_iters=lm_iters, cg_iters=cg_iters)

    solve()   # untimed: the allocator's warm-up
    sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _, _, stats = solve()
    final = float(stats["final_cost"])   # waits for the solve
    total = time.perf_counter() - t0
    iters = int(stats["iterations"])
    return {
        "n_pairs": n_pairs,
        "cams": int(prob.poses.shape[0]),
        "landmarks": int(prob.points.shape[0]),
        "observations": int(prob.obs_cam.shape[0]),
        "solver": f"lm_cg (cg_iters={cg_iters})",
        "lm_iters": lm_iters,
        "iterations": iters,
        # over the LM iterations that ran, not the ones asked for
        "iter_ms": 1e3 * total / max(iters, 1),
        "total_s": total,
        "initial_cost": float(stats["initial_cost"]),
        "final_cost": final,
        "peak_hbm_mb": (torch.cuda.max_memory_allocated(dev) / 2 ** 20
                        if cuda else None),
        "backend": dev.type,
        "device_name": torch.cuda.get_device_name(dev) if cuda else "cpu",
    }


def main(argv=None):
    """The command line; returns the rows."""
    ap = argparse.ArgumentParser(
        prog="python -m vslam_tpu_torch.tools.bench_gba_scale",
        description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", default="512,1024,4096")
    ap.add_argument("--out", default=os.path.join(REPO, "artifacts",
                                                  "gba_scale_cuda.json"))
    ap.add_argument("--lm-iters", type=int, default=3)
    ap.add_argument("--cg-iters", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="torch device to run "
                    "on: the card by default (an error without one), 'cpu' "
                    "on request")
    args = ap.parse_args(argv)

    rows = []
    for n_pairs in [int(x) for x in args.pairs.split(",")]:
        row = bench_row(n_pairs, args.lm_iters, args.cg_iters, args.device)
        rows.append(row)
        print(json.dumps(row), flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return rows


if __name__ == "__main__":
    main()
