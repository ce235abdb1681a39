"""Readings that the correctness limits are set from, on the card.

    python3 benchmark/control.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] [--tf32-seeds <n> ...]

For each of ``--seeds``, one sound run of the cell as ``run.py`` makes it
(set-up, a window of ``--seconds``, the check), printing every reading
and the controls' readings of the same numbers: the plain frontend in
bfloat16 put in the program's place (``control_feat_miss``), and the pose
answers that break the guarantee that each frame's pose is its own
(``control_frozen_*``: every frame answered with the last pose before
the window, a step that leaves the state unchanged).
For each of ``--tf32-seeds``, the program with TF32 switched on for its
float32 matrix products, the precision step below the float32 that the
package pins. One JSON line per run; all seeds in one process.
``run.py`` never runs this.
"""

import argparse
import gc
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(BENCH_DIR), BENCH_DIR]


def session_readings(cell, seed, seconds, device, controls=False):
    import torch

    import run as bench_run
    from harness.drive import Session

    t0 = time.perf_counter()
    s = Session(cell, seed, device, t0)
    s.window(seconds)
    run = s.run
    out = dict(frames=run.frames, window_s=run.window_s,
               keyframes=int(run.is_keyframe.sum()),
               tracked_share=float(run.tracked.mean()), **s.counters())
    out.update(bench_run.evaluate(s, seed, controls=controls))
    del s
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--tf32-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    import run as bench_run
    import vslam_tpu_torch  # noqa: F401  (pins TF32 off)
    from harness import cells

    if args.device == "cuda":
        bench_run.steady_host()

    cell = cells.load(args.workload)
    for seed in args.seeds:
        r = session_readings(cell, seed, args.seconds, args.device,
                             controls=True)
        print(json.dumps(dict(kind="sound", seed=seed, **r), default=float),
              flush=True)
    for seed in args.tf32_seeds:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            r = session_readings(cell, seed, args.seconds, args.device)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        print(json.dumps(dict(kind="tf32", seed=seed, **r), default=float),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
