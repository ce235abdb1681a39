"""Readings of faults planted in single rigs of a fleet cell, on the card.

    python3 benchmark/fleet_control.py --workload vo_x8_corridors \
        --seconds 15 --seeds <n> [<n> ...] [--save <dir>]

For each seed, one sound run of the cell as ``run.py`` makes it (set-up,
a window of ``--seconds``, the check, with ``control.py``'s controls),
then the pose numbers of the window's answers with a fault planted in
them, and whether the cell's limits would call the run correct
(``check.judge``, the sound run's ``feat_miss`` beside them):

- ``frozen_<k>``: rig ``k``'s frames answered with its pose before the
  window (a rig left out of the batch, or one whose state stopped);
- ``frozen_half``: rigs 0 to S/2 - 1 so;
- ``shifted_<s>``: rig ``s``'s frames answered with rig ``s - 1``'s pose
  of the same lockstep frame (a row off by one);
- ``shifted_all``: every rig answered so.

The stream's order is trajectory kind ``fleet``'s; the driver is
``drivers/multiseq_vo.py``'s (its ``state.pose`` after the warm-up
gives each rig's pose before the window). One JSON line per seed; all
seeds in one process. ``--save`` writes each run's answers, ground
truth and poses before the window to ``<dir>/fleet_<seed>.npz``.
``run.py`` never runs this.
"""

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(BENCH_DIR), BENCH_DIR]


def planted(poses, first_frame: int, held):
    """{fault name: answers [n, 7]} from the window's sound answers
    ``poses`` [n, 7] (stream frames ``first_frame`` on, whole lockstep
    frames) and each rig's pose before the window ``held`` [S, 7]."""
    from harness import cells

    fleet = cells.module("trajectories", "fleet")
    S = len(held)
    rig, t = fleet.rig_at(first_frame + np.arange(len(poses)), S)

    def frozen(which):
        out = poses.copy()
        for k in which:
            out[rig == k] = held[k]
        return out

    def shifted(which):
        out = poses.copy()
        for s in which:
            m = rig == s
            out[m] = poses[fleet.stream_index((s - 1) % S, t[m], S)
                           - first_frame]
        return out

    faults = {f"frozen_{k}": frozen([k]) for k in range(S)}
    faults["frozen_half"] = frozen(range(S // 2))
    faults.update({f"shifted_{s}": shifted([s]) for s in range(S)})
    faults["shifted_all"] = shifted(range(S))
    return faults


def fleet_readings(cell, seed, seconds, device, save=None):
    import torch

    import run as bench_run
    from harness import check
    from harness.drive import Session

    s = Session(cell, seed, device, time.perf_counter())
    held = s.driver.state.pose.cpu().numpy().astype(np.float64)
    s.window(seconds)
    run = s.run
    truth = s.truth(run.first_frame, len(run.poses))
    origin = s.truth(0, 1)[0]
    sound = bench_run.evaluate(s, seed, controls=True)
    ok, _ = check.judge(sound, cell.limits)
    out = dict(seed=seed, frames=run.frames, window_s=run.window_s,
               first_frame=run.first_frame, correct=ok, sound=sound,
               faults={})
    for name, ans in planted(run.poses, run.first_frame, held).items():
        r = check.pose_readings(ans, truth, origin)
        bad, _ = check.judge(dict(sound, **r), cell.limits)
        out["faults"][name] = dict(r, correct=bad)
    if save:
        np.savez(os.path.join(save, f"fleet_{seed}.npz"), poses=run.poses,
                 truth=truth, origin=origin, held=held,
                 first_frame=run.first_frame)
    del s
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="vo_x8_corridors")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save", default=None)
    args = ap.parse_args(argv)

    import run as bench_run
    import vslam_tpu_torch  # noqa: F401  (pins TF32 off)
    from harness import cells

    if args.device == "cuda":
        bench_run.steady_host()
    if args.save:
        os.makedirs(args.save, exist_ok=True)
    cell = cells.load(args.workload)
    for seed in args.seeds:
        print(json.dumps(fleet_readings(cell, seed, args.seconds, args.device,
                                        args.save), default=float),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
