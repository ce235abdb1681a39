"""The port's learned-frontend VO over SuperPoint initialization seeds, on
the CPU: tests/test_learned_frontend.py::
test_learned_frontend_drives_vo_end_to_end through ``vslam_tpu_torch``.

    python tools/learned_vo_sweep.py --seeds 0 1 2 3 4 5 6 7
    python tools/learned_vo_sweep.py --seeds 16 --out run.pt

For each seed it trains the test's model (``synthetic.train_learned_
frontend``: 300 Adam steps at 2e-3 on the supervised batch of frames 0, 2,
4, 6, 8) and drives ``StreamingVO(feature_fn=...)`` and
``SlamSystem(feature_fn=...)`` over the test's world (16 frames, 320x240,
``synthetic.learned_config()``). It prints one JSON line per seed: the
first and last loss, a hash of the trained weights, per driver the tracked
share after frame 3, the keyframes, the keyframe ATE and whether the
JAX test's bars hold (tracked > 0.7, >= 3 keyframes, ATE < 1.3 m), and a
summary line with the pass rate. ``--out`` saves the last seed's results
(``torch.save``) for tests/test_torch_learned_vo.py.

The run is made to repeat: deterministic algorithms (the descriptor
loss's gather has a backward that accumulates with atomics on the CPU, so
two runs of one seed otherwise train two models), two intra-op threads,
and the AVX2 code paths of ATen, oneDNN and MKL, chosen through their
environment variables before torch loads (the AVX-512 paths round
differently, so a host without them would train another model). One torch
build then trains the same weights on every run; another build may not.
Imports no JAX.
"""

from __future__ import annotations

import os

REPEATABLE_CPU = {"ATEN_CPU_CAPABILITY": "avx2", "ONEDNN_MAX_CPU_ISA": "AVX2",
                  "MKL_CBWR": "AVX2", "OMP_NUM_THREADS": "2"}
os.environ.update(REPEATABLE_CPU)

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vslam_tpu_torch import synthetic  # noqa: E402
from vslam_tpu_torch.eval import ate  # noqa: E402
from vslam_tpu_torch.models.learned_frontend import make_feature_fn  # noqa
from vslam_tpu_torch.pipeline.slam import SlamSystem  # noqa: E402
from vslam_tpu_torch.pipeline.streaming import StreamingVO  # noqa: E402

TRAIN_FRAMES = [0, 2, 4, 6, 8]


def bars(ok, fids, ate_m):
    """The JAX test's bars: tracked share after frame 3 above 0.7, at
    least 3 keyframes, keyframe ATE under 1.3 m."""
    return bool(ok[3:].mean() > 0.7 and len(fids) >= 3 and ate_m < 1.3)


def run(seed, seq):
    t0 = time.perf_counter()
    model, losses = synthetic.train_learned_frontend(seq, TRAIN_FRAMES, seed,
                                                     device="cpu")
    train_s = time.perf_counter() - t0
    weights = hashlib.sha1(b"".join(
        p.detach().numpy().tobytes() for p in model.parameters()))

    def hook():
        return make_feature_fn(model, 256, synthetic.LEARNED_SCORE_THRESHOLD)

    out = dict(seed=seed, losses=losses.numpy(),
               weights_sha1=weights.hexdigest()[:16], train_seconds=train_s)
    vo = StreamingVO(seq.calib, synthetic.learned_config(), max_frames=32,
                     device="cpu", feature_fn=hook())
    vo.run(seq.images)
    fids, pos, _ = vo.keyframe_trajectory()
    res = vo.results()
    out.update(vo_frames=res["frames"], vo_ok=res["tracked_ok"], vo_fids=fids,
               vo_ate=ate.align_svd(pos, seq.poses[fids, :3])[2])
    slam = SlamSystem(seq.calib, synthetic.learned_config(), device="cpu",
                      feature_fn=hook())
    infos = [slam.process_frame(l, r) for l, r in seq.images]
    fids, pos, _ = slam.keyframe_trajectory()
    out.update(slam_ok=np.array([i["ok"] for i in infos]), slam_fids=fids,
               slam_finite=bool(np.isfinite(pos).all()),
               slam_ate=ate.align_svd(pos, seq.poses[fids, :3])[2])
    return out


def summary(r):
    return dict(
        seed=r["seed"], first_loss=float(r["losses"][0]),
        last_loss=float(r["losses"][-1]), weights_sha1=r["weights_sha1"],
        train_seconds=round(r["train_seconds"], 1),
        vo_tracked_after_3=float(r["vo_ok"][3:].mean()),
        vo_keyframes=len(r["vo_fids"]), vo_ate_m=float(r["vo_ate"]),
        vo_bars=bars(r["vo_ok"], r["vo_fids"], r["vo_ate"]),
        slam_tracked_after_3=float(r["slam_ok"][3:].mean()),
        slam_keyframes=len(r["slam_fids"]), slam_ate_m=float(r["slam_ate"]),
        slam_bars=bars(r["slam_ok"], r["slam_fids"], r["slam_ate"]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--out", help="torch.save the last seed's results here")
    args = ap.parse_args()
    torch.set_num_threads(int(REPEATABLE_CPU["OMP_NUM_THREADS"]))
    torch.use_deterministic_algorithms(True)
    seq = synthetic.generate(num_frames=16, num_points=500, seed=4)
    rows = []
    for seed in args.seeds:
        r = run(seed, seq)
        rows.append(summary(r))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps(dict(
        seeds=len(rows), vo_bars_met=sum(r["vo_bars"] for r in rows),
        slam_bars_met=sum(r["slam_bars"] for r in rows))), flush=True)
    if args.out:
        torch.save(r, args.out)


if __name__ == "__main__":
    main()
