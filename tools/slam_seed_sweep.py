"""Seed sweep of the injected-drift SLAM scenario (tests/test_streaming_slam
.py, ``chip_smoke.py`` phase 6), for the JAX package or the port.

    python tools/slam_seed_sweep.py --backend torch --device cuda --seeds 0 1 2
    JAX_PLATFORMS=cpu python tools/slam_seed_sweep.py --backend jax --seeds 0 1

For each RANSAC seed (``SlamConfig.seed``) it runs three arms on the pano
revisit world (``generate_pano_loop(num_frames=256, revolutions=1.75,
seed=2)``, the test's ``pano_config``): clean VO, VO with the drift crept
into the live gauge over frames 110-150, and StreamingSLAM (GBA after
loop on) with the same injection. It prints one JSON line per run
(keyframe ATE, loops with their frames, GBA merges, tracked share) and a
summary line with the bars of the JAX test evaluated per seed. The world
is chaotic: a seed's outcome says little, the spread over seeds says how
far a single run can be trusted. The torch backend imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def torch_backend(device):
    import torch

    import chip_smoke as cs
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.pipeline.streaming import StreamingSLAM, StreamingVO
    from vslam_tpu_torch.synthetic_pano import generate_pano_loop

    dev = torch.device(device)
    seq = generate_pano_loop(num_frames=256, revolutions=1.75, seed=2)
    images = [(torch.as_tensor(l).to(dev), torch.as_tensor(r).to(dev))
              for l, r in seq.images]
    voc = cs.train_vocabulary(seq.images, range(0, 256, 8), 600, dev)

    def make(arm, seed):
        cfg = cs.pano_config(SlamConfig)
        cfg.seed = seed
        if arm == "slam":
            cfg.enable_gba_after_loop = True
            return StreamingSLAM(seq.calib, cfg, voc, max_frames=288,
                                 poll_every=16, device=dev)
        cfg.enable_loop_closure = False
        return StreamingVO(seq.calib, cfg, max_frames=288, device=dev)

    def run(drv, inject):
        if inject:
            cs.run_with_injection(drv, images, dev)
        else:
            drv.run(images)

    return seq, make, run, lambda drv: cs.keyframe_ate(drv, seq)


def jax_backend():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import jax

    import test_streaming_slam as T
    from vslam_tpu.pipeline.streaming import StreamingSLAM, StreamingVO

    seq, voc = T.pano.__wrapped__()

    def make(arm, seed):
        cfg = T.pano_config()
        cfg.seed = seed
        if arm == "slam":
            cfg.enable_gba_after_loop = True
            return StreamingSLAM(seq.calib, cfg, voc, max_frames=288,
                                 poll_every=16)
        cfg.enable_loop_closure = False
        return StreamingVO(seq.calib, cfg, max_frames=288)

    def run(drv, inject):
        if inject:
            T._run_with_injection(drv, seq)
        else:
            drv.run(seq.images)
            jax.block_until_ready(drv.state.frame)

    return seq, make, run, lambda drv: float(T._keyframe_ate(drv, seq))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", choices=("torch", "jax"), required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    if args.backend == "torch":
        seq, make, run, kf_ate = torch_backend(args.device)
        where = args.device
    else:
        seq, make, run, kf_ate = jax_backend()
        where = "jax-" + os.environ.get("JAX_PLATFORMS", "default")
    if where == "cuda":
        import torch

        where = torch.cuda.get_device_name(0)
    rows = []
    for seed in args.seeds:
        for arm in ("clean", "injected", "slam"):
            drv = make(arm, seed)
            t0 = time.perf_counter()
            run(drv, inject=arm != "clean")
            row = dict(backend=args.backend, device=where, seed=seed,
                       arm=arm, kf_ate_m=kf_ate(drv),
                       tracked=float(np.mean(drv.results()["tracked_ok"][3:])),
                       seconds=time.perf_counter() - t0)
            if arm == "slam":
                row.update(
                    loops=[[int(a), int(b)] for a, b in drv.loop_edges],
                    loop_frames=[[int(drv.frame_of_slot[a]),
                                  int(drv.frame_of_slot[b])]
                                 for a, b in drv.loop_edges],
                    gba_merges=int(drv.gba_merges))
            rows.append(row)
            print(json.dumps(row), flush=True)
    by = {(r["seed"], r["arm"]): r for r in rows}
    bars = []
    for seed in args.seeds:
        floor, vo, slam = (by[(seed, a)]["kf_ate_m"]
                           for a in ("clean", "injected", "slam"))
        s = by[(seed, "slam")]
        gaps = [a - b for a, b in s["loop_frames"]]
        break_vo = max(vo ** 2 - floor ** 2, 0.0)
        break_slam = max(slam ** 2 - floor ** 2, 0.0)
        bars.append(dict(
            seed=seed, loop_across_break=bool(gaps and gaps[0] > 20),
            injection_separates=break_vo > 0,
            removed_over_20pct=bool(break_vo > 0
                                    and 1 - break_slam / break_vo > 0.2),
            slam_below_vo=slam < vo, slam_below_5m=slam < 5.0,
            tracked_over_90pct=s["tracked"] > 0.9,
            gba_merge=s["gba_merges"] >= 1))
    print(json.dumps({"bars_by_seed": bars}), flush=True)


if __name__ == "__main__":
    main()
