"""Seed sweeps of two SLAM scenarios, for the JAX package or the port.

    python tools/slam_seed_sweep.py --backend torch --device cuda --seeds 0 1 2
    JAX_PLATFORMS=cpu python tools/slam_seed_sweep.py --backend jax --seeds 0 1
    python tools/slam_seed_sweep.py --scenario faithful --backend torch \
        --device cpu --seeds 0 1 2 3 4 5

``--scenario injected`` (the default) is the injected-drift scenario of
tests/test_streaming_slam.py (``chip_smoke.py`` phase 6).

For each RANSAC seed (``SlamConfig.seed``) it runs three arms on the pano
revisit world (``generate_pano_loop(num_frames=256, revolutions=1.75,
seed=2)``, the test's ``pano_config``): clean VO, VO with the drift crept
into the live gauge over frames 110-150, and StreamingSLAM (GBA after
loop on) with the same injection. It prints one JSON line per run
(keyframe ATE, loops with their frames, GBA merges, tracked share) and a
summary line with the bars of the JAX test evaluated per seed. The world
is chaotic: a seed's outcome says little, the spread over seeds says how
far a single run can be trusted. The torch backend imports no JAX.

``--scenario faithful`` runs the faithful driver (``SlamSystem``) with loop
closure, relocalization and the global BA against its ``--no-loop
--no-reloc`` control, at ``chip_smoke.py`` phase 8's configuration
(``bench.full_slam_world``'s: 300 features, 4 observations per landmark
in the window BA) on a reduced pano world,
``generate_pano_loop(num_frames=288, width=320, height=240,
revolutions=1.75, seed=2)``; each package trains its vocabulary (k=10,
depth 4) on its own features of every 12th frame. One JSON line per run
(keyframe ATE, loops with their frames, GBA merges, relocalizations,
lost frames) and a summary of the SLAM / control ratios per seed.
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


FAITHFUL_WORLD = dict(num_frames=288, width=320, height=240,
                      revolutions=1.75, seed=2)


def faithful_torch(device):
    import torch

    import chip_smoke as cs
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.pipeline.slam import SlamSystem
    from vslam_tpu_torch.synthetic_pano import generate_pano_loop

    dev = torch.device(device)
    seq = generate_pano_loop(**FAITHFUL_WORLD)
    images = [(torch.as_tensor(l).to(dev), torch.as_tensor(r).to(dev))
              for l, r in seq.images]
    n = len(images)
    voc = cs.train_vocabulary(seq.images, range(0, n, n // 24), 300, dev)

    def make(cfg):
        slam = SlamSystem(seq.calib, cfg, device=dev)
        slam.set_vocabulary(voc)
        return slam

    return (lambda: cs.full_slam_config(SlamConfig, True), make, images,
            lambda drv: cs.keyframe_ate(drv, seq))


def faithful_jax():
    import jax.numpy as jnp

    import chip_smoke as cs
    from vslam_tpu.config import SlamConfig
    from vslam_tpu.eval import ate
    from vslam_tpu.frontend.features import extract_features
    from vslam_tpu.loop import vocabulary as vocab_mod
    from vslam_tpu.pipeline.slam import SlamSystem
    from vslam_tpu.synthetic_pano import generate_pano_loop

    seq = generate_pano_loop(**FAITHFUL_WORLD)
    n = len(seq.images)
    pool = []
    for f in range(0, n, n // 24):
        ft = extract_features(jnp.asarray(seq.images[f][0]),
                              num_features=300, quality_level=0.001)
        pool.append(np.asarray(ft.bits)[np.asarray(ft.valid)])
    voc = vocab_mod.train(np.concatenate(pool), k=10, depth=4, seed=0)
    vocab_mod.set_idf_weights(voc, pool)

    def make(cfg):
        slam = SlamSystem(seq.calib, cfg)
        slam.set_vocabulary(voc)
        return slam

    def kf_ate(drv):
        fids, pos, _ = drv.keyframe_trajectory()
        return float(ate.align_svd(pos, seq.poses[fids, :3])[2])

    return (lambda: cs.full_slam_config(SlamConfig, True), make,
            seq.images, kf_ate)


def sweep_faithful(args, where):
    """The faithful driver against its control over ``args.seeds``."""
    if args.backend == "torch":
        config, make, images, kf_ate = faithful_torch(args.device)
    else:
        config, make, images, kf_ate = faithful_jax()
    ratios = {}
    for seed in args.seeds:
        ate_of = {}
        for arm in ("slam", "control"):
            cfg = config()
            cfg.seed = seed
            if arm == "control":
                cfg.enable_loop_closure = False
                cfg.enable_relocalization = False
                cfg.enable_gba_after_loop = False
            drv = make(cfg)
            t0 = time.perf_counter()
            for img_l, img_r in images:
                drv.process_frame(img_l, img_r)
            ate_of[arm] = kf_ate(drv)
            fid = drv.kf.frame_id
            fid = np.asarray(fid.cpu() if hasattr(fid, "cpu") else fid)
            events = getattr(drv, "reloc_events", None)  # the port's only
            row = dict(
                scenario="faithful", backend=args.backend, device=where,
                seed=seed, arm=arm, kf_ate_m=ate_of[arm],
                keyframes=len(drv.slot_of_frame),
                loop_frames=[[int(fid[a]), int(fid[b])]
                             for a, b in drv.loop_edges],
                gba_merges=int(drv.gba_merges),
                reloc_ok=None if events is None else
                sum(bool(ok) for _, ok in events),
                reloc_attempts=None if events is None else len(events),
                lost_frames=int(sum(not s["ok"] for s in drv.stats)),
                seconds=time.perf_counter() - t0)
            print(json.dumps(row), flush=True)
        ratios[seed] = ate_of["slam"] / ate_of["control"]
    r = np.asarray(list(ratios.values()))
    print(json.dumps(dict(
        scenario="faithful", backend=args.backend, device=where,
        slam_over_control={str(k): round(v, 3) for k, v in ratios.items()},
        median=float(np.median(r)), min=float(r.min()), max=float(r.max()),
        within_1_15=int((r <= 1.15).sum()), seeds=len(r))), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", choices=("torch", "jax"), required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--scenario", choices=("injected", "faithful"),
                    default="injected")
    args = ap.parse_args()
    if args.backend == "torch":
        where = args.device
    else:
        where = "jax-" + os.environ.get("JAX_PLATFORMS", "default")
    if where == "cuda":
        import torch

        where = torch.cuda.get_device_name(0)
    if args.scenario == "faithful":
        sweep_faithful(args, where)
        return
    if args.backend == "torch":
        seq, make, run, kf_ate = torch_backend(args.device)
    else:
        seq, make, run, kf_ate = jax_backend()
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
