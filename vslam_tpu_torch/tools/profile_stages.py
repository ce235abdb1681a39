"""Per-stage timing of the faithful driver's frame (port of the
repository's ``tools/profile_stages.py``).

Seeds ``SlamSystem`` on a 752x480 synthetic world for 6 frames, then
times every stage its frame dispatches (the reference's hot loop is
``next_step``, slam.cpp:1087-1458): feature extraction, landmark
projection and compaction, guided matching (the landmark top-2 kernel),
RANSAC PnP, the fused ``track_frame``, the host's whole tracking step,
stereo matching (the descriptor top-2 kernel), the window BA's build and
solve; then the host<->device transfer costs and the frames per second of
the remaining frames, and ``slam.timer.summary()``.

Each stage is recorded twice: its wall ms (the median of ``--reps``
blocking calls, each ended by a synchronize) and, as ``<stage>_device``,
its device ms per call from a ``torch.profiler`` window over
min(reps, 10) calls, with the device operations per call
(``<stage>_device_ops``: the launches the host makes) and the device
events the profiler saw (``<stage>_device_events``).

    python -m vslam_tpu_torch.tools.profile_stages [--frames N] [--reps N]
        [--json out.json] [--device cpu]

Runs on the card unless ``--device cpu`` is given (an error where there is
no card). On the CPU the "device" figures are the operators' self CPU
time. The original's persistent-compile-cache warming has no counterpart.
"""

from __future__ import annotations

import argparse
import json
import time


def profile(frames: int = 40, reps: int = 20, device="cuda",
            width: int = 752, height: int = 480, config=None):
    """The stage record (a dict of ms and counts) and the driver.
    ``config`` replaces the tool's ``SlamConfig`` (smaller worlds for
    tests)."""
    import numpy as np
    import torch

    from .. import resolve_device, synthetic
    from ..config import SlamConfig
    from ..frontend.features import extract_features
    from ..geometry import cameras as cam_models
    from ..ops import hamming
    from ..ops.compact import compact_indices
    from ..pipeline import ba_window, keyframe as kf_mod, tracking
    from ..pipeline.slam import SlamSystem
    from ..solvers import ba as ba_mod, pnp
    from ..utils.profiling import device_ms, sync, wall_ms

    dev = resolve_device(device)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device: {dev} ({card})", flush=True)

    seq = synthetic.generate(num_frames=max(frames + 10, 30), num_points=900,
                             width=width, height=height, seed=2)
    cfg = config or SlamConfig(enable_relocalization=False,
                               enable_loop_closure=False,
                               max_landmarks=65536, max_keyframes=1024)
    slam = SlamSystem(seq.calib, cfg, device=dev)

    out = {}

    def rec(name, ms):
        out[name] = ms
        print(f"{name:32s} {ms:9.3f} ms", flush=True)

    def stage(name, fn, n):
        """Blocking wall ms and device ms (profiler) of one stage."""
        wall = wall_ms(fn, n, dev)
        dev_ms, _, ops, seen = device_ms(fn, "", iters=min(n, 10),
                                         device=dev)
        out[name] = wall
        out[name + "_device"] = dev_ms
        out[name + "_device_ops"] = ops
        out[name + "_device_events"] = seen
        print(f"{name:32s} {wall:9.3f} ms wall  {dev_ms:8.3f} ms device  "
              f"{ops} device operations per call", flush=True)

    # ---- raw transfer costs ----
    img_np = np.asarray(seq.images[0][0])
    rec("h2d_image_752x480",
        wall_ms(lambda: torch.as_tensor(img_np).to(dev), reps, dev))
    scal = torch.ones((), device=dev) + 0
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        scal.item()
    rec("d2h_scalar_roundtrip", (time.perf_counter() - t0) / reps * 1e3)
    # the launch floor: a no-op on 8 elements plus synchronize
    x1 = torch.zeros(8, device=dev)
    rec("jit_noop_dispatch", wall_ms(lambda: x1 + 1, reps, dev))

    # ---- seed the system so state shapes are realistic ----
    for i in range(6):
        slam.process_frame(seq.images[i][0], seq.images[i][1])

    img_dev = slam._image(seq.images[6][0])
    img_r_dev = slam._image(seq.images[6][1])
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def extract(img):
        return extract_features(img, num_features=cfg.num_features,
                                quality_level=cfg.quality_level,
                                min_distance=cfg.min_distance,
                                rotate_features=cfg.rotate_features)

    stage("extract_features", lambda: extract(img_dev), reps)
    feats, feats_r = extract(img_dev), extract(img_r_dev)

    # guided landmark projection + compaction + matching (track_frame's
    # pieces)
    lm = slam.lm
    pose = slam.track.current_pose

    def proj_compact():
        proj, in_view = tracking.project_landmarks(
            lm, pose, slam.cam_name, slam.intr0, slam.width, slam.height,
            cfg.cam_z_threshold)
        sel, sel_valid = compact_indices(in_view, cfg.max_inview_landmarks,
                                         newest_first=True)
        sel = torch.clamp(sel, 0, lm.pos.shape[0] - 1)
        return proj[sel], sel, sel_valid & in_view[sel]

    stage("project+compact", proj_compact, reps)
    cand_proj, sel, sel_valid = proj_compact()

    def match_only():
        return hamming.match_landmarks(
            feats.bits, feats.valid, lm.bank_bits[sel], lm.bank_valid[sel],
            feats.corners, cand_proj, sel_valid,
            max_dist_2d=cfg.match_max_dist_2d, threshold=cfg.match_max_dist,
            ratio=cfg.match_next_best)

    stage("match_landmarks", match_only, reps)
    match_local, m_ok, _ = match_only()

    def pnp_only():
        bearings = cam_models.unproject(slam.cam_name, slam.intr0,
                                        feats.corners)
        points = lm.pos[sel][torch.clamp(match_local, min=0)]
        return pnp.ransac_pnp(points, bearings, m_ok, slam.pnp_threshold,
                              num_hypotheses=cfg.ransac_hypotheses,
                              generator=gen)

    stage("ransac_pnp", pnp_only, reps)

    # the fused track_frame (what the tracking step dispatches)
    def full_track():
        return tracking.track_frame(
            img_dev, slam.lm, pose, pose, slam.track.vel, slam.intr0,
            cam_name=slam.cam_name, num_features=cfg.num_features,
            inview_cap=cfg.max_inview_landmarks,
            width=slam.width, height=slam.height,
            z_threshold=cfg.cam_z_threshold,
            match_max_dist_2d=cfg.match_max_dist_2d,
            match_threshold=cfg.match_max_dist,
            match_ratio=cfg.match_next_best,
            pnp_threshold=slam.pnp_threshold,
            num_hypotheses=cfg.ransac_hypotheses,
            min_matches=cfg.ransac_min_matches,
            quality_level=cfg.quality_level,
            min_distance=cfg.min_distance,
            rotate_features=cfg.rotate_features, generator=gen)

    stage("track_frame_fused", full_track, reps)

    # the host's tracking step (upload, the fused step, one scalar read)
    def host_track_step():
        slam._run_tracking(slam._image(seq.images[7][0]))

    host_track_step()
    t0 = time.perf_counter()
    for _ in range(reps):
        host_track_step()
    rec("host _run_tracking (e2e)", (time.perf_counter() - t0) / reps * 1e3)

    # keyframe-path stages
    stage("stereo_match", lambda: kf_mod.stereo_match(
        feats, feats_r, slam.T_0_1, slam.intr0, slam.intr1,
        cam_name=slam.cam_name, threshold=cfg.match_max_dist,
        ratio=cfg.match_next_best,
        epipolar_threshold=cfg.epipolar_error_threshold)[0], reps)

    def build():
        return ba_window.build_window_problem(
            slam.kf, slam.lm, slam.intr0, slam.intr1,
            W2=cfg.window_cams // 2, Lw=cfg.window_points, O=cfg.window_obs)

    wp = build()
    rec("build_window_problem", wall_ms(build, max(reps // 2, 5), dev))

    # with the host early exit, as the faithful driver solves it
    stage("window_ba_solve", lambda: ba_mod.solve_ba_schur(
        wp.prob, cam_name=slam.cam_name, huber=cfg.ba_huber_px,
        max_iters=cfg.ba_max_iters, early_exit=True)[0], max(reps // 2, 5))

    # ---- end-to-end frames per second on the remaining frames ----
    n = 0
    sync(dev)
    t0 = time.perf_counter()
    for i in range(8, min(len(seq.images), 8 + frames)):
        slam.process_frame(seq.images[i][0], seq.images[i][1])
        n += 1
    sync(dev)
    elapsed = time.perf_counter() - t0
    # the e2e frames' own stats (the original counts stats[8:], which
    # skips the first two of them: the seed frames are 6 entries, not 8)
    kfs = sum(1 for s in slam.stats[-n:] if s["kind"] == "keyframe")
    rec("e2e_ms_per_frame", elapsed / n * 1e3)
    out["e2e_fps"] = n / elapsed
    out["frames"] = n
    out["keyframes"] = kfs
    out["backend"] = dev.type
    out["device_name"] = card
    print(f"\n# e2e: {out['e2e_fps']:.2f} fps over {n} frames ({kfs} "
          f"keyframes)", flush=True)
    # the driver's own per-stage timers
    out["timer"] = slam.timer.summary()
    print(json.dumps(out["timer"], indent=1), flush=True)
    return out, slam


def main(argv=None):
    """The command line; returns the record."""
    ap = argparse.ArgumentParser(
        prog="python -m vslam_tpu_torch.tools.profile_stages",
        description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="torch device to run "
                    "on: the card by default (an error without one), 'cpu' "
                    "on request")
    args = ap.parse_args(argv)
    out, _ = profile(frames=args.frames, reps=args.reps, device=args.device)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main()
