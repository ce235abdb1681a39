"""Command-line SLAM driver.

Port of ``vslam_tpu/cli.py``; API-compatible with the reference
executable's flags (slam.cpp:346-362):
  --dataset-path  EuRoC directory (mav0 layout or the flat sample layout)
  --cam-calib     calibration JSON (cereal schema)
  --voc-path      optional DBoW2 text vocabulary (else trained online)
  --map-name      output map artifact (cereal-JSON layout, load_map.py ready)
  --show-gui      accepted for compatibility (headless; prints progress)

plus framework extras: --config (SlamConfig JSON), --max-frames, --no-loop,
--no-reloc, --metrics (JSONL per-frame metrics), --trace, --driver,
--tune-file, and the port's --device (the card unless ``cpu`` is asked
for; without a card the default raises). The HTML viewer and the overlay
flags of the reference are not ported yet (ROADMAP.md Queue 1) and are
not accepted.

Usage: python -m vslam_tpu_torch.cli --dataset-path ... --cam-calib ...
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# the driver of the most recent ``main`` call, for a caller that runs
# ``main`` in its own process and reads the run's counters afterwards
LAST_DRIVER = None


def _make_tuner(path: str):
    """Poll a JSON control file and apply changed params to the driver.

    Returns a callable; each invocation re-reads the file if its mtime
    changed and pushes new {param: value} entries through set_param.
    """
    import os

    state = {"mtime": 0.0, "vals": {}}

    def poll(target):
        if not path:
            return
        try:
            m = os.stat(path).st_mtime
        except OSError:
            return
        if m == state["mtime"]:
            return
        state["mtime"] = m
        try:
            with open(path) as f:
                vals = json.load(f)
        except (ValueError, OSError):
            return  # mid-write or malformed: retry next poll
        for k, v in vals.items():
            if state["vals"].get(k) != v:
                try:
                    target.set_param(k, v)
                    print(f"[tune] {k} = {v}", file=sys.stderr)
                except (ValueError, AttributeError) as e:
                    print(f"[tune] rejected {k}: {e}", file=sys.stderr)
        state["vals"] = vals

    return poll


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finish(args, seq, fids, est_pos, est_poses, lm_valid, lm_pos):
    """Evaluation (the align_svd button, slam.cpp:1712-1722) and the map
    artifact. Returns the ATE (NaN without ground truth)."""
    from .eval import ate as ate_mod
    from .io import map_io

    ate_val = float("nan")
    gt_out = np.zeros((0, 3))
    if seq.gt_positions is not None and len(fids) >= 3:
        est_t_ns = seq.timestamps[fids]
        ate_val = ate_mod.ate_rmse(est_t_ns, est_pos, seq.gt_timestamps,
                                   seq.gt_positions)
        gt_out = seq.gt_positions
        print(f"ATE RMSE: {ate_val:.3f} m over {len(fids)} keyframes",
              file=sys.stderr)

    cams = [((int(f), 0), est_poses[i]) for i, f in enumerate(fids)]
    lms = [(int(i), lm_pos[i]) for i in np.nonzero(lm_valid)[0]]
    out = f"{args.map_name}.json"
    map_io.save_map(out, cams, lms, est_pos, gt_out, ate_val)
    print(f"Saved map as {out} ({len(cams)} cameras, {len(lms)} landmarks)",
          file=sys.stderr)
    return ate_val


def main(argv=None):
    p = argparse.ArgumentParser(description="vslam_tpu_torch stereo SLAM")
    p.add_argument("--dataset-path", required=True)
    p.add_argument("--cam-calib", required=True)
    p.add_argument("--voc-path", default="")
    p.add_argument("--map-name", default="map")
    p.add_argument("--show-gui", action="store_true")
    p.add_argument("--config", default="")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--no-loop", action="store_true")
    p.add_argument("--no-reloc", action="store_true")
    p.add_argument("--metrics", default="")
    p.add_argument("--trace", default="", help="capture a torch.profiler "
                   "trace (Chrome trace, Perfetto-viewable) of the frame "
                   "loop into this directory")
    p.add_argument("--driver", default="slam",
                   choices=["slam", "streaming"],
                   help="'slam' = faithful per-frame driver (reloc + loop "
                   "closure, reference semantics); 'streaming' = the "
                   "streaming driver (loop closure and relocalization at "
                   "polls; they need --voc-path)")
    p.add_argument("--tune-file", default="", help="JSON file of "
                   "{param: value} polled during the run; changed values "
                   "are applied live via set_param, the headless "
                   "equivalent of the reference's pangolin::Var panel "
                   "(slam.cpp:223-310)")
    p.add_argument("--device", default="cuda", help="torch device to run "
                   "on: the card by default (an error without one), 'cpu' "
                   "on request")
    args = p.parse_args(argv)

    if args.driver == "streaming":
        return _main_streaming(args)

    from .config import SlamConfig
    from .io import calib as calib_mod
    from .io import euroc
    from .pipeline.slam import SlamSystem
    from .utils import profiling

    cfg = SlamConfig.from_json(args.config) if args.config else SlamConfig()
    if args.no_loop:
        cfg.enable_loop_closure = False
    if args.no_reloc:
        cfg.enable_relocalization = False

    calib = calib_mod.load_calibration(args.cam_calib)
    slam = SlamSystem(calib, cfg, device=args.device)
    seq = euroc.load_sequence(args.dataset_path)
    n = seq.num_frames if args.max_frames <= 0 else min(
        seq.num_frames, args.max_frames)
    print(f"Loaded {seq.num_frames} image pairs "
          f"({'with' if seq.gt_positions is not None else 'no'} ground truth)",
          file=sys.stderr)

    if args.voc_path:
        from .loop import vocabulary as vocab_mod

        slam.set_vocabulary(vocab_mod.load_dbow2_text(args.voc_path))
        print(f"Loaded vocabulary: {slam.voc.num_words} words",
              file=sys.stderr)

    metrics_f = open(args.metrics, "w") if args.metrics else None
    pf = euroc.Prefetcher(seq.image_paths[:n], depth=8, workers=2)
    tune_poll = _make_tuner(args.tune_file)
    t0 = time.perf_counter()
    with profiling.trace(args.trace or None):
        for i in range(n):
            if i % 25 == 0:
                tune_poll(slam)
            img_l, img_r = pf.get(i)
            t_frame = time.perf_counter()
            info = slam.process_frame(img_l, img_r)
            info["ms"] = round(1000 * (time.perf_counter() - t_frame), 2)
            if metrics_f:
                metrics_f.write(json.dumps(info) + "\n")
            if info["kind"] == "keyframe" or i % 50 == 0:
                print(f"[{i}/{n}] {info}", file=sys.stderr)
        _sync(slam.device)
    elapsed = time.perf_counter() - t0
    print(f"Processed {n} frames in {elapsed:.1f}s ({n / elapsed:.1f} fps)",
          file=sys.stderr)
    if metrics_f:
        metrics_f.close()

    global LAST_DRIVER
    LAST_DRIVER = slam
    fids, est_pos, est_poses = slam.keyframe_trajectory()
    _finish(args, seq, fids, est_pos, est_poses,
            slam.lm.valid.cpu().numpy(), slam.lm.pos.cpu().numpy())
    return 0


def _main_streaming(args):
    """Streaming-driver path."""
    from .config import SlamConfig
    from .io import calib as calib_mod
    from .io import euroc
    from .pipeline.streaming import StreamingSLAM, StreamingVO
    from .utils import profiling

    cfg = SlamConfig.from_json(args.config) if args.config else SlamConfig()
    if args.no_reloc or not args.voc_path:
        cfg.enable_relocalization = False
    if args.no_loop or not args.voc_path:
        cfg.enable_loop_closure = False

    calib = calib_mod.load_calibration(args.cam_calib)
    seq = euroc.load_sequence(args.dataset_path)
    n = seq.num_frames if args.max_frames <= 0 else min(
        seq.num_frames, args.max_frames)

    if cfg.enable_loop_closure or cfg.enable_relocalization:
        from .loop import vocabulary as vocab_mod

        voc = vocab_mod.load_dbow2_text(args.voc_path)
        print(f"Loaded vocabulary: {voc.num_words} words", file=sys.stderr)
        slam = StreamingSLAM(calib, cfg, voc, max_frames=n + 8,
                             device=args.device)
    else:
        slam = StreamingVO(calib, cfg, max_frames=n + 8, device=args.device)

    pf = euroc.Prefetcher(seq.image_paths[:n], depth=16, workers=3)
    tune_poll = _make_tuner(args.tune_file)
    t0 = time.perf_counter()
    with profiling.trace(args.trace or None):
        for lo in range(0, n, 64):
            tune_poll(slam)
            slam.run([pf.get(i) for i in range(lo, min(lo + 64, n))])
        _sync(slam.device)
    elapsed = time.perf_counter() - t0
    print(f"Processed {n} frames in {elapsed:.1f}s ({n / elapsed:.1f} fps, "
          f"streaming driver)", file=sys.stderr)

    res = slam.results()
    if args.metrics:
        with open(args.metrics, "w") as f:
            for i in range(res["frames"]):
                f.write(json.dumps({
                    "frame": i,
                    "kind": "keyframe" if bool(res["is_keyframe"][i])
                            else "track",
                    "inliers": int(res["inliers"][i]),
                    "ok": bool(res["tracked_ok"][i]),
                }) + "\n")

    global LAST_DRIVER
    LAST_DRIVER = slam
    fids, est_pos, est_poses = slam.keyframe_trajectory()
    _finish(args, seq, fids, est_pos, est_poses,
            slam.state.lm.valid.cpu().numpy(),
            slam.state.lm.pos.cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
