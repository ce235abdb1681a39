"""The relocalization and loop-closure ablation with per-event diagnostics
(port of the repository's ``tools/ablation_reloc.py``).

Runs the bench's full-SLAM world (``bench_worlds.full_slam_world``) in four
variants: ``full`` (loop closure, global BA, relocalization), ``reloc``
(relocalization alone), ``lc`` (loop closure and global BA alone) and
``vo`` (neither), all with the same keyframe hygiene. A variant with
relocalization or loop closure runs ``StreamingSLAM``, the other
``StreamingVO``. Each row holds:

- the keyframe ATE, keyframes, tracked frames and the first lost frame
  after the bootstrap;
- the ATE of each gauge segment (keyframes before the first loss and
  after it), each aligned on its own: similar segment ATEs under a larger
  global ATE mean two self-consistent gauges that never merged;
- loops closed and global-BA merges;
- per relocalization event, the recovered pose's error against the
  ground truth at the frame the patch applied to, and the coasted pose's;
- the loop counters and the drift as a share of the path's length.

    python -m vslam_tpu_torch.tools.ablation_reloc [--runs 1] [--frames 288]
        [--features 300] [--poll-every 16] [--chunk 8]
        [--variants full,reloc,lc,vo] [--out PATH] [--device cpu]

Runs on the card unless ``--device cpu`` is given (an error where there is
no card). ``--chunk`` is ``StreamingSLAM``'s: the frames between the
boundaries at which it reads its logs, as the original's driver does.
"""

from __future__ import annotations

import argparse
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

VARIANTS = {
    "full": dict(full=True),
    "reloc": dict(full=False, reloc=True),
    "lc": dict(full=False, lc=True, gba=True),
    "vo": dict(full=False),
}


def segment_ate(fids, pos, gt, loss_frame):
    """ATE of the keyframes before ``loss_frame`` and of those from it
    on, each aligned on its own (a segment of fewer than 3 keyframes has
    none); with the keyframe count of each."""
    import numpy as np

    from ..eval import ate

    out = {}
    pre = np.asarray(fids) < loss_frame
    for tag, m in (("pre_loss", pre), ("post_loss", ~pre)):
        if m.sum() >= 3:
            out[f"ate_{tag}_m"] = float(ate.align_svd(pos[m], gt[m])[2])
        out[f"kf_{tag}"] = int(m.sum())
    return out


def run_variant(name, seq, voc, cfg, *, poll_every, chunk, num_frames,
                device="cuda"):
    """One run of ``cfg`` over ``seq``: the row of the table (without
    ``run`` and ``drift_pct``)."""
    import numpy as np

    from ..eval import ate
    from ..pipeline.streaming import StreamingSLAM, StreamingVO
    from ..utils.profiling import sync

    if cfg.enable_relocalization or cfg.enable_loop_closure:
        drv = StreamingSLAM(seq.calib, cfg, voc, max_frames=num_frames + 8,
                            poll_every=poll_every, chunk=chunk,
                            device=device)
    else:
        drv = StreamingVO(seq.calib, cfg, max_frames=num_frames + 8,
                          device=device)
    drv.run(seq.images[:num_frames])
    sync(drv.device)
    res = drv.results()
    fids, pos, _ = drv.keyframe_trajectory()
    gt = seq.poses[fids, :3]
    rmse = float(ate.align_svd(pos, gt)[2])

    ok = np.asarray(res["tracked_ok"])
    lost = np.nonzero(~ok[3:])[0]
    loss_frame = int(lost[0] + 3) if len(lost) else None

    rec = {
        "variant": name,
        "ate_m": rmse,
        "keyframes": len(fids),
        "tracked_frames": int(ok.sum()),
        "loss_frame": loss_frame,
        "loops_closed": len(getattr(drv, "loop_edges", [])),
        "gba_merges": getattr(drv, "gba_merges", 0),
    }
    if loss_frame is not None:
        rec.update(segment_ate(fids, pos, gt, loss_frame))

    # relocalization events: the recovered pose against the ground truth
    events = []
    traj = np.asarray(res["trajectory"])
    for d in getattr(drv, "reloc_diags", []):
        e = dict(d)
        if "T_wc" in d and d.get("applied_frame", -1) is not None:
            af = min(int(d["applied_frame"]), len(seq.poses) - 1)
            e["recovered_err_vs_gt_m"] = float(np.linalg.norm(
                np.asarray(d["T_wc"][:3]) - seq.poses[af, :3]))
            # how far the coasted pose had drifted at that frame
            if af < len(traj):
                e["coast_err_vs_gt_m"] = float(np.linalg.norm(
                    traj[af, :3] - seq.poses[af, :3]))
        events.append(e)
    rec["reloc_events"] = events
    if hasattr(drv, "loop_stats"):
        rec["loop_stats"] = dict(drv.loop_stats)
    return rec


def table(rows):
    """The printed table: one line per row."""
    lines = [f"{'variant':>8} {'ATE':>7} {'drift%':>6} {'pre':>6} "
             f"{'post':>6} {'loops':>5} {'reloc_ok':>8}"]
    for rec in rows:
        lines.append(
            f"{rec['variant']:>8} {rec['ate_m']:>7.3f} "
            f"{rec['drift_pct']:>6.2f} "
            f"{rec.get('ate_pre_loss_m', float('nan')):>6.3f} "
            f"{rec.get('ate_post_loss_m', float('nan')):>6.3f} "
            f"{rec['loops_closed']:>5} "
            f"{sum(1 for e in rec['reloc_events'] if 'T_wc' in e):>8}")
    return "\n".join(lines)


def ablate(variants, runs=1, frames=288, features=300, poll_every=16,
           chunk=8, device="cuda", world=None):
    """``{"traj_len_m", "rows"}`` over the variants; ``world`` is a
    ``full_slam_world`` result to reuse (else one is made)."""
    import numpy as np

    from .. import resolve_device
    from .bench_worlds import full_slam_world

    dev = resolve_device(device)
    seq, voc, make_cfg = world or full_slam_world(frames, features, dev)
    traj_len = float(np.linalg.norm(
        np.diff(seq.poses[:frames, :3], axis=0), axis=1).sum())
    out = {"traj_len_m": traj_len, "rows": []}
    for name in variants:
        for r in range(runs):
            rec = run_variant(name, seq, voc, make_cfg(**VARIANTS[name]),
                              poll_every=poll_every, chunk=chunk,
                              num_frames=frames,
                              device=dev)
            rec["run"] = r
            rec["drift_pct"] = 100.0 * rec["ate_m"] / traj_len
            out["rows"].append(rec)
            print(json.dumps(rec), flush=True)
    return out


def main(argv=None, world=None):
    """The command line; returns the record. ``world`` as in
    ``ablate``."""
    ap = argparse.ArgumentParser(
        prog="python -m vslam_tpu_torch.tools.ablation_reloc",
        description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--frames", type=int, default=288)
    ap.add_argument("--features", type=int, default=300)
    ap.add_argument("--poll-every", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(
        REPO, "artifacts", "ablation_reloc_cuda.json"))
    ap.add_argument("--variants", default="full,reloc,lc,vo")
    ap.add_argument("--device", default="cuda", help="torch device to run "
                    "on: the card by default (an error without one), 'cpu' "
                    "on request")
    args = ap.parse_args(argv)
    out = ablate(args.variants.split(","), args.runs, args.frames,
                 args.features, args.poll_every, args.chunk, args.device,
                 world)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"# wrote {args.out}; GT path length {out['traj_len_m']:.1f} m")
    print(table(out["rows"]))
    return out


if __name__ == "__main__":
    main()
