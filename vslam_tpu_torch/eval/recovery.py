"""The relocalization census of a streaming SLAM run: its loss episodes and
its relocalization attempts, read from the run's logs.

Plain numpy on what either package's ``StreamingSLAM`` exposes
(``results()``, ``reloc_events``, ``reloc_diags``), so that the seed sweep
(``tools/slam_seed_sweep.py``) and ``chip_smoke.py`` describe the JAX
package's runs and the port's the same way.
"""

from __future__ import annotations

import numpy as np

# frames_lost bins of the acceptance table: the motion gate grows with
# frames_lost (``motion_threshold * min(frames_lost, reloc_gate_cap_mult)``)
# up to 12 lost frames
FRAMES_LOST_BINS = (("2-3", 2, 3), ("4-7", 4, 7), ("8-11", 8, 11),
                    (">=12", 12, None))


def frames_lost_bin(frames_lost: int) -> str:
    for name, lo, hi in FRAMES_LOST_BINS:
        if frames_lost >= lo and (hi is None or frames_lost <= hi):
            return name
    return "<2"


def loss_episodes(tracked_ok, is_keyframe, reloc_events):
    """[(onset, length, end)] of every run of lost frames after frame 0.
    ``end`` says how the episode ended: ``relocalized`` (an accepted
    attempt polled within the episode or at its first tracked frame),
    ``rebootstrap`` (a keyframe inserted on a lost frame), whichever came
    first; ``self`` (tracking came back on its own); ``open`` (still lost
    at the end of the run)."""
    ok = np.asarray(tracked_ok, bool)
    kf = np.asarray(is_keyframe, bool)
    accepted = sorted(int(f) for f, a in reloc_events if a)
    out, f, n = [], 1, len(ok)
    while f < n:
        if ok[f]:
            f += 1
            continue
        e = f
        while e < n and not ok[e]:
            e += 1
        # frames f..e-1 lost; an attempt polled after frame a - 1 patches
        # frame a on; a keyframe on lost frame g re-anchors frame g + 1 on
        causes = [(a, "relocalized") for a in accepted if f < a <= e]
        causes += [(g + 1, "rebootstrap") for g in range(f, e) if kf[g]]
        end = ("open" if e == n else min(causes)[1] if causes else "self")
        out.append((f, e - f, end))
        f = e
    return out


def _qmul(a, b):
    """Hamilton product of xyzw quaternions."""
    (x1, y1, z1, w1), (x2, y2, z2, w2) = a, b
    return np.array([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                     w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2])


_CONJ = np.array([-1.0, -1.0, -1.0, 1.0])


def _rotate(q, v):
    return _qmul(_qmul(q, np.append(v, 0.0)), q * _CONJ)[:3]


def _compose(a, b):
    return np.concatenate([a[:3] + _rotate(a[3:], b[:3]),
                           _qmul(a[3:], b[3:])])


def _inverse(a):
    return np.concatenate([-_rotate(a[3:] * _CONJ, a[:3]), a[3:] * _CONJ])


def attempt_records(reloc_diags, trajectory, gt_poses, harvests=None):
    """One dict per relocalization attempt: its frame, ``frames_lost`` and
    bin, gate, candidates, the correspondences harvested per candidate
    (``harvests``, one list per attempt, where recorded), best PnP inliers
    and best gate error, whether it was accepted, and the error against
    ground truth (position in metres, rotation in degrees) of the coasted
    pose it started from (the newest frame's) and of the last tracked
    frame's pose. ``trajectory`` and ``gt_poses`` are [F, 7] poses
    (translation, then the xyzw quaternion); the run's frame 0 is placed
    on ground truth's frame 0 before the comparison."""
    traj = np.array(trajectory, np.float64)
    gt = np.array(gt_poses, np.float64)
    for poses in (traj, gt):
        poses[:, 3:] /= np.linalg.norm(poses[:, 3:], axis=1, keepdims=True)
    n = min(len(traj), len(gt))
    align = _compose(gt[0], _inverse(traj[0])) if n else None

    def err(f):
        if not 0 <= f < n:
            return None, None
        est = _compose(align, traj[f])
        cos = min(1.0, abs(float(np.dot(est[3:], gt[f, 3:]))))
        return (round(float(np.linalg.norm(est[:3] - gt[f, :3])), 4),
                round(float(np.degrees(2.0 * np.arccos(cos))), 3))

    out = []
    for i, d in enumerate(reloc_diags):
        frame, lost = int(d["frame"]), int(d["frames_lost"])
        applied = int(d.get("applied_frame", frame - 1))
        pos_now, rot_now = err(applied)
        pos_last, rot_last = err(frame - 1 - lost)
        out.append(dict(
            frame=frame, frames_lost=lost, bin=frames_lost_bin(lost),
            gate=d["gate"], candidates=d["candidates"],
            harvest=None if harvests is None or i >= len(harvests)
            else list(harvests[i]),
            best_n=d["best_n"], best_gate_err=d["best_gate_err"],
            ok="T_wc" in d, coasted_err_m=pos_now, coasted_err_deg=rot_now,
            last_tracked_err_m=pos_last, last_tracked_err_deg=rot_last))
    return out


def acceptance_by_bin(records):
    """{bin: [accepted, attempts]} over attempt records, in bin order."""
    out = {name: [0, 0] for name, _, _ in FRAMES_LOST_BINS}
    for r in records:
        acc = out.setdefault(r["bin"], [0, 0])
        acc[0] += bool(r["ok"])
        acc[1] += 1
    return out
