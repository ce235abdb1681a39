"""How ``correct`` is decided: the program's answers against the reference.

Run after the window has closed, with the peak memory read and the
program's driver freed. Every number compared is printed beside its
limit (``limits/<workload>.json``), which was set from the readings of
sound runs and of the control (PERF.md gives both).

- ``feat_miss``: the frontend (detect + describe) on the timed path. The
  program's features of window frames drawn from the seed (the left
  image, as the tracking step computed it inside the window) and of
  keyframes the window made, drawn from the seed (left and right, as the
  keyframe branch stored them), against the plain frontend
  (``frontend.extract``, float32) on the same images: the share of
  keypoints that the two sides (corner and 256 descriptor bits) do not
  have in common, over the larger of the two counts.
- ``rpe_med_mm``: the tracking answer of every frame of the window
  (guided matching through K1, PnP, and the map that the keyframe branch
  built through K2, triangulation and the window BA): the translation of
  each frame's motion since the previous frame, against the generator's
  ground truth; the median over the window's frames, in mm.
- ``rpe_p90_mm``: the 90th percentile of the same errors.
- ``ape_med_mm``: each window frame's position against the ground truth
  in the map's gauge (the first frame's camera), median, in mm: the
  tracking answer where the camera moves too little from frame to frame
  for ``rpe_med_mm`` to tell a frozen answer from a sound one.

The limits file names the numbers each cell compares; the rest are
printed and not compared. ``controls`` gives the controls' readings of
the same numbers (``control.py``; PERF.md has them beside the limits).
"""

from __future__ import annotations

import numpy as np
import torch

from . import frontend, geometry


def rel_translation_errors(est, true):
    """|t(inv(E_{f-1}) E_f) - t(inv(T_{f-1}) T_f)| per frame f >= 1."""
    def rel(P):
        return geometry.se3_compose(geometry.se3_inv(P[:-1]), P[1:])[:, :3]
    return np.linalg.norm(rel(np.asarray(est, np.float64))
                          - rel(np.asarray(true, np.float64)), axis=1)


def feature_miss(prog_corners, prog_desc, prog_valid, ref: frontend.Features):
    """Share of keypoints not common to both sides: a keypoint is common
    where the other side has one at the same pixel with the same 256
    bits."""
    rc = ref.corners[ref.valid].cpu()
    rd = frontend.pack_bits(ref.bits[ref.valid]).cpu()
    pc = prog_corners[prog_valid].cpu()
    pd = prog_desc[prog_valid].cpu()
    if len(rc) == 0 and len(pc) == 0:
        return 0.0
    key_r = {(float(x), float(y), bytes(d.numpy())) for (x, y), d in zip(rc, rd)}
    key_p = {(float(x), float(y), bytes(d.numpy())) for (x, y), d in zip(pc, pd)}
    return 1.0 - len(key_r & key_p) / max(len(key_r), len(key_p))


def answers(run, kf_answers, rng, sample: int):
    """The program's frontend answers to compare: the window frames the
    harness sampled (left image) and up to ``sample`` of the window's
    keyframes drawn by ``rng`` (left and right): [(frame, cam, corners
    [N, 2], packed bits [N, 32], valid [N])]."""
    out = [(f, 0, c, frontend.pack_bits(bits), v)
           for f, c, bits, v in run.frontend]
    pick = rng.choice(len(kf_answers), size=min(sample, len(kf_answers)),
                      replace=False)
    for i in np.sort(pick):
        f, c, d, v = kf_answers[i]
        out += [(f, cam, c[cam], d[cam], v[cam]) for cam in (0, 1)]
    return out


def reference_features(world, which, cfg, device, dtype=torch.float32):
    """The plain frontend's features of each (frame, cam) in ``which``."""
    return [frontend.extract(
        torch.as_tensor(world.frame(f)[cam]).to(device), cfg.num_features,
        cfg.quality_level, cfg.min_distance, dtype) for f, cam in which]


def frontend_reading(answers, refs):
    """``feat_miss`` over ``answers`` [(frame, cam, corners, packed bits,
    valid)] against the reference's features of the same images; None
    where there is nothing to compare."""
    if not answers:
        return None
    misses, total = 0.0, 0
    for (_, _, corners, desc, valid), ref in zip(answers, refs):
        m = feature_miss(corners, desc, valid, ref)
        n = max(int(ref.valid.sum()), int(valid.sum()), 1)
        misses += m * n
        total += n
    return misses / total


def control_answers(which, refs_low):
    """The plain frontend in lower precision as answers in the program's
    place."""
    return [(f, cam, r.corners, frontend.pack_bits(r.bits), r.valid)
            for (f, cam), r in zip(which, refs_low)]


def in_gauge(truth, origin):
    """Ground-truth poses expressed in the frame of the pose ``origin``
    (the program's world is its first frame's camera)."""
    inv = np.broadcast_to(geometry.se3_inv(np.asarray(origin, np.float64)),
                          truth.shape)
    return geometry.se3_compose(inv, truth)


def pose_readings(poses, truth, origin):
    """The pose numbers of the window's poses [n, 7] against the ground
    truth [n, 7], ``origin`` the ground truth of stream frame 0."""
    e = rel_translation_errors(poses, truth) * 1e3
    g = in_gauge(truth, origin)
    ape = np.linalg.norm(np.asarray(poses)[:, :3] - g[:, :3], axis=1) * 1e3
    return dict(rpe_med_mm=float(np.median(e)),
                rpe_p90_mm=float(np.percentile(e, 90)),
                ape_med_mm=float(np.median(ape)))


def pose_controls(poses, truth, origin, held):
    """The pose numbers of answers that break the guarantee that each
    frame's pose is its own: every frame answered with ``held``, the pose
    of the last frame before the window (a step that leaves the state
    unchanged)."""
    frozen = np.broadcast_to(np.asarray(held, np.float64),
                             np.asarray(poses).shape)
    f = pose_readings(frozen, truth, origin)
    return dict(control_frozen_rpe_med_mm=f["rpe_med_mm"],
                control_frozen_ape_med_mm=f["ape_med_mm"])


def judge(readings: dict, limits: dict):
    """(correct, {name: {value, limit}}) for every number the limits name;
    a missing or non-finite reading fails its limit."""
    checks, ok = {}, True
    for name, spec in limits["limits"].items():
        v = readings.get(name)
        good = v is not None and np.isfinite(v) and v <= spec["limit"]
        ok &= bool(good)
        checks[name] = {"value": v, "limit": spec["limit"]}
    return ok, checks
