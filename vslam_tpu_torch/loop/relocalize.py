"""Relocalization after tracking loss.

Port of ``vslam_tpu/loop/relocalize.py`` (the reference's recovery path,
tracking.h:241-419): BoW query for the top candidate keyframes,
correspondence harvest against each candidate and its covisibility
neighbours, RANSAC PnP (>= 10 inliers) and the constant-velocity motion
gate, scaled by the frames lost and capped; bounded retries per
candidate. The RANSAC draws come from a ``torch.Generator`` or an
injected ``sampler`` (see ``closure.default_sampler``).
"""

from __future__ import annotations

from typing import Dict, Set

import numpy as np
import torch

from ..core.state import KeyframeState, LandmarkState
from ..geometry import cameras as cam_models
from ..geometry import lie
from ..solvers import pnp
from .closure import _pow2, default_sampler, harvest_correspondences


def relocalize(
    kf: KeyframeState,
    lm: LandmarkState,
    detector,
    cur_bits,
    cur_valid,
    cur_corners,
    bow: dict,
    graph: Dict[int, Set[int]],
    current_pose,
    vel,
    intr0,
    cam_name: str,
    motion_threshold: float,
    pnp_threshold: float,
    generator: torch.Generator = None,
    num_hypotheses: int = 256,
    max_retries: int = 5,
    max_candidates: int = 5,
    frames_lost: int = 1,
    gate_cap_mult: int = 12,
    sampler=None,
):
    """Returns (ok, T_w_c, inlier_pairs [(feat, landmark)], diag dict).

    The motion gate is ``motion_threshold * min(frames_lost,
    gate_cap_mult)``: a driver that reacts ``frames_lost`` frames after the
    loss compares against a coasted pose that has diverged per lost frame.
    ``diag`` records why the search ended: candidates tried, best PnP
    inlier count, best gate error.
    """
    sampler = sampler or default_sampler(generator)
    diag = {"candidates": 0, "best_n": 0, "best_gate_err": None,
            "gate": motion_threshold * min(max(1, int(frames_lost)),
                                           max(1, int(gate_cap_mult)))}
    candidates = detector.relocalization_candidates(bow, max_candidates)
    if not candidates:
        return False, None, [], diag
    diag["candidates"] = len(candidates)

    dev = kf.pose_l.device
    vel_log = lie.se3_log(vel)
    inv_cur = lie.se3_inv(current_pose)
    eff_gate = diag["gate"]

    for cand in candidates:
        sources = [cand, *sorted(graph.get(cand, ()))]
        lms, feats = harvest_correspondences(kf, lm, cur_bits, cur_valid,
                                             sources)
        if len(lms) < 5:
            # the reference aborts the whole search on a thin candidate
            # (tracking.h:339-341); keep trying the others instead
            continue
        cap = _pow2(len(lms))
        n = len(lms)
        points = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
        bearings = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
        points[:n] = lm.pos[torch.as_tensor(lms, device=dev)]
        bearings[:n] = cam_models.unproject(
            cam_name, intr0, cur_corners[torch.as_tensor(feats, device=dev)])
        valid = torch.arange(cap, device=dev) < n

        for _ in range(max_retries + 1):
            T_wc, inl, n_inl, _ = pnp.ransac_pnp(
                points, bearings, valid, pnp_threshold,
                num_hypotheses=num_hypotheses,
                sample_idx=sampler(valid, num_hypotheses))
            n_inl = int(n_inl)
            diag["best_n"] = max(diag["best_n"], n_inl)
            if n_inl < 10:
                continue
            se3_vel = lie.se3_log(lie.se3_mul(inv_cur, T_wc))
            err = float(torch.sum(torch.abs(se3_vel[:3] - vel_log[:3])))
            if diag["best_gate_err"] is None or err < diag["best_gate_err"]:
                diag["best_gate_err"] = round(err, 3)
            if err <= eff_gate:
                inl_np = inl[:n].cpu().numpy()
                pairs = [(int(feats[i]), int(lms[i]))
                         for i in np.nonzero(inl_np)[0]]
                return True, T_wc, pairs, diag
    return False, None, [], diag
