"""Windowed bundle adjustment over the active keyframe set.

Port of ``vslam_tpu/pipeline/ba_window.py``: snapshot the active keyframe
pairs and landmarks into a fixed-shape ``BAProblem`` (the oldest active
pair fixed for gauge), solve it with ``solvers.ba.solve_ba_schur``, and
merge the result back, re-anchoring each landmark's ``p_c``.

Every gather index is bounded explicitly (the reference relies on XLA's
silent clamping), and the merge writes only the valid rows in place.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import KeyframeState, LandmarkState
from ..geometry import lie
from ..ops.compact import compact_indices, top_k
from ..solvers import ba


@dataclasses.dataclass
class WindowProblem:
    prob: ba.BAProblem
    sel_kf: torch.Tensor        # [W2] KF slots (W2 = W // 2 pairs)
    sel_kf_valid: torch.Tensor  # [W2]
    sel_lm: torch.Tensor        # [Lw] landmark slots
    sel_lm_valid: torch.Tensor  # [Lw]
    # in-window observations that did not fit the O cap
    obs_dropped: torch.Tensor = None  # [] int32


def build_window_problem(kf: KeyframeState, lm: LandmarkState, intr0, intr1,
                         W2: int = 12, Lw: int = 8192, O: int = 24576,
                         obs_per_lm: int = 0) -> WindowProblem:
    K = kf.frame_id.shape[0]
    dev = kf.frame_id.device
    dtype = kf.pose_l.dtype
    W2 = min(W2, K)
    L = lm.pos.shape[0]
    Lw = min(Lw, L)

    # ---- select active KF pairs (newest-first) ----
    act = kf.valid & kf.active
    prio = torch.where(act, torch.arange(K, dtype=torch.int32, device=dev),
                       torch.full((K,), -1, dtype=torch.int32, device=dev))
    sel_kf = top_k(prio, W2)[1]
    sel_kf_valid = act[sel_kf]

    # oldest active frame pair is the gauge
    big = torch.iinfo(torch.int32).max
    oldest = torch.min(torch.where(act, kf.frame_id,
                                   torch.full_like(kf.frame_id, big)))
    is_gauge = kf.frame_id[sel_kf] == oldest

    # cameras: w = 2*i (left) / 2*i+1 (right)
    poses = torch.stack([kf.pose_l[sel_kf], kf.pose_r[sel_kf]],
                        dim=1).reshape(2 * W2, 7)
    fixed = (is_gauge | ~sel_kf_valid).repeat_interleave(2)
    intr = torch.stack([intr0.expand(W2, 8), intr1.expand(W2, 8)],
                       dim=1).reshape(2 * W2, 8).to(dtype)

    # kf slot -> window pair index (row K is the sentinel for misses)
    kf_to_i = torch.full((K + 1,), -1, dtype=torch.int64, device=dev)
    kf_to_i[sel_kf[sel_kf_valid]] = torch.arange(W2, device=dev)[sel_kf_valid]

    # ---- select active landmarks ----
    sel_lm, sel_lm_valid = compact_indices(lm.active & lm.valid, Lw)
    sel_lm = torch.clamp(sel_lm, 0, L - 1)

    # ---- flatten + compact their windowed observations ----
    M = lm.obs_kf.shape[1]
    okf = lm.obs_kf[sel_lm].long()                  # [Lw, M]
    ocam = lm.obs_cam[sel_lm].long()
    ofeat = lm.obs_feat[sel_lm].long()
    pair_i = kf_to_i[torch.clamp(okf, 0, K)]        # [Lw, M]
    ovalid = (okf >= 0) & (pair_i >= 0) & sel_lm_valid[:, None]

    if 0 < obs_per_lm < M:
        # keep only the obs_per_lm newest in-window observations per
        # landmark (by the observing keyframe's frame id)
        recency = torch.where(ovalid, kf.frame_id[torch.clamp(okf, 0, K - 1)],
                              torch.full_like(okf, -1, dtype=torch.int32))
        cols = top_k(recency, obs_per_lm)[1]         # [Lw, k]
        okf = torch.gather(okf, 1, cols)
        ocam = torch.gather(ocam, 1, cols)
        ofeat = torch.gather(ofeat, 1, cols)
        ovalid = torch.gather(ovalid, 1, cols)
        M = obs_per_lm

    opoint = torch.arange(Lw, device=dev)[:, None].expand(Lw, M)

    flat_valid = ovalid.reshape(-1)
    oidx, o_sel_ok = compact_indices(flat_valid, O)
    oidx = torch.clamp(oidx, 0, flat_valid.shape[0] - 1)
    o_valid = flat_valid[oidx] & o_sel_ok
    o_kf = okf.reshape(-1)[oidx]
    o_cam = ocam.reshape(-1)[oidx]
    o_feat = ofeat.reshape(-1)[oidx]
    o_point = opoint.reshape(-1)[oidx]
    o_w = 2 * kf_to_i[torch.clamp(o_kf, 0, K)] + o_cam
    o_w = torch.where(o_valid, o_w, torch.zeros_like(o_w))
    N = kf.corners.shape[2]
    o_uv = kf.corners[torch.clamp(o_kf, 0, K - 1), torch.clamp(o_cam, 0, 1),
                      torch.clamp(o_feat, 0, N - 1)]

    prob = ba.BAProblem(
        poses=poses,
        pose_fixed=fixed,
        intr=intr,
        points=lm.pos[sel_lm],
        point_valid=sel_lm_valid,
        obs_cam=o_w.to(torch.int32),
        obs_point=o_point.to(torch.int32),
        obs_uv=o_uv.to(dtype),
        obs_valid=o_valid,
    )
    obs_dropped = (flat_valid.sum() - o_valid.sum()).to(torch.int32)
    return WindowProblem(prob, sel_kf, sel_kf_valid, sel_lm, sel_lm_valid,
                         obs_dropped)


def merge_window_result(kf: KeyframeState, lm: LandmarkState,
                        wp: WindowProblem, poses, points):
    """Write optimized poses [2*W2, 7] and points [Lw, 3] back (in place)
    and re-anchor p_c. Returns (kf, lm)."""
    K = kf.frame_id.shape[0]
    W2 = wp.sel_kf.shape[0]
    kv = wp.sel_kf_valid
    pl = poses.reshape(W2, 2, 7)
    kf.pose_l[wp.sel_kf[kv]] = pl[kv, 0]
    kf.pose_r[wp.sel_kf[kv]] = pl[kv, 1]
    lv = wp.sel_lm_valid
    rows = wp.sel_lm[lv]
    lm.pos[rows] = points[lv]

    # recompute p_c of updated landmarks from their (possibly updated) anchor
    anchor = lm.from_kf[wp.sel_lm].long()
    T_anchor = kf.pose_l[torch.clamp(anchor, 0, K - 1)]
    p_c = lie.se3_apply(lie.se3_inv(T_anchor), points)
    lm.pos_c[rows] = p_c[lv]
    return kf, lm


def run_window_ba(kf: KeyframeState, lm: LandmarkState, intr0, intr1,
                  cam_name: str = "ds", huber=1.0, max_iters: int = 20,
                  W2: int = 12, Lw: int = 8192, O: int = 24576,
                  obs_per_lm: int = 0):
    """Build, solve, merge. Returns (kf, lm, stats)."""
    wp = build_window_problem(kf, lm, intr0, intr1, W2=W2, Lw=Lw, O=O,
                              obs_per_lm=obs_per_lm)
    poses, points, stats = ba.solve_ba_schur(
        wp.prob, cam_name=cam_name, huber=huber, max_iters=max_iters)
    kf, lm = merge_window_result(kf, lm, wp, poses, points)
    return kf, lm, dict(stats, obs_dropped=wp.obs_dropped)
