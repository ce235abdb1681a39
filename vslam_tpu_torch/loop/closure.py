"""Loop closure: SE(3) loop correction, geometric verification,
essential-graph optimization and the map update.

Port of ``vslam_tpu/loop/closure.py``:

- ``compute_sim3`` (sim3.h:228-359): harvest 2D-3D correspondences
  between the current keyframe's features and the map points of the loop
  candidate and its covisible neighbours (deduplicated by landmark and by
  feature), RANSAC PnP, two guided re-matching + Gauss-Newton rounds and
  an arbiter; the correction is ``sim3 = T_w_cand^-1 * T_w_cur_measured``
  with the ||log||_1 <= 5 sanity gate and bounded retries (stereo fixes
  scale, hence SE3);
- ``compute_sim3_horn`` (sim3.h:48-141): the closed-form alternative from
  3D-3D landmark pairs (``geometry/sim3.ransac_sim3``), with a gate on the
  recovered scale (``sim3_solver="horn"``);
- ``verify_loop``: the candidate side's landmarks projected through the
  proposed correction, counted by gated descriptor matches;
- ``loop_closure`` (loop_closure_utils.h:398-622): the live group moved
  rigidly onto the old map, the essential pose graph, right cameras and
  landmarks re-derived.

The guided matching of ``_guided_refine_device`` and
``_verify_loop_device`` is ``hamming.match_landmarks`` at P = ``cap`` =
1024 landmarks: the landmark top-2 kernel on the card. The harvest matches
through ``matching.match_vs_keyframes`` (the descriptor top-2 kernel).

The RANSAC draws of ``compute_sim3`` come from a ``torch.Generator``, or
from an injected ``sampler(valid, num_hypotheses) -> [H, 6]`` indices
(torch cannot reproduce ``jax.random``; tests inject the reference's
draws); ``compute_sim3_horn`` takes ``sample_idx`` [H, 3] the same way.
Above ``POSE_GRAPH_DENSE_MAX`` keyframes ``loop_closure`` solves the pose
graph with the matrix-free ``solvers/pose_graph_cg``.

Masked writes select their entries first (the reference's
``mode="drop"`` scatters point masked entries out of bounds, which on the
card is a device-side assert).
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np
import torch

from ..core.state import KeyframeState, LandmarkState
from ..geometry import cameras as cam_models
from ..geometry import lie
from ..ops import describe as describe_ops
from ..ops import hamming
from ..ops.compact import compact_indices
from ..geometry import sim3 as sim3_mod
from ..solvers import pnp, pose_graph, pose_graph_cg
from . import matching

# dense pose-graph LM up to this many keyframes (rounded up to a power of
# two, the reference's shape bucket); matrix-free CG above
POSE_GRAPH_DENSE_MAX = 1024


def _pow2(n: int, lo: int = 16) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def default_sampler(generator: torch.Generator = None):
    """The RANSAC sampler of ``StreamingSLAM``: Gumbel top-k draws of 6
    distinct valid indices per hypothesis from ``generator``."""
    def sample(valid, num_hypotheses):
        return pnp.sample_minimal(valid, num_hypotheses, 6, generator)
    return sample


def _rigid_align_device(pose_l, pose_r, group, T_cand, sim3, T_cur_pre,
                        T_0_1):
    """Move the keyframes in ``group`` (slot index tensor) by T_corr =
    (T_cand * sim3) * T_cur_pre^-1. Returns (pose_l, pose_r, T_corr)."""
    T_corr = lie.se3_normalize(lie.se3_mul(lie.se3_mul(T_cand, sim3),
                                           lie.se3_inv(T_cur_pre)))
    moved = lie.se3_mul(T_corr.expand(len(group), 7), pose_l[group])
    pose_l, pose_r = pose_l.clone(), pose_r.clone()
    pose_l[group] = moved
    pose_r[group] = lie.se3_mul(moved, T_0_1.expand(len(group), 7))
    return pose_l, pose_r, T_corr


def corr_apply(T_cand, sim3, T_cur_kf, cur_pose, last_pose):
    """Tracker-side gauge correction: T_corr = (T_w_cand * sim3) *
    T_w_cur^-1 applied to the live tracker poses. Returns (T_corr @
    cur_pose, T_corr @ last_pose)."""
    T_corr = lie.se3_normalize(lie.se3_mul(lie.se3_mul(T_cand, sim3),
                                           lie.se3_inv(T_cur_kf)))
    return lie.se3_mul(T_corr, cur_pose), lie.se3_mul(T_corr, last_pose)


def _edge_measurements(poses_pre, ei, ej, sim3, e_loop: int):
    """log(T_i^-1 T_j) per edge; row ``e_loop`` carries the loop edge
    log(sim3^-1)."""
    meas = lie.se3_log(lie.se3_mul(lie.se3_inv(poses_pre[ei]),
                                   poses_pre[ej]))
    meas[e_loop] = lie.se3_log(lie.se3_inv(sim3))
    return meas


def _batched_matches(kf: KeyframeState, cur_bits, cur_valid,
                     source_slots: Sequence[int], cur_slot: int, extra=None):
    """Match the current descriptors against every source keyframe.
    Returns (slots, m_all [S, N], mp_all [S, N], extra) as host numpy;
    ``extra`` is an optional tensor fetched along."""
    extra_h = extra.cpu().numpy() if extra is not None else None
    slots = [int(s) for s in source_slots if int(s) != int(cur_slot)]
    if not slots:
        return [], None, None, extra_h
    m = matching.match_vs_keyframes(cur_bits, cur_valid, kf, slots, 0)
    mp = kf.map_points[torch.as_tensor(slots, dtype=torch.long,
                                       device=kf.map_points.device)]
    return slots, m.cpu().numpy(), mp.cpu().numpy(), extra_h


def harvest_correspondences(
    kf: KeyframeState,
    lm: LandmarkState,
    cur_bits,
    cur_valid,
    source_slots: Sequence[int],
    cur_slot: int = -1,
) -> Tuple[np.ndarray, np.ndarray]:
    """(landmark ids, current-feature ids) harvested over source keyframes
    (sim3.h:244-301 / tracking.h:283-338): match the current descriptors
    against each source keyframe, map matched source features to landmarks
    through its map_points, dedupe by landmark and by current feature."""
    slots, m_all, mp_all, _ = _batched_matches(kf, cur_bits, cur_valid,
                                               source_slots, cur_slot)
    used_landmarks: Set[int] = set()
    used_features: Set[int] = set()
    lms: List[int] = []
    feats: List[int] = []
    for si in range(len(slots)):
        m, mp = m_all[si], mp_all[si]
        for f in np.nonzero((m >= 0) & (mp >= 0))[0]:
            tid, cf = int(mp[f]), int(m[f])
            if tid in used_landmarks or cf in used_features:
                continue
            used_landmarks.add(tid)
            used_features.add(cf)
            lms.append(tid)
            feats.append(cf)
    return np.asarray(lms, np.int64), np.asarray(feats, np.int64)


def _source_mask(kf: KeyframeState, cur_slot: int, slots) -> torch.Tensor:
    kmask = np.zeros(kf.frame_id.shape[0], bool)
    for s in slots:
        if s != cur_slot:
            kmask[s] = True
    return torch.as_tensor(kmask, device=kf.frame_id.device)


def compute_sim3(
    kf: KeyframeState,
    lm: LandmarkState,
    cur_slot: int,
    cand_slot: int,
    cand_neighbors: Sequence[int],
    intr0,
    cam_name: str,
    pnp_threshold: float,
    generator: torch.Generator = None,
    num_hypotheses: int = 256,
    max_retries: int = 10,
    sampler=None,
):
    """Returns (ok, sim3 [7]): sim3 = T_w_cand^-1 * T_w_cur_measured.
    ``sampler`` overrides the draws from ``generator`` (see module doc)."""
    sampler = sampler or default_sampler(generator)
    dev = kf.pose_l.device
    cur_bits = describe_ops.unpack_bits(kf.desc[cur_slot, 0])
    cur_valid = kf.kp_valid[cur_slot, 0]
    lms, feats = harvest_correspondences(
        kf, lm, cur_bits, cur_valid, [cand_slot, *cand_neighbors],
        cur_slot=cur_slot)
    if len(lms) < 5:
        return False, None

    # padded to a power of two as the reference pads (lo=16): a minimal
    # sample of 6 then always exists, and injected reference draws index
    # the same rows
    cap = _pow2(len(lms))
    n = len(lms)
    points = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
    bearings = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
    points[:n] = lm.pos[torch.as_tensor(lms, device=dev)]
    bearings[:n] = cam_models.unproject(
        cam_name, intr0,
        kf.corners[cur_slot, 0][torch.as_tensor(feats, device=dev)])
    valid = torch.arange(cap, device=dev) < n

    T_cand_inv = lie.se3_inv(kf.pose_l[cand_slot])
    kmask = _source_mask(kf, cur_slot, (cand_slot, *cand_neighbors))
    for _ in range(max_retries + 1):
        T_wc, _inl, _n, _ok = pnp.ransac_pnp(
            points, bearings, valid, pnp_threshold,
            num_hypotheses=num_hypotheses,
            sample_idx=sampler(valid, num_hypotheses))
        # guided re-matching + refinement through the estimate, twice, then
        # the arbiter: keep whichever of the RANSAC and refined poses
        # explains more of the candidate-side map (see the reference)
        T_pre = T_wc
        for _ in range(2):
            T_wc, _n_guided = _guided_refine_device(
                kf, lm, cur_slot, kmask, T_wc, intr0, cam_name=cam_name)
        _, n_ref = _guided_refine_device(kf, lm, cur_slot, kmask, T_wc,
                                         intr0, cam_name=cam_name,
                                         gn_iters=0)
        _, n_pre = _guided_refine_device(kf, lm, cur_slot, kmask, T_pre,
                                         intr0, cam_name=cam_name,
                                         gn_iters=0)
        T_wc = torch.where(n_pre > n_ref, T_pre, T_wc)
        sim3 = lie.se3_mul(T_cand_inv, T_wc)
        if float(torch.sum(torch.abs(lie.se3_log(sim3)[:3]))) <= 5.0:
            return True, sim3
    return False, None


def compute_sim3_horn(
    kf: KeyframeState,
    lm: LandmarkState,
    cur_slot: int,
    cand_slot: int,
    cand_neighbors: Sequence[int],
    generator: torch.Generator = None,
    threshold_3d: float = 0.3,
    num_hypotheses: int = 128,
    max_scale_log: float = 0.1,
    sample_idx=None,
):
    """Closed-form Sim(3) loop correction from 3D-3D correspondences
    (compute_sim3_1, sim3.h:48-141): matched features give pairs
    (current-side landmark, candidate-side landmark), the same physical
    point in the drifted and the old map frame, and a Horn / RANSAC
    alignment recovers the similarity between them. Stereo observes scale,
    so a recovered scale far from 1 marks a bad closure; the accepted
    correction is the SE3 loop edge
    ``sim3 = T_w_cand^-1 * (S o T_w_cur_drift)``.

    Returns (ok, sim3 [7], scale). ``sample_idx`` [H, 3] overrides the
    draws from ``generator``.
    """
    dev = kf.pose_l.device
    cur_bits = describe_ops.unpack_bits(kf.desc[cur_slot, 0])
    cur_valid = kf.kp_valid[cur_slot, 0]

    slots, m_all, mp_all, mp_cur = _batched_matches(
        kf, cur_bits, cur_valid, (cand_slot, *cand_neighbors), cur_slot,
        extra=kf.map_points[cur_slot])
    src_ids: List[int] = []
    dst_ids: List[int] = []
    used_dst: Set[int] = set()
    for si in range(len(slots)):
        # m[f] = current-feature index matched by candidate feature f
        m, mp_s = m_all[si], mp_all[si]
        for f in np.nonzero((m >= 0) & (mp_s >= 0))[0]:
            sid = int(mp_cur[int(m[f])])  # current side (drifted world)
            tid = int(mp_s[f])            # candidate side (old world)
            if sid < 0 or tid == sid or tid in used_dst:
                continue
            used_dst.add(tid)
            src_ids.append(sid)
            dst_ids.append(tid)
    if len(src_ids) < 5:
        return False, None, 0.0

    n = len(src_ids)
    cap = _pow2(n)
    src = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
    dst = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
    src[:n] = lm.pos[torch.as_tensor(src_ids, device=dev)]
    dst[:n] = lm.pos[torch.as_tensor(dst_ids, device=dev)]
    valid = torch.arange(cap, device=dev) < n

    S, _inl, _n_inl, ok = sim3_mod.ransac_sim3(
        src, dst, valid, threshold=threshold_3d,
        num_hypotheses=num_hypotheses, generator=generator,
        sample_idx=sample_idx)

    # corrected current pose: S o T_w_cur (rigid action of the similarity)
    T_cur = kf.pose_l[cur_slot]
    R_new = S.R @ lie.quat_to_matrix(T_cur[3:7])
    t_new = S.s * (S.R @ T_cur[:3]) + S.t
    T_cur_corr = torch.cat([t_new, lie.matrix_to_quat(R_new)]).to(
        torch.float32)
    sim3 = lie.se3_mul(lie.se3_inv(kf.pose_l[cand_slot]), T_cur_corr)
    trans_l1 = torch.sum(torch.abs(lie.se3_log(sim3)[:3]))
    # one host read decides
    ok_h, scale, tl = torch.stack(
        [ok.to(torch.float32), S.s.to(torch.float32), trans_l1]).tolist()
    if not ok_h:
        return False, None, 0.0
    if not scale > 0 or abs(np.log(scale)) > max_scale_log:
        return False, None, scale  # scale drift in stereo = bad closure
    if not tl <= 5.0:  # same sanity gate as the PnP path (sim3.h:340)
        return False, None, scale
    return True, sim3, scale


def _source_landmarks(kf: KeyframeState, lm: LandmarkState, kf_src_mask):
    """[L] bool: valid landmarks seen by a source keyframe's features."""
    L = lm.pos.shape[0]
    mp = kf.map_points
    src = kf_src_mask[:, None] & (mp >= 0)
    lm_mask = torch.zeros(L, dtype=torch.bool, device=mp.device)
    lm_mask[mp[src].long()] = True
    return lm_mask & lm.valid


def _guided_refine_device(
    kf: KeyframeState,
    lm: LandmarkState,
    cur_slot,            # int: the current keyframe's slot
    kf_src_mask,         # [K] bool: candidate + its covisible neighbours
    T_cur,               # [7] current estimate of the corrected pose
    intr0,
    cam_name: str,
    z_threshold: float = 0.1,
    px_gate: float = 15.0,
    threshold: int = 70,
    ratio: float = 1.2,
    cap: int = 1024,
    gn_iters: int = 8,
):
    """One guided-matching + IRLS-refine round for the loop correction:
    the candidate side's landmarks projected through ``T_cur``, matched
    by descriptor in a 2D radius, and the pose re-optimized on the matches
    (ORB-SLAM's ComputeSim3 rounds). Returns (T_cur_refined [7],
    n_matches)."""
    L = lm.pos.shape[0]
    cur_slot = int(cur_slot)
    lm_mask = _source_landmarks(kf, lm, kf_src_mask)

    p_c = lie.se3_apply(lie.se3_inv(T_cur), lm.pos)
    proj = cam_models.project(cam_name, intr0, p_c)
    ok = lm_mask & (p_c[:, 2] >= z_threshold)
    sel, sel_valid = compact_indices(ok, cap)
    sel = torch.clamp(sel, 0, L - 1)
    sel_valid = sel_valid & ok[sel]

    cur_bits = describe_ops.unpack_bits(kf.desc[cur_slot, 0])
    cur_valid = kf.kp_valid[cur_slot, 0]
    corners = kf.corners[cur_slot, 0]
    m_lm, m_ok, _ = hamming.match_landmarks(
        cur_bits, cur_valid, lm.bank_bits[sel], lm.bank_valid[sel],
        corners, proj[sel], sel_valid, max_dist_2d=px_gate,
        threshold=threshold, ratio=ratio)
    points = lm.pos[sel[torch.clamp(m_lm, min=0)]]          # [N, 3]
    bearings = cam_models.unproject(cam_name, intr0, corners)
    w = m_ok.to(points.dtype)
    T_inv = lie.se3_inv(T_cur)
    T_cw = pnp._gn_refine(lie.quat_to_matrix(lie.se3_q(T_inv)),
                          lie.se3_t(T_inv), points, bearings, w, gn_iters)
    T_ref = lie.se3_inv(T_cw)
    n = m_ok.sum()
    # keep the prior estimate if matching found (almost) nothing
    good = (n >= 10) & torch.all(torch.isfinite(T_ref))
    return torch.where(good, T_ref, T_cur), n


def _verify_loop_device(
    kf: KeyframeState,
    lm: LandmarkState,
    cur_slot,            # int
    kf_src_mask,         # [K] bool: candidate + its covisible neighbours
    T_cur_aligned,       # [7] proposed corrected pose of the current KF
    intr0,
    cam_name: str,
    width: int,
    height: int,
    z_threshold: float = 0.1,
    px_gate: float = 15.0,
    threshold: int = 70,
    ratio: float = 1.2,
    cap: int = 1024,
):
    """Gated descriptor matches of the candidate side's landmarks projected
    through ``T_cur_aligned``. Returns (num_inliers, num_visible);
    num_visible is the smaller of the landmarks in view and the current
    keyframe's valid features (the most a perfect closure could
    explain)."""
    L = lm.pos.shape[0]
    cur_slot = int(cur_slot)
    lm_mask = _source_landmarks(kf, lm, kf_src_mask)

    p_c = lie.se3_apply(lie.se3_inv(T_cur_aligned), lm.pos)
    proj = cam_models.project(cam_name, intr0, p_c)
    ok = (lm_mask
          & (p_c[:, 2] >= z_threshold)
          & (proj[:, 0] >= 0) & (proj[:, 0] <= width)
          & (proj[:, 1] >= 0) & (proj[:, 1] <= height))
    sel, sel_valid = compact_indices(ok, cap)
    sel = torch.clamp(sel, 0, L - 1)
    sel_valid = sel_valid & ok[sel]

    cur_bits = describe_ops.unpack_bits(kf.desc[cur_slot, 0])
    cur_valid = kf.kp_valid[cur_slot, 0]
    corners = kf.corners[cur_slot, 0]
    _, m_ok, _ = hamming.match_landmarks(
        cur_bits, cur_valid, lm.bank_bits[sel], lm.bank_valid[sel],
        corners, proj[sel], sel_valid, max_dist_2d=px_gate,
        threshold=threshold, ratio=ratio)
    n_vis = torch.minimum(sel_valid.sum(), cur_valid.sum())
    return m_ok.sum(), n_vis


def verify_loop(
    kf: KeyframeState,
    lm: LandmarkState,
    cur_slot: int,
    cand_slot: int,
    cand_neighbors: Sequence[int],
    sim3,
    intr0,
    cam_name: str,
    width: int,
    height: int,
    px_gate: float = 15.0,
    threshold: int = 70,
    ratio: float = 1.2,
) -> Tuple[int, int]:
    """Geometric consistency check of a proposed loop closure: the
    candidate side's map points projected through ``T_w_cand * sim3``,
    counted by reprojection-consistent descriptor matches. Returns
    (num_inliers, num_visible); the caller applies the thresholds."""
    kmask = _source_mask(kf, cur_slot, (cand_slot, *cand_neighbors))
    T_aligned = lie.se3_mul(kf.pose_l[cand_slot], sim3)
    n_inl, n_vis = _verify_loop_device(
        kf, lm, cur_slot, kmask, T_aligned, intr0, cam_name=cam_name,
        width=width, height=height, px_gate=px_gate, threshold=threshold,
        ratio=ratio)
    return int(n_inl), int(n_vis)


def _apply_poses(kf: KeyframeState, lm: LandmarkState, new_left, T_0_1):
    """Write optimized left poses; re-derive right cameras and landmarks."""
    v = kf.valid[:, None]
    pose_l = torch.where(v, new_left, kf.pose_l)
    pose_r = torch.where(v, lie.se3_mul(pose_l, T_0_1.expand_as(pose_l)),
                         kf.pose_r)
    kf = kf.replace(pose_l=pose_l, pose_r=pose_r)
    anchor = torch.clamp(lm.from_kf, min=0).long()
    p = lie.se3_apply(pose_l[anchor], lm.pos_c)
    lm = lm.replace(pos=torch.where(lm.valid[:, None], p, lm.pos))
    return kf, lm


def loop_closure(
    kf: KeyframeState,
    lm: LandmarkState,
    cur_slot: int,
    cand_slot: int,
    sim3,
    covis: Dict[int, Dict[int, int]],
    T_0_1,
    essential_threshold: int = 30,
    fixed_current: bool = True,
    huber: float = 1.0,
    max_iters: int = 20,
    live_slots=None,
):
    """Rigid live-side correction + pose graph + landmark update. Returns
    (kf, lm, stats).

    1. The live group (``cur_slot``, its covisible neighbours and
       ``live_slots``, minus the candidate and its neighbours) moves
       rigidly by T_corr = (T_w_cand * sim3) * T_w_cur^-1: the old map is
       the datum, the live drift the error.
    2. The essential pose graph (spanning tree, covisibility edges above
       ``essential_threshold``, the loop edge), measured from the
       pre-correction poses, with the live group and the candidate fixed,
       bends the keyframes between the two anchors.
    3. Right cameras and landmarks follow the left poses.
    """
    t_stats = {}
    t0 = time.perf_counter()
    n_kf = int(kf.next_slot)
    poses_pre = kf.pose_l
    dev = poses_pre.device
    t_stats["t_snapshot_s"] = time.perf_counter() - t0

    # ---- rigid live-side alignment ----
    t0 = time.perf_counter()
    group = {int(cur_slot)}
    group.update(int(s) for s in covis.get(cur_slot, {}))
    if live_slots is not None:
        group.update(int(s) for s in live_slots)
    group.discard(int(cand_slot))
    group.difference_update(int(s) for s in covis.get(cand_slot, {}))
    group = sorted(s for s in group if 0 <= s < n_kf)
    sim3 = torch.as_tensor(sim3, dtype=poses_pre.dtype, device=dev)
    pose_l, pose_r, _T_corr = _rigid_align_device(
        kf.pose_l, kf.pose_r,
        torch.as_tensor(group, dtype=torch.long, device=dev),
        kf.pose_l[cand_slot], sim3, poses_pre[cur_slot], T_0_1)
    kf = kf.replace(pose_l=pose_l, pose_r=pose_r)
    t_stats["t_align_s"] = time.perf_counter() - t0

    # ---- the essential graph (all measurements pre-align) ----
    t0 = time.perf_counter()
    parent = kf.parent.cpu().numpy()
    edges_i, edges_j = [], []
    for i in range(n_kf):
        p = int(parent[i])
        if p < 0:
            continue
        if covis.get(i, {}).get(p, 0) > essential_threshold:
            continue  # covered by the essential edge below
        edges_i.append(i)
        edges_j.append(p)
    for i in range(n_kf):
        for j, w in covis.get(i, {}).items():
            if w > essential_threshold and i < j < n_kf:
                edges_i.append(i)
                edges_j.append(j)
    # the loop edge, log(sim3^-1) between current and candidate (last row)
    edges_i.append(int(cur_slot))
    edges_j.append(int(cand_slot))
    E = len(edges_i)
    ei = torch.as_tensor(edges_i, device=dev)
    ej = torch.as_tensor(edges_j, device=dev)
    meas = _edge_measurements(poses_pre, ei, ej, sim3, E - 1)
    # anchors: the (corrected) live group and the candidate; the chain
    # between them absorbs the disagreement. The reference pads the
    # keyframe axis to a power of two with fixed identity rows (an XLA
    # shape bucket); they are decoupled from the system, so the port
    # solves over the n_kf keyframes
    fixed = np.zeros(n_kf, bool)
    fixed[cand_slot] = True
    fixed[group] = True
    if not fixed_current:
        fixed[cur_slot] = False
    prob = pose_graph.PoseGraphProblem(
        poses=kf.pose_l[:n_kf],
        fixed=torch.as_tensor(fixed, device=dev),
        edge_i=ei, edge_j=ej, edge_meas=meas,
        edge_valid=torch.ones(E, dtype=torch.bool, device=dev))
    t_stats["t_graph_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if _pow2(n_kf) <= POSE_GRAPH_DENSE_MAX:
        opt_poses, stats = pose_graph.solve_pose_graph(
            prob, huber=huber, max_iters=max_iters)
    else:
        # the dense (6K)^2 assembly stops scaling; matrix-free CG is O(K+E)
        opt_poses, stats = pose_graph_cg.solve_pose_graph_cg(
            prob, huber=huber, max_iters=max_iters)
    t_stats["t_solve_s"] = time.perf_counter() - t0

    # scatter back + stereo + landmark updates (rows >= n_kf keep theirs)
    t0 = time.perf_counter()
    new_left = kf.pose_l.clone()
    new_left[:n_kf] = opt_poses
    kf, lm = _apply_poses(kf, lm, new_left, T_0_1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_stats["t_apply_s"] = time.perf_counter() - t0
    stats = dict(stats, **{k: round(v, 3) for k, v in t_stats.items()})
    return kf, lm, stats
