"""Keyframe insertion: stereo matching, triangulation, map growth.

Port of ``vslam_tpu/pipeline/keyframe.py``: stereo matching with the
essential-matrix epipolar filter, ``insert_keyframe`` (observations of
tracked inliers, triangulation of new landmarks into free slots,
per-feature landmark ids, covisibility counts), window deactivation and
landmark culling.

Masked writes. The reference drops masked scatter entries by pointing them
out of bounds (``mode="drop"``); on CUDA an out-of-range index is a
device-side assert, so the port selects the unmasked entries first and
writes only those. The rows written in one call are distinct: the
canonical-feature dedupe keeps one feature per landmark and new landmarks
take distinct free slots, so no index_put_ sees a duplicate index. These
functions update the state tensors they are given in place and return the
updated state.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import KeyframeState, LandmarkState
from ..frontend.features import Features
from ..geometry import cameras as cam_models
from ..geometry import lie
from ..geometry.triangulate import triangulate_midpoint
from ..ops import compact
from ..ops import describe as describe_ops
from ..ops import hamming


def essential_from_pose(T_0_1):
    """E = skew(normalize(t)) @ R."""
    t = lie.se3_t(T_0_1)
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    R = lie.quat_to_matrix(lie.se3_q(T_0_1))
    return lie.hat(t) @ R


def stereo_match(feats_l: Features, feats_r: Features, T_0_1, intr0, intr1,
                 cam_name: str = "ds", threshold=70, ratio=1.2,
                 epipolar_threshold=1e-3):
    """Mutual descriptor matches + epipolar filter.

    Returns (match_r [N] int64 right index or -1, inlier [N] bool).
    """
    mj, acc = hamming.match_descriptors(
        feats_l.bits, feats_r.bits, feats_l.valid, feats_r.valid,
        threshold=threshold, ratio=ratio)
    E = essential_from_pose(T_0_1)
    f0 = cam_models.unproject(cam_name, intr0, feats_l.corners)      # [N, 3]
    f1 = cam_models.unproject(cam_name, intr1, feats_r.corners)      # [N, 3]
    f1m = f1[torch.clamp(mj, min=0)]
    err = torch.abs(torch.einsum("ni,ij,nj->n", f0, E, f1m))
    inlier = acc & (err <= epipolar_threshold)
    return torch.where(inlier, mj, torch.full_like(mj, -1)), inlier


def _scatter_obs(kf_tab, cam_tab, feat_tab, rows, kf_val, cam_val, feat_val,
                 mask):
    """Append one observation per masked row at its first free slot, in
    place. Rows whose table is full are skipped (the reference drops them
    too). ``rows`` must be distinct where ``mask`` holds."""
    row_tab = kf_tab[torch.clamp(rows, min=0)]
    empty = row_tab < 0
    free = torch.argmax(empty.to(torch.uint8), dim=-1)   # first free slot
    sel = torch.nonzero(mask & empty.any(dim=-1)).squeeze(1)
    r, c = rows[sel], free[sel]

    def put(tab, val):
        val = val[sel] if torch.is_tensor(val) and val.dim() else val
        tab[r, c] = torch.as_tensor(val, dtype=tab.dtype, device=tab.device)

    put(kf_tab, kf_val)
    put(cam_tab, cam_val)
    put(feat_tab, feat_val)


def _bank_add(lm: LandmarkState, rows, bits, mask):
    """Round-robin insert descriptors into the banks of the masked rows,
    in place."""
    B = lm.bank_bits.shape[1]
    sel = torch.nonzero(mask).squeeze(1)
    r = rows[sel]
    cursor = (lm.bank_next[r] % B).to(torch.int64)
    lm.bank_bits[r, cursor] = bits[sel]
    lm.bank_valid[r, cursor] = True
    lm.bank_next[r] += 1


def _obs_both(lm: LandmarkState, rows, kf_val, cam_val, feat_val, mask):
    """The same observation into the windowed and the lifetime tables."""
    _scatter_obs(lm.obs_kf, lm.obs_cam, lm.obs_feat, rows, kf_val, cam_val,
                 feat_val, mask)
    _scatter_obs(lm.all_kf, lm.all_cam, lm.all_feat, rows, kf_val, cam_val,
                 feat_val, mask)


@dataclasses.dataclass
class KeyframeResult:
    kf: KeyframeState
    lm: LandmarkState
    slot: torch.Tensor          # [] int32 new KF slot
    covis_weight: torch.Tensor  # [K] int32 shared-landmark counts
    num_new: torch.Tensor       # [] int64 triangulated landmarks


def insert_keyframe(kf: KeyframeState, lm: LandmarkState, frame_id,
                    parent_slot, T_w_c, T_0_1, feats_l: Features,
                    feats_r: Features, stereo_j, stereo_inlier, match_lm,
                    lm_inlier, intr0, intr1, cam_name: str = "ds",
                    suppress_new=None) -> KeyframeResult:
    """Insert a keyframe into the state (in place).

    ``suppress_new`` [N] bool: do not triangulate these features
    (duplicate-landmark suppression). A full keyframe capacity makes the
    insert a no-op on the keyframe record (the reference's dropped writes).
    """
    N = feats_l.corners.shape[0]
    Lmax = lm.pos.shape[0]
    Kcap = kf.frame_id.shape[0]
    dev = kf.frame_id.device
    match_lm, stereo_j = match_lm.long(), stereo_j.long()
    slot = kf.next_slot.clone()                       # [] int32
    in_cap = slot < Kcap
    s = torch.clamp(slot, max=Kcap - 1).to(torch.int64)

    # ---------------- write keyframe record ----------------
    if bool(in_cap):
        kf.frame_id[s] = torch.as_tensor(frame_id, dtype=torch.int32)
        kf.pose_l[s] = T_w_c
        kf.pose_r[s] = lie.se3_mul(T_w_c, T_0_1)
        kf.valid[s] = True
        kf.active[s] = True
        kf.parent[s] = torch.as_tensor(parent_slot, dtype=torch.int32)
        kf.corners[s] = torch.stack([feats_l.corners, feats_r.corners])
        kf.desc[s] = torch.stack([describe_ops.pack_bits(feats_l.bits),
                                  describe_ops.pack_bits(feats_r.bits)])
        kf.kp_valid[s] = torch.stack([feats_l.valid, feats_r.valid])
    kf.next_slot += 1

    # ------------- attach observations of tracked inliers -------------
    # dedupe: ONE canonical feature per landmark (the lowest-index match),
    # used by every consumer (obs tables, bank, map_points, covisibility)
    feat_ids = torch.arange(N, device=dev)
    matched = lm_inlier & (match_lm >= 0)
    first_feat = torch.full((Lmax + 1,), N, dtype=torch.int64, device=dev)
    first_feat.scatter_reduce_(
        0, torch.where(matched, match_lm, torch.full_like(match_lm, Lmax)),
        feat_ids, reduce="amin")
    tracked = matched & (feat_ids == first_feat[torch.clamp(match_lm,
                                                            min=0)])
    rows = torch.where(tracked, match_lm, torch.zeros_like(match_lm))
    slot_val = slot.to(torch.int32)

    _obs_both(lm, rows, slot_val, 0, feat_ids, tracked)
    _bank_add(lm, rows, feats_l.bits, tracked)

    # right-cam observation when the left feature also stereo-matched
    tracked_r = tracked & stereo_inlier & (stereo_j >= 0)
    sj = torch.clamp(stereo_j, min=0)
    _obs_both(lm, rows, slot_val, 1, sj, tracked_r)
    _bank_add(lm, rows, feats_r.bits[sj], tracked_r)
    lm.active[rows[tracked]] = True

    # ------------------- triangulate new landmarks -------------------
    is_new = stereo_inlier & (stereo_j >= 0) & ~tracked & feats_l.valid
    if suppress_new is not None:
        is_new = is_new & ~suppress_new
    f0 = cam_models.unproject(cam_name, intr0, feats_l.corners)
    f1 = cam_models.unproject(cam_name, intr1, feats_r.corners[sj])
    p_c, tri_ok = triangulate_midpoint(f0, f1, T_0_1)
    # triangulation validity folds in BEFORE slot assignment so degenerate
    # stereo pairs never consume landmark capacity
    is_new = is_new & tri_ok
    # free-list allocation: new landmarks take the lowest ~valid slots
    free_idx, free_ok = compact.compact_indices(~lm.valid, N)
    rank_c = torch.clamp(torch.cumsum(is_new.to(torch.int64), 0) - 1, 0,
                         N - 1)
    m = is_new & free_ok[rank_c]
    new_slots = torch.where(m, free_idx[rank_c],
                            torch.full_like(rank_c, Lmax))
    nrows = torch.where(m, new_slots, torch.zeros_like(new_slots))
    p_w = lie.se3_apply(T_w_c, p_c)

    tgt = nrows[m]
    lm.pos[tgt] = p_w[m]
    lm.pos_c[tgt] = p_c[m]
    lm.from_kf[tgt] = slot_val
    lm.valid[tgt] = True
    lm.active[tgt] = True
    _obs_both(lm, nrows, slot_val, 0, feat_ids, m)
    _obs_both(lm, nrows, slot_val, 1, sj, m)
    _bank_add(lm, nrows, feats_l.bits, m)
    _bank_add(lm, nrows, feats_r.bits[sj], m)
    num_new = m.sum()
    # next_slot is the allocation high-water mark
    hw = torch.max(torch.where(m, new_slots, torch.full_like(new_slots, -1)))
    lm.next_slot = torch.maximum(lm.next_slot, (hw + 1).to(torch.int32))

    # ------------------- per-feature landmark ids -------------------
    mp = torch.full((N,), -1, dtype=torch.int64, device=dev)
    mp = torch.where(tracked, match_lm, mp)
    mp = torch.where(m, new_slots, mp).to(torch.int32)
    if bool(in_cap):
        kf.map_points[s] = mp

    # ------------------- covisibility counting -------------------
    # landmarks of this KF: their all_obs entries at left cams of other KFs
    lm_ids = torch.clamp(mp, min=0).to(torch.int64)
    akf = lm.all_kf[lm_ids]        # [N, M2]
    acam = lm.all_cam[lm_ids]
    # an observation recorded at a full keyframe capacity carries slot
    # Kcap; the reference's segment_sum drops it, so it counts nowhere
    in_range = (akf >= 0) & (akf < Kcap)
    contrib = in_range & (acam == 0) & (akf != slot) & (mp >= 0)[:, None]
    covis = torch.zeros(Kcap, dtype=torch.int32, device=dev)
    covis.index_add_(0, torch.where(in_range, akf, 0).reshape(-1).long(),
                     contrib.reshape(-1).to(torch.int32))
    return KeyframeResult(kf=kf, lm=lm, slot=slot, covis_weight=covis,
                          num_new=num_new)


def deactivate_keyframes(kf: KeyframeState, lm: LandmarkState, deact_mask,
                         max_evict: int = 16):
    """remove_old_keyframes device part: deactivate the masked keyframes,
    strip their windowed observations, and (de)activate landmarks by
    whether windowed observations remain.

    ``max_evict`` bounds how many keyframes leave per call (the reference
    strips the ``max_evict`` highest evicted slots); ``max_evict >= K``
    strips all.
    """
    K = deact_mask.shape[0]
    kf = kf.replace(active=kf.active & ~deact_mask)
    if max_evict < K:
        ids = compact.top_k(torch.where(
            deact_mask, torch.arange(K, device=deact_mask.device),
            torch.full((K,), -1, device=deact_mask.device)), max_evict)[0]
        strip = torch.zeros(K + 1, dtype=torch.bool, device=deact_mask.device)
        strip[torch.where(ids >= 0, ids, torch.full_like(ids, K))] = True
        deact_mask = strip[:K]
    obs_gone = (lm.obs_kf >= 0) & deact_mask[torch.clamp(lm.obs_kf, min=0)
                                             .to(torch.int64)]
    obs_kf = torch.where(obs_gone, torch.full_like(lm.obs_kf, -1), lm.obs_kf)
    has_obs = torch.any(obs_kf >= 0, dim=-1)
    lm = lm.replace(obs_kf=obs_kf, active=lm.valid & has_obs)
    return kf, lm


def cull_landmarks(kf: KeyframeState, lm: LandmarkState,
                   min_lifetime_obs: int = 3, max_cull: int = 4096):
    """Free the slots of weakly-observed dead landmarks (valid, out of the
    BA window, fewer than ``min_lifetime_obs`` lifetime left-camera
    observations), at most ``max_cull`` per call, and clear every keyframe
    map_points cell that referenced them (through their lifetime-obs
    tables). Returns (kf, lm, num_culled)."""
    nobs = torch.sum((lm.all_kf >= 0) & (lm.all_cam == 0), dim=-1)
    want_dead = lm.valid & ~lm.active & (nobs < min_lifetime_obs)
    dead_ids, dead_ok = compact.compact_indices(want_dead, max_cull)
    L = lm.pos.shape[0]
    rows = torch.clamp(dead_ids, 0, L - 1)
    dead = torch.zeros(L, dtype=torch.bool, device=want_dead.device)
    dead[dead_ids[dead_ok]] = True
    akf = lm.all_kf[rows]                       # [C, M2]
    acam = lm.all_cam[rows]
    afeat = lm.all_feat[rows]
    K = kf.frame_id.shape[0]
    wr = dead_ok[:, None] & (akf >= 0) & (akf < K) & (acam == 0)
    mp = kf.map_points.clone()
    mp[akf[wr].to(torch.int64), afeat[wr].to(torch.int64)] = -1
    kf = kf.replace(map_points=mp)
    lm = lm.replace(
        valid=lm.valid & ~dead,
        active=lm.active & ~dead,
        from_kf=torch.where(dead, torch.full_like(lm.from_kf, -1),
                            lm.from_kf),
        obs_kf=torch.where(dead[:, None], torch.full_like(lm.obs_kf, -1),
                           lm.obs_kf),
        all_kf=torch.where(dead[:, None], torch.full_like(lm.all_kf, -1),
                           lm.all_kf),
        bank_valid=lm.bank_valid & ~dead[:, None],
        bank_next=torch.where(dead, torch.zeros_like(lm.bank_next),
                              lm.bank_next),
    )
    return kf, lm, dead.sum()
