"""Global bundle adjustment over all keyframes and lifetime observations.

Port of ``vslam_tpu/pipeline/ba_global.py``: the analogue of the
reference's ``global_bundle_adjustment`` + ``global_ba`` driver
(loop_closure_utils.h:672-748, slam.cpp:1741-1789). Every valid keyframe
(both cameras), every landmark, the lifetime ``all_*`` observation tables,
intrinsics frozen, the first keyframe pair fixed.

The problem keeps the reference's shape buckets: K2 = the keyframe count
rounded up to a power of two (at least 16) and Lw = the landmark count
rounded up to a power of two (at least 256); rows past the live ones are
fixed or invalid. The blocked Schur solver (``solvers/ba_blocked.py``)
serves K2 <= ``BLOCKED_MAX_PAIRS``, which is every problem of a map of at
most 128 keyframes; larger maps take the flat observation list of
``_build`` (capped at O observations, lowest landmark rows first) and the
matrix-free ``solvers/ba_cg.py``. A sharded solve over a device mesh
(``parallel/sharded_ba``) is not ported: it raises.

Asynchronous GBA. The reference dispatches the solve on a snapshot, keeps
tracking and skip-merges later (slam.cpp:1778-1788, :1410-1447); with its
default ``deterministic_async`` the merge lands at the first poll after
the dispatch. The port solves at dispatch, on the current stream, and
keeps the reference's snapshot masks and skip rule for that merge.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.state import KeyframeState, LandmarkState, TensorState
from ..geometry import lie
from ..ops.compact import compact_indices
from ..solvers import ba_blocked, ba_cg
from ..solvers.ba import BAProblem

# above this many keyframe pairs the dense 6K x 6K reduced camera system of
# the blocked solver gives way to matrix-free LM-CG
BLOCKED_MAX_PAIRS = 128


def _pow2(n: int, lo: int = 16) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _unported(what: str):
    raise NotImplementedError(
        f"{what}: the global BA sharded over a device mesh "
        "(parallel/sharded_ba.py, parallel/mesh.py) is not ported yet; see "
        "ROADMAP.md Queue 1")


def gba_mesh(cfg):
    """The reference's device mesh for a sharded global BA
    (``SlamConfig.gba_mesh_devices``): None when sharding is off; asking
    for it raises (not ported)."""
    n = int(getattr(cfg, "gba_mesh_devices", 0) or 0)
    if n > 1:
        _unported(f"gba_mesh_devices={n}")
    return None


def _problem_size(kf: KeyframeState, lm: LandmarkState, mesh):
    n_kf = int(kf.next_slot)
    n_lm = int(lm.next_slot)
    K2 = _pow2(n_kf)
    Lw = _pow2(n_lm, lo=256)
    if mesh is not None:
        _unported("a sharded global BA")
    return n_kf, n_lm, K2, Lw


def _cameras(kf: KeyframeState, intr0, intr1, K2: int):
    """(poses [2*K2, 7], fixed [2*K2], intr [2*K2, 8]) of the K2 keyframe
    pairs; the first pair (the gauge, slam.cpp:1781) and rows past the live
    keyframes are fixed."""
    K = kf.frame_id.shape[0]
    dtype = kf.pose_l.dtype
    kf_ids = torch.arange(K2, device=kf.pose_l.device)
    sel_kf = torch.clamp(kf_ids, 0, K - 1)
    kf_ok = (kf_ids < kf.next_slot) & kf.valid[sel_kf]
    poses = torch.stack([kf.pose_l[sel_kf], kf.pose_r[sel_kf]],
                        1).reshape(2 * K2, 7)
    fixed = (~kf_ok | (kf_ids == 0)).repeat_interleave(2)
    intr = torch.stack([intr0.expand(K2, 8), intr1.expand(K2, 8)],
                       1).reshape(2 * K2, 8).to(dtype)
    return poses, fixed, intr


def _build(kf: KeyframeState, lm: LandmarkState, intr0, intr1, K2: int,
           Lw: int, O: int) -> BAProblem:
    """Global problem as a flat list of at most O observations (the first O
    valid entries of the [Lw, M2] lifetime tables in row order)."""
    K = kf.frame_id.shape[0]
    dev = kf.pose_l.device
    dtype = kf.pose_l.dtype
    poses, fixed, intr = _cameras(kf, intr0, intr1, K2)

    L = lm.pos.shape[0]
    lm_ids = torch.arange(Lw, device=dev)
    sel_lm = torch.clamp(lm_ids, 0, L - 1)
    lm_ok = (lm_ids < lm.next_slot) & lm.valid[sel_lm]

    M2 = lm.all_kf.shape[1]
    okf = lm.all_kf[sel_lm].long()         # [Lw, M2]
    ocam = lm.all_cam[sel_lm].long()
    ofeat = lm.all_feat[sel_lm].long()
    ovalid = (okf >= 0) & (okf < K2) & lm_ok[:, None]
    opoint = lm_ids[:, None].expand(Lw, M2)

    flat_valid = ovalid.reshape(-1)
    oidx, o_sel_ok = compact_indices(flat_valid, O)
    oidx = torch.clamp(oidx, 0, flat_valid.shape[0] - 1).long()
    o_valid = flat_valid[oidx] & o_sel_ok
    o_kf = torch.clamp(okf.reshape(-1)[oidx], min=0)
    o_cam = ocam.reshape(-1)[oidx]
    o_feat = ofeat.reshape(-1)[oidx]
    o_point = opoint.reshape(-1)[oidx]
    o_w = torch.where(o_valid, 2 * o_kf + o_cam, torch.zeros_like(o_kf))
    o_uv = kf.corners[torch.clamp(o_kf, max=K - 1), o_cam, o_feat]
    return BAProblem(
        poses=poses, pose_fixed=fixed, intr=intr,
        points=lm.pos[sel_lm], point_valid=lm_ok,
        obs_cam=o_w.to(torch.int32), obs_point=o_point.to(torch.int32),
        obs_uv=o_uv.to(dtype), obs_valid=o_valid)


def _solve(kf: KeyframeState, lm: LandmarkState, intr0, intr1, n_lm: int,
           K2: int, Lw: int, cam_name: str, huber, max_iters: int,
           cg_iters: int):
    """Build and solve: blocked Schur up to BLOCKED_MAX_PAIRS keyframe
    pairs, matrix-free LM-CG above. Returns (poses, points, stats)."""
    if K2 <= BLOCKED_MAX_PAIRS:
        prob = _build_blocked(kf, lm, intr0, intr1, K2=K2, Lw=Lw)
        return ba_blocked.solve_ba_blocked(
            prob, cam_name=cam_name, huber=huber, max_iters=max_iters)
    M2 = int(lm.all_kf.shape[1])
    O = _pow2(min(n_lm * 6, Lw * M2), lo=1024)
    prob = _build(kf, lm, intr0, intr1, K2=K2, Lw=Lw, O=O)
    return ba_cg.solve_ba_cg_stepped(
        prob, cam_name=cam_name, huber=huber, max_iters=max_iters,
        cg_iters=cg_iters)


def _build_blocked(kf: KeyframeState, lm: LandmarkState, intr0, intr1,
                   K2: int, Lw: int) -> ba_blocked.BlockProblem:
    """Global problem in the blocked [Lw, M2] layout: the lifetime obs
    tables map straight through, no observation cap."""
    K = kf.frame_id.shape[0]
    dev = kf.pose_l.device
    dtype = kf.pose_l.dtype
    poses, fixed, intr = _cameras(kf, intr0, intr1, K2)

    L = lm.pos.shape[0]
    lm_ids = torch.arange(Lw, device=dev)
    sel_lm = torch.clamp(lm_ids, 0, L - 1)
    lm_ok = (lm_ids < lm.next_slot) & lm.valid[sel_lm]

    okf = lm.all_kf[sel_lm].long()        # [Lw, M2]
    ocam = lm.all_cam[sel_lm].long()
    ofeat = lm.all_feat[sel_lm].long()
    ovalid = (okf >= 0) & (okf < K2) & lm_ok[:, None]
    okf0 = torch.clamp(okf, min=0)
    obs_cam = 2 * okf0 + ocam
    obs_uv = kf.corners[torch.clamp(okf0, max=K - 1), ocam, ofeat]
    return ba_blocked.BlockProblem(
        poses=poses, pose_fixed=fixed, intr=intr,
        points=lm.pos[sel_lm], point_valid=lm_ok,
        obs_cam=obs_cam.to(torch.int32), obs_uv=obs_uv.to(dtype),
        obs_valid=ovalid)


def _scatter_rows(table, rows_ok, values):
    """table[i] = values[i] for the i < len(values) where rows_ok[i]."""
    idx = torch.nonzero(rows_ok).squeeze(1)
    table = table.clone()
    table[idx] = values[idx]
    return table


def _refresh_pos_c(kf: KeyframeState, lm: LandmarkState) -> LandmarkState:
    anchor = torch.clamp(lm.from_kf, min=0).long()
    p_c = lie.se3_apply(lie.se3_inv(kf.pose_l[anchor]), lm.pos)
    return lm.replace(pos_c=torch.where(lm.valid[:, None], p_c, lm.pos_c))


def _merge(kf: KeyframeState, lm: LandmarkState, poses, points, kf_keep,
           lm_keep):
    """Write the solved rows selected by kf_keep [K2] / lm_keep [Lw] and
    refresh every valid landmark's anchor-frame position."""
    K, L = kf.pose_l.shape[0], lm.pos.shape[0]
    K2, Lw = poses.shape[0] // 2, points.shape[0]
    pl = poses.reshape(K2, 2, 7)
    k_ok = kf_keep[:min(K2, K)]
    kf = kf.replace(pose_l=_scatter_rows(kf.pose_l, k_ok, pl[:K, 0]),
                    pose_r=_scatter_rows(kf.pose_r, k_ok, pl[:K, 1]))
    lm = lm.replace(pos=_scatter_rows(lm.pos, lm_keep[:min(Lw, L)],
                                      points[:L]))
    return kf, _refresh_pos_c(kf, lm)


def _live(kf: KeyframeState, lm: LandmarkState, K2: int, Lw: int, n_kf,
          n_lm):
    """(kf rows < n_kf and valid [K2], landmark rows < n_lm and valid
    [Lw]), rows past the state's capacity reading the last row."""
    K, L = kf.pose_l.shape[0], lm.pos.shape[0]
    ids = torch.arange(K2, device=kf.pose_l.device)
    sel = torch.clamp(ids, 0, K - 1)
    lids = torch.arange(Lw, device=lm.pos.device)
    lsel = torch.clamp(lids, 0, L - 1)
    return ((ids < n_kf) & kf.valid[sel], (lids < n_lm) & lm.valid[lsel],
            sel, lsel)


def run_global_ba(kf: KeyframeState, lm: LandmarkState, intr0, intr1,
                  cam_name: str = "ds", huber: float = 1.0,
                  max_iters: int = 15, cg_iters: int = 25, mesh=None):
    """Build + solve + merge. Returns (kf, lm, stats). ``cg_iters`` is the
    CG solver's inner iteration count (maps above BLOCKED_MAX_PAIRS)."""
    n_kf, n_lm, K2, Lw = _problem_size(kf, lm, mesh)
    poses, points, stats = _solve(kf, lm, intr0, intr1, n_lm, K2, Lw,
                                  cam_name, huber, max_iters, cg_iters)
    kf_ok, lm_ok, _, _ = _live(kf, lm, K2, Lw, n_kf, n_lm)
    kf, lm = _merge(kf, lm, poses, points, kf_ok, lm_ok)
    return kf, lm, stats


@dataclasses.dataclass
class PendingGBA(TensorState):
    """A global BA solved on a snapshot, waiting for its skip-merge.

    The snapshot masks record which slots were active (in the BA window)
    at dispatch so the merge can skip entries modified since
    (slam.cpp:1416-1447)."""

    poses: torch.Tensor           # [2*K2, 7]
    points: torch.Tensor          # [Lw, 3]
    n_kf: int                     # snapshot keyframe cursor
    n_lm: int                     # snapshot landmark cursor
    snap_active_kf: torch.Tensor  # [K] bool active at dispatch
    snap_active_lm: torch.Tensor  # [L] bool
    stats: dict = None            # the solver's stats


def dispatch_global_ba(kf: KeyframeState, lm: LandmarkState, intr0, intr1,
                       cam_name: str = "ds", huber: float = 1.0,
                       max_iters: int = 15, cg_iters: int = 25,
                       mesh=None) -> PendingGBA:
    """Snapshot the map and solve its global BA (see the module doc for
    why the solve runs here); merge later with ``merge_global_ba``."""
    n_kf, n_lm, K2, Lw = _problem_size(kf, lm, mesh)
    snap_kf = kf.active.clone()
    snap_lm = lm.active.clone()
    poses, points, stats = _solve(kf, lm, intr0, intr1, n_lm, K2, Lw,
                                  cam_name, huber, max_iters, cg_iters)
    return PendingGBA(poses=poses, points=points, n_kf=n_kf, n_lm=n_lm,
                      snap_active_kf=snap_kf, snap_active_lm=snap_lm,
                      stats=stats)


def merge_global_ba(kf: KeyframeState, lm: LandmarkState,
                    pending: PendingGBA):
    """Skip-merge: apply the GBA results to every snapshot entry NOT
    modified since the dispatch.

    "Modified" = active at dispatch or at merge (the window BA touches
    active entries every keyframe); entries created after the snapshot
    fall outside the ``n_kf``/``n_lm`` bounds. Anchor-relative landmark
    positions are refreshed for every valid landmark."""
    K2 = pending.poses.shape[0] // 2
    Lw = pending.points.shape[0]
    kf_ok, lm_ok, sel, lsel = _live(kf, lm, K2, Lw, pending.n_kf,
                                    pending.n_lm)
    kf_mod = pending.snap_active_kf[sel] | kf.active[sel]
    lm_mod = pending.snap_active_lm[lsel] | lm.active[lsel]
    return _merge(kf, lm, pending.poses, pending.points, kf_ok & ~kf_mod,
                  lm_ok & ~lm_mod)
