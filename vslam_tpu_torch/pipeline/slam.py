"""SlamSystem: the per-frame state machine (host orchestration).

Port of ``vslam_tpu/pipeline/slam.py``, the rewrite of the reference's
``next_step`` driver (slam.cpp:1087-1458). Device work is a handful of
fixed-shape functions (``tracking.track_frame``, ``keyframe.stereo_match``,
``keyframe.insert_keyframe``, the window BA); the host owns the control
flow that is genuinely data-dependent: keyframe decisions, the motion-gate
retry loop (tracking.h:87-159), window eviction order and, when enabled,
loop closure / relocalization orchestration.

Keyframe policy (slam.cpp:1374-1377): a new keyframe is taken when the
localization inlier count drops below ``new_kf_min_inliers``.

Where the port differs from the reference, by construction:

- it runs on one explicit device, the card unless the caller asks for
  another (``device="cpu"``), and raises where there is no card;
- RANSAC draws (tracking, retries, closure, relocalization) come from one
  ``torch.Generator`` seeded with ``cfg.seed``;
- the background window BA and the global BA are solved where the
  reference enqueues them (there are no lazy arrays), held, and merged at
  the start of the next ``process_frame``: the reference's
  ``deterministic_async`` schedule, whatever that flag says;
- the per-frame scalars come to the host in one read per step.

Not ported (each raises and names ROADMAP.md): ``ba_optimize_intrinsics``,
``ba_device`` and a sharded global BA (``gba_mesh_devices > 1``); the
overlay and reprojection-report hooks are absent.
"""

from __future__ import annotations

import math
import sys
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import SlamConfig
from ..core import state as state_mod
from ..frontend.features import extract_features
from ..geometry import lie
from ..io.calib import Calibration
from ..loop import closure as closure_mod
from ..loop import relocalize as reloc_mod
from ..loop import vocabulary as vocab_mod
from ..loop.detector import LoopDetector
from ..ops import describe as describe_ops
from ..solvers import ba as ba_mod
from ..utils.debug import assert_finite_state
from ..utils.metrics import StageTimer
from . import ba_global, ba_window, keyframe as kf_mod, tracking

# SlamConfig fields that size the state's buffers: fixed at construction
CAPACITY_FIELDS = ("num_features", "max_landmarks", "max_keyframes",
                   "lm_desc_bank")


def _check_ported(cfg: SlamConfig):
    if cfg.ba_optimize_intrinsics:
        raise NotImplementedError(
            "ba_optimize_intrinsics: the window BA with free intrinsics "
            "(solve_ba_schur_intrinsics) is not ported yet; see ROADMAP.md "
            "Queue 1")
    if cfg.ba_device is not None:
        raise NotImplementedError(
            "ba_device: the window BA on a second device is not ported yet; "
            "see ROADMAP.md Queue 1")
    ba_global.gba_mesh(cfg)   # raises for a sharded global BA


class SlamSystem:
    def __init__(self, calib: Calibration, config: Optional[SlamConfig] = None,
                 feature_fn=None, device="cuda"):
        self.cfg = config or SlamConfig()
        cfg = self.cfg
        _check_ported(cfg)
        self.device = resolve_device(device)
        dev = self.device
        # optional learned frontend: (img [H, W] uint8 tensor) -> Features
        # with cfg.num_features slots
        self.feature_fn = feature_fn
        self.calib = calib
        self.cam_name = calib.cam_types[0]
        self.width, self.height = calib.width, calib.height

        f32 = dict(dtype=torch.float32, device=dev)
        self.intr0 = torch.as_tensor(np.asarray(calib.intrinsics[0]), **f32)
        self.intr1 = torch.as_tensor(np.asarray(calib.intrinsics[1]), **f32)
        T_i_c0 = torch.as_tensor(np.asarray(calib.T_i_c[0]), **f32)
        T_i_c1 = torch.as_tensor(np.asarray(calib.T_i_c[1]), **f32)
        self.T_0_1 = lie.se3_mul(lie.se3_inv(T_i_c0), T_i_c1)

        self.lm = state_mod.init_landmarks(cfg.max_landmarks,
                                           B=cfg.lm_desc_bank, device=dev)
        self.kf = state_mod.init_keyframes(cfg.max_keyframes,
                                           cfg.num_features, device=dev)
        self.track = state_mod.init_track(device=dev)

        self.pnp_threshold = 1.0 - math.cos(
            math.atan(cfg.pnp_inlier_thresh_px / 500.0))

        # host bookkeeping
        self.frame = 0
        self.take_keyframe = True
        self.last_kf_slot = -1
        self.kf_window: List[int] = []  # frame ids currently active (pairs)
        self.slot_of_frame = {}
        self.covis: dict = {}           # slot -> {slot: weight}
        self.trajectory: List[np.ndarray] = []  # per-frame T_w_c (left)
        self.stats: List[dict] = []
        self.tracking_ok = False
        self._lost_count = 0            # consecutive lost frames (scales
        # the relocalization motion gate; 0 while tracking is healthy)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(cfg.seed)

        self.timer = StageTimer()

        # windowed BA (the reference's background optimize() thread,
        # slam.cpp:1555-1565): solved at the keyframe step, merged at the
        # start of the next frame; new keyframes are gated on the merge like
        # the reference's !opt_running && !opt_finished check
        self._pending_ba = None  # (WindowProblem, poses, points)
        # global BA after loop closure (global_ba_thread,
        # slam.cpp:1778-1788), skip-merged (slam.cpp:1410-1447)
        self._pending_gba = None
        self.gba_merges = 0

        # place recognition / loop closure
        self.detector = LoopDetector(cfg.num_consistency)
        self.voc = None                 # trained lazily from early keyframes
        self.device_voc = None
        self._vocab_pool: List[np.ndarray] = []
        self.loop_edges: List[tuple] = []
        self.last_loop_candidates: List[int] = []
        self.rejected_loops: List[tuple] = []   # (slot, cand, n_inl, n_vis)
        self.reloc_events: List[tuple] = []     # (frame, ok)
        self.pose_graph_done = False
        self._last_closure_frame = -(10 ** 9)
        self._warned_kf_cap = self._warned_lm_cap = False

    # ------------------------------------------------------------------
    def set_params(self, **kwargs) -> None:
        """Live-tunable runtime parameters (the pangolin::Var analogue,
        slam.cpp:223-310: ~40 hyperparameters adjustable mid-run).

        The host re-reads ``self.cfg`` every frame, so a changed field
        applies from the next frame on. The fields that size the state's
        buffers (``CAPACITY_FIELDS``) cannot change after construction
        (the state is not resized) and raise ``ValueError``; a setting that
        is not ported raises ``NotImplementedError``.
        """
        for k, v in kwargs.items():
            if not hasattr(self.cfg, k):
                raise AttributeError(f"unknown config field: {k}")
            if k in CAPACITY_FIELDS:
                raise ValueError(
                    f"{k!r} sizes the state's buffers and cannot change "
                    "mid-run; rebuild the SlamSystem with a new SlamConfig")
            old = getattr(self.cfg, k)
            setattr(self.cfg, k, v)
            try:
                _check_ported(self.cfg)
            except NotImplementedError:
                setattr(self.cfg, k, old)
                raise
            if k == "pnp_inlier_thresh_px":
                self.pnp_threshold = 1.0 - math.cos(
                    math.atan(float(v) / 500.0))

    def set_param(self, name: str, value) -> None:
        """Single-parameter form, API-symmetric with StreamingVO."""
        self.set_params(**{name: value})

    def _image(self, img):
        if not torch.is_tensor(img):
            img = torch.from_numpy(np.ascontiguousarray(img))
        return img.to(self.device)

    def _predicted_pose(self):
        """Constant-velocity prediction (tracking.h:66-70): landmarks are
        projected from current*vel. Only a reloc-tracked loss holds the
        last pose instead (tracking.h:72-84)."""
        t = self.track
        if self.cfg.enable_relocalization and not self.tracking_ok:
            return t.current_pose
        return lie.se3_mul(t.current_pose, t.vel)

    def _read_scalars(self, res, with_matches: bool):
        """One host read for the step's scalars."""
        vals = torch.stack([
            res.num_matches.to(torch.float64),
            res.num_inliers.to(torch.float64),
            res.motion_err.to(torch.float64),
            res.pnp_ok.to(torch.float64)]).tolist()
        if with_matches:
            self._scalars = {"matches": int(vals[0])}
        self._scalars.update(inliers=int(vals[1]), motion_err=vals[2],
                             pnp_ok=bool(vals[3]))

    def _run_tracking(self, img_l):
        cfg = self.cfg
        predicted = self._predicted_pose()
        res = tracking.track_frame(
            img_l, self.lm, predicted, self.track.current_pose,
            self.track.vel, self.intr0,
            feats=(self.feature_fn(img_l)
                   if self.feature_fn is not None else None),
            cam_name=self.cam_name, num_features=cfg.num_features,
            inview_cap=cfg.max_inview_landmarks,
            width=self.width, height=self.height,
            z_threshold=cfg.cam_z_threshold,
            match_max_dist_2d=cfg.match_max_dist_2d,
            match_threshold=cfg.match_max_dist,
            match_ratio=cfg.match_next_best,
            pnp_threshold=self.pnp_threshold,
            num_hypotheses=cfg.ransac_hypotheses,
            min_matches=cfg.ransac_min_matches,
            quality_level=cfg.quality_level,
            min_distance=cfg.min_distance,
            rotate_features=cfg.rotate_features,
            num_octaves=cfg.num_octaves,
            generator=self.generator,
        )
        self._read_scalars(res, with_matches=True)
        return res

    def _apply_motion_gate(self, res):
        """track_camera semantics (tracking.h:57-161) incl. retry loop.

        Gate-failure retries redraw only the RANSAC localization on the
        already-computed match set (tracking.h:90-160 loops over the solver,
        not the frontend; detection/matching are deterministic here).
        """
        cfg = self.cfg
        if not cfg.enable_relocalization:
            # plain localize_camera: accept PnP result
            return res, self._scalars["pnp_ok"]
        if not self._scalars["pnp_ok"]:
            return res, False
        retries = 0
        while self._scalars["motion_err"] > cfg.motion_threshold:
            retries += 1
            if retries > cfg.track_max_retries:
                return res, False
            res = tracking.retry_localize(
                res, self.lm, self._predicted_pose(),
                self.track.current_pose, self.track.vel, self.intr0,
                cam_name=self.cam_name, pnp_threshold=self.pnp_threshold,
                num_hypotheses=cfg.ransac_hypotheses,
                min_matches=cfg.ransac_min_matches,
                generator=self.generator)
            self._read_scalars(res, with_matches=False)
            if not self._scalars["pnp_ok"]:
                return res, False
        return res, True

    def _lost_pose(self):
        """Pose fallback when tracking fails (tracking.h:72-84,135-145)."""
        t = self.track
        if self.tracking_ok:
            return lie.se3_mul(t.current_pose, t.vel)
        return t.current_pose

    # ------------------- place recognition helpers -------------------
    def _needs_bow(self):
        return self.cfg.enable_loop_closure or self.cfg.enable_relocalization

    def set_vocabulary(self, voc) -> None:
        """Install a pretrained BoW vocabulary (slam.cpp:370-380 loads
        ORBvoc.txt the same way, before any keyframe is processed).

        Accepts a vocabulary from ``loop.vocabulary.train`` or
        ``loop.vocabulary.load_dbow2_text``. Keyframes inserted before the
        call are backfilled into the recognition database.
        """
        self.voc = voc
        self.device_voc = vocab_mod.DeviceVocabulary(voc, self.device)
        self._vocab_pool = []
        self._backfill_bow_db()

    def _maybe_train_vocab(self, feats):
        """Train the BoW vocabulary online from early keyframe descriptors
        (the reference loads a prebuilt ORBvoc.txt, slam.cpp:370-380; that
        asset is not shipped, and ``load_dbow2_text`` serves users who have
        the file)."""
        if self.voc is not None or not self._needs_bow():
            return
        bits = feats.bits[feats.valid].cpu().numpy()
        if len(bits):
            self._vocab_pool.append(bits)
        total = sum(len(b) for b in self._vocab_pool)
        if total >= 3 * self.cfg.num_features or len(self._vocab_pool) >= 4:
            descs = np.concatenate(self._vocab_pool)
            self.voc = vocab_mod.train(
                descs, k=self.cfg.vocab_branching,
                depth=self.cfg.vocab_depth, seed=self.cfg.seed)
            # idf weights from the per-keyframe descriptor sets (DBoW2
            # weighting semantics)
            vocab_mod.set_idf_weights(self.voc, self._vocab_pool)
            self.device_voc = vocab_mod.DeviceVocabulary(self.voc,
                                                         self.device)
            self._vocab_pool = []
            self._backfill_bow_db()

    def _backfill_bow_db(self):
        """Insert keyframes recorded before the vocabulary existed into the
        BoW database (their descriptors live in the keyframe state)."""
        for slot in sorted(self.slot_of_frame.values()):
            if slot in self.detector.db.bow_of:
                continue
            bits = describe_ops.unpack_bits(self.kf.desc[slot, 0])
            valid = self.kf.kp_valid[slot, 0]
            words = self.device_voc.words(bits, valid).cpu().numpy()
            bow = vocab_mod.bow_from_words(self.voc, words)
            if bow:
                self.detector.db.insert(slot, bow)

    def _bow_of(self, feats):
        if self.device_voc is None:
            return None
        words = self.device_voc.words(feats.bits, feats.valid).cpu().numpy()
        return vocab_mod.bow_from_words(self.voc, words)

    def _graph_sets(self):
        return {s: set(d) for s, d in self.covis.items()}

    def _try_relocalize(self, res):
        """relocalize_camera (tracking.h:241-419). Returns (ok, pose)."""
        if self.device_voc is None:
            return False, None
        bow = self._bow_of(res.feats)
        if not bow:
            return False, None
        cfg = self.cfg
        ok, T_wc, _pairs, _diag = reloc_mod.relocalize(
            self.kf, self.lm, self.detector,
            res.feats.bits, res.feats.valid, res.feats.corners, bow,
            self._graph_sets(), self.track.current_pose, self.track.vel,
            self.intr0, self.cam_name, cfg.motion_threshold,
            self.pnp_threshold, self.generator,
            num_hypotheses=cfg.ransac_hypotheses,
            max_retries=cfg.track_max_retries,
            max_candidates=cfg.reloc_max_candidates,
            # this driver relocalizes EVERY lost frame like the reference,
            # so the model is at most one attempt old; repeated failures
            # still let the coast diverge, so scale, under the shared cap
            frames_lost=self._lost_count + 1,
            # cross-gauge recoveries are only safe when loop closure can
            # merge the gauges afterwards (see config.py)
            gate_cap_mult=(cfg.reloc_gate_cap_mult
                           if cfg.enable_loop_closure else
                           min(cfg.reloc_gate_cap_mult,
                               cfg.reloc_gate_cap_mult_no_lc)),
        )
        self.reloc_events.append((self.frame, bool(ok)))
        return ok, T_wc

    def _loop_closure_step(self, slot, feats, edges):
        """detect_loop_closure + compute_sim3 + loop_closure + GBA flag
        (slam.cpp:1219-1259)."""
        cfg = self.cfg
        self._maybe_train_vocab(feats)
        bow = self._bow_of(feats)
        if bow is None:
            return 0
        if not cfg.enable_loop_closure:
            self.detector.db.insert(slot, bow)  # reloc still needs the db
            return 0
        candidates = self.detector.detect(
            slot, bow, edges, self._graph_sets(), 2 * cfg.num_cov_threshold,
            essential_threshold=cfg.num_ess_threshold)
        self.last_loop_candidates = list(candidates)
        n_closed = 0
        if self.loop_edges and self.frame - self._last_closure_frame \
                < cfg.loop_cooldown_frames:
            return 0  # cooldown: the same revisit keeps re-detecting
        fid = self.kf.frame_id.cpu().numpy()
        for cand in candidates:
            if fid[slot] - fid[cand] <= cfg.loop_closing_time_threshold:
                continue
            nbrs = sorted(self.covis.get(cand, {}))
            if cfg.sim3_solver == "horn":
                ok, sim3, _scale = closure_mod.compute_sim3_horn(
                    self.kf, self.lm, slot, cand, nbrs, self.generator,
                    num_hypotheses=cfg.ransac_hypotheses)
            else:
                ok, sim3 = closure_mod.compute_sim3(
                    self.kf, self.lm, slot, cand, nbrs, self.intr0,
                    self.cam_name, self.pnp_threshold, self.generator,
                    num_hypotheses=cfg.ransac_hypotheses)
            if not ok:
                continue
            if cfg.enable_loop_verification:
                verify = dict(px_gate=cfg.loop_verify_px,
                              threshold=cfg.match_max_dist,
                              ratio=cfg.match_next_best)
                n_inl, n_vis = closure_mod.verify_loop(
                    self.kf, self.lm, slot, cand, nbrs, sim3, self.intr0,
                    self.cam_name, self.width, self.height, **verify)
                ok_v = (n_inl >= cfg.loop_verify_min_inliers
                        and n_inl >= cfg.loop_verify_min_ratio
                        * max(n_vis, 1))
                if ok_v and cfg.loop_verify_min_gain > 0:
                    # identity-gain gate: the correction must explain the
                    # old structure better than the CURRENT poses do
                    sim3_id = lie.se3_mul(
                        lie.se3_inv(self.kf.pose_l[cand]),
                        self.kf.pose_l[slot])
                    n_id, _ = closure_mod.verify_loop(
                        self.kf, self.lm, slot, cand, nbrs, sim3_id,
                        self.intr0, self.cam_name, self.width, self.height,
                        **verify)
                    ok_v = n_inl >= cfg.loop_verify_min_gain * max(n_id, 1)
                if not ok_v:
                    self.rejected_loops.append((slot, cand, n_inl, n_vis))
                    continue
            if not cfg.use_sim3:
                sim3 = lie.identity_pose(torch.float32, self.device)
            self.loop_edges.append((slot, cand))
            self._last_closure_frame = self.frame
            # the live side (slot + covisible group) moves rigidly onto
            # the old map; the tracker follows for free: the keyframe
            # step's epilogue re-reads kf.pose_l[slot] (post-closure)
            # into track.current_pose
            self.kf, self.lm, _ = closure_mod.loop_closure(
                self.kf, self.lm, slot, cand, sim3, self.covis, self.T_0_1,
                essential_threshold=cfg.num_ess_threshold,
                fixed_current=cfg.fixed_current_kf,
                huber=1.0, max_iters=20)
            n_closed += 1
            if cfg.enable_gba_after_loop:
                self.pose_graph_done = True
        return n_closed

    # ------------------------------------------------------------------
    def _merge_pending_ba(self, force: bool = False) -> bool:
        """Merge the held window BA (slam.cpp:1379-1408 semantics). The
        solve is finished when it is held, so ``force`` changes nothing."""
        if self._pending_ba is None:
            return False
        wp, poses, points = self._pending_ba
        self.kf, self.lm = ba_window.merge_window_result(
            self.kf, self.lm, wp, poses, points)
        self._pending_ba = None
        return True

    def _merge_pending_gba(self, force: bool = False) -> bool:
        """Skip-merge the held global BA: entries modified since the
        snapshot keep their newer values (slam.cpp:1410-1447)."""
        if self._pending_gba is None:
            return False
        self.kf, self.lm = ba_global.merge_global_ba(
            self.kf, self.lm, self._pending_gba)
        self._pending_gba = None
        self.gba_merges += 1
        return True

    def process_frame(self, img_l, img_r=None) -> dict:
        """One next_step. img_r required on keyframe steps."""
        cfg = self.cfg
        frame_id = self.frame
        # a fixed one-frame merge lag (the reference's background threads
        # merge on wall-clock readiness, which makes whole-run trajectories
        # load-dependent)
        self._merge_pending_ba(force=cfg.deterministic_async)
        self._merge_pending_gba(force=cfg.deterministic_async)

        img_l = self._image(img_l)
        if self.take_keyframe:
            assert img_r is not None, "keyframe step needs the right image"
            with self.timer.stage("keyframe"):
                info = self._keyframe_step(img_l, self._image(img_r))
        else:
            with self.timer.stage("track"):
                info = self._tracking_step(img_l)

        # advance (slam.cpp:1299-1301,1453-1455)
        t = self.track
        new_pose = t.current_pose
        vel = lie.se3_mul(lie.se3_inv(t.last_pose), new_pose)
        # constant-velocity runaway guard: when the frame was lost or
        # localized on marginal inliers, the reference keeps integrating the
        # stale velocity and slowly drifts off. Decay the model toward rest
        # so a run of weak frames coasts to a stop instead of running away.
        if cfg.enable_vel_decay and (
                not info.get("ok")
                or info.get("inliers", 0) < cfg.vel_decay_inlier_floor):
            vel = lie.se3_exp(cfg.vel_decay_factor * lie.se3_log(vel))
        self.track = t.replace(last_pose=new_pose, vel=vel)
        self.trajectory.append(new_pose.cpu().numpy())
        self.frame += 1
        info["frame"] = frame_id
        self._lost_count = 0 if info.get("ok") else self._lost_count + 1
        self.stats.append(info)
        if cfg.debug_checks:
            assert_finite_state(self)
        return info

    # ------------------------------------------------------------------
    def _tracking_step(self, img_l) -> dict:
        cfg = self.cfg
        res = self._run_tracking(img_l)
        res, ok = self._apply_motion_gate(res)

        if ok:
            pose = res.T_w_c
        else:
            pose = self._lost_pose()
            if cfg.enable_relocalization:
                r_ok, r_pose = self._try_relocalize(res)
                if r_ok:
                    pose, ok = r_pose, True
        self.tracking_ok = ok if cfg.enable_relocalization else self.tracking_ok
        self.track = self.track.replace(current_pose=pose)

        n_inl = self._scalars["inliers"] if ok else 0
        # new keyframe only when no background BA is in flight
        # (slam.cpp:1374-1377: !opt_running && !opt_finished)
        if n_inl < cfg.new_kf_min_inliers and self._pending_ba is None:
            self.take_keyframe = True
        return {"kind": "track", "matches": self._scalars["matches"],
                "inliers": n_inl, "ok": ok}

    # ------------------------------------------------------------------
    def _keyframe_step(self, img_l, img_r) -> dict:
        cfg = self.cfg
        self.take_keyframe = False

        res = self._run_tracking(img_l)
        res, ok = self._apply_motion_gate(res)
        if ok or not cfg.enable_relocalization:
            pose = res.T_w_c if self._scalars["pnp_ok"] else self._lost_pose()
        else:
            pose = self._lost_pose()
            r_ok, r_pose = self._try_relocalize(res)
            if r_ok:
                pose, ok = r_pose, True
        if cfg.enable_relocalization:
            self.tracking_ok = ok

        if self.feature_fn is not None:
            feats_r = self.feature_fn(img_r)
        else:
            feats_r = extract_features(img_r,
                                       num_features=cfg.num_features,
                                       quality_level=cfg.quality_level,
                                       min_distance=cfg.min_distance,
                                       rotate_features=cfg.rotate_features,
                                       num_octaves=cfg.num_octaves)
        stereo_j, stereo_inl = kf_mod.stereo_match(
            res.feats, feats_r, self.T_0_1, self.intr0, self.intr1,
            cam_name=self.cam_name, threshold=cfg.match_max_dist,
            ratio=cfg.match_next_best,
            epipolar_threshold=cfg.epipolar_error_threshold,
        )

        suppress = (res.had_candidate
                    if cfg.suppress_duplicate_landmarks else None)
        out = kf_mod.insert_keyframe(
            self.kf, self.lm, self.frame, self.last_kf_slot, pose,
            self.T_0_1, res.feats, feats_r, stereo_j, stereo_inl,
            res.match_lm, res.inlier, self.intr0, self.intr1,
            cam_name=self.cam_name, suppress_new=suppress,
        )
        self.kf, self.lm = out.kf, out.lm
        # one host read: the slot, the landmark count, the step's counters
        # and the covisibility row
        K = cfg.max_keyframes
        host = torch.cat([
            torch.stack([out.slot.to(torch.int64),
                         self.lm.valid.sum(), stereo_inl.sum(),
                         out.num_new.to(torch.int64)]),
            out.covis_weight.to(torch.int64)]).cpu().numpy()
        slot, n_lm, n_stereo, n_new = (int(v) for v in host[:4])
        w = host[4:]
        # an insert past the keyframe capacity is dropped: the step goes on
        # against the last slot, as the reference's clamped reads do
        in_cap = slot < K
        slot = min(slot, K - 1)
        self.slot_of_frame[self.frame] = slot

        # fixed-capacity headroom warnings (writes silently drop past the
        # caps: raise max_keyframes / max_landmarks for longer runs)
        if slot >= int(0.95 * K) and not self._warned_kf_cap:
            self._warned_kf_cap = True
            print(f"[vslam_tpu_torch] WARNING: keyframe capacity nearly "
                  f"exhausted ({slot}/{K})", file=sys.stderr)
        if n_lm >= int(0.95 * cfg.max_landmarks) and not self._warned_lm_cap:
            self._warned_lm_cap = True
            print(f"[vslam_tpu_torch] WARNING: landmark capacity nearly "
                  f"exhausted ({n_lm}/{cfg.max_landmarks}): culling cannot "
                  f"keep up", file=sys.stderr)

        # covisibility edges (construct_visibility_graph, threshold 10)
        edges = {int(s): int(w[s]) for s in np.nonzero(
            w >= cfg.num_cov_threshold)[0] if s != slot}
        self.covis[slot] = edges
        for s, wt in edges.items():
            self.covis.setdefault(s, {})[slot] = wt

        # loop closure / place recognition (slam.cpp:1205-1259)
        n_closed = 0
        if self._needs_bow() and in_cap:
            n_closed = self._loop_closure_step(slot, res.feats, edges)

        # window management (remove_old_keyframes)
        self.kf_window.append(self.frame)
        deact = []
        while len(self.kf_window) > cfg.max_num_kfs:
            old = self.kf_window.pop(0)
            deact.append(self.slot_of_frame[old])
        if deact:
            mask = np.zeros(K, bool)
            mask[deact] = True
            self.kf, self.lm = kf_mod.deactivate_keyframes(
                self.kf, self.lm, torch.as_tensor(mask, device=self.device))

        # landmark slot recycling under capacity pressure (the reference's
        # unbounded map never fills; fixed-capacity state frees
        # weakly-observed dead slots instead of dropping writes)
        if (cfg.enable_lm_culling
                and n_lm >= cfg.lm_cull_pressure * cfg.max_landmarks):
            self.kf, self.lm, n_culled = kf_mod.cull_landmarks(
                self.kf, self.lm, min_lifetime_obs=cfg.lm_cull_min_obs)
            self._last_culled = int(n_culled)

        # windowed BA (optimize() background thread, slam.cpp:1510-1569):
        # solved here, merged at the start of the next frame
        wp = ba_window.build_window_problem(
            self.kf, self.lm, self.intr0, self.intr1,
            W2=cfg.window_cams // 2, Lw=cfg.window_points, O=cfg.window_obs,
            obs_per_lm=cfg.ba_obs_per_lm)
        ba_poses, ba_points, _ = ba_mod.solve_ba_schur(
            wp.prob, cam_name=self.cam_name, huber=cfg.ba_huber_px,
            max_iters=cfg.ba_max_iters)
        self._pending_ba = (wp, ba_poses, ba_points)

        # global BA after a pose-graph correction (slam.cpp:1285-1288):
        # solved on a snapshot like the reference's global_ba_thread,
        # skip-merged at the start of the next frame. A solve still held is
        # superseded (its snapshot predates the new correction).
        if self.pose_graph_done:
            self.pose_graph_done = False
            self._merge_pending_ba(force=True)
            self._pending_gba = ba_global.dispatch_global_ba(
                self.kf, self.lm, self.intr0, self.intr1,
                cam_name=self.cam_name, huber=cfg.ba_huber_px,
                max_iters=cfg.gba_max_iters, cg_iters=cfg.gba_cg_iters,
                mesh=ba_global.gba_mesh(cfg))

        # current pose = the new keyframe's (pre-BA) pose, exactly like the
        # reference reading cameras[fcidl] while BA runs in the background
        pose = self.kf.pose_l[slot].clone()
        self.track = self.track.replace(current_pose=pose)
        self.last_kf_slot = slot

        return {"kind": "keyframe", "slot": slot,
                "matches": self._scalars["matches"],
                "inliers": self._scalars["inliers"],
                "stereo_inliers": n_stereo,
                "new_landmarks": n_new,
                # obs beyond the window_obs cap are dropped from the window
                # BA; nonzero here means the cap is undersized (the
                # reference never drops in-window obs, map_utils.h:369-395)
                "window_obs_dropped": int(wp.obs_dropped),
                "loops_closed": n_closed, "ok": ok}

    # ------------------------------------------------------------------
    def run_global_ba_offline(self):
        """Offline full-map BA (the reference's offline_global_ba button,
        slam.cpp:1724-1740)."""
        self._merge_pending_ba(force=True)
        self._merge_pending_gba(force=True)
        self.kf, self.lm, stats = ba_global.run_global_ba(
            self.kf, self.lm, self.intr0, self.intr1,
            cam_name=self.cam_name, huber=self.cfg.ba_huber_px,
            mesh=ba_global.gba_mesh(self.cfg))
        return stats

    # ------------------------------------------------------------------
    def keyframe_trajectory(self):
        """(frame_ids, positions, poses) of keyframe left cams, for ATE."""
        self._merge_pending_ba(force=True)
        self._merge_pending_gba(force=True)
        valid = self.kf.valid.cpu().numpy()
        fids = self.kf.frame_id.cpu().numpy()[valid]
        poses = self.kf.pose_l.cpu().numpy()[valid]
        order = np.argsort(fids)
        return fids[order], poses[order][:, :3], poses[order]
