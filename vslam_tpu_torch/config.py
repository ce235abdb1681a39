"""Typed configuration: the canonical hyperparameter registry.

Defaults mirror the reference's ~40 pangolin::Var tunables
(the reference's src/slam.cpp:223-310) plus the solver options structs
(map_utils.h:319-334, loop_closure_utils.h:430-436,651-663). One dataclass,
overridable from the CLI and from JSON.

Host copy of ``vslam_tpu/config.py`` for the PyTorch port: the same
fields, defaults and tunable registries (a test holds them equal). The
"device-tunable" scalars are plain Python floats in the port's driver.
"""

from __future__ import annotations

import dataclasses
import json
import math as _math


@dataclasses.dataclass
class SlamConfig:
    # --- feature extraction / matching (slam.cpp:258-266) ---
    num_features: int = 1500           # hidden.num_features
    rotate_features: bool = True       # hidden.rotate_features
    match_max_dist: int = 70           # hidden.match_max_dist (Hamming)
    match_next_best: float = 1.2       # hidden.match_next_best (ratio)
    match_max_dist_2d: float = 20.0    # hidden.match_max_dist_2d (px gate)
    quality_level: float = 0.01        # goodFeaturesToTrack qualityLevel
    min_distance: int = 8              # goodFeaturesToTrack minDistance
    # image-pyramid octaves (power-of-two levels). 1 = single-scale (the
    # reference's matching frontend); >1 adds scale invariance like the
    # 8-level ORB pyramid its BoW path redetects on (keypoints.h:249)
    num_octaves: int = 1

    # --- keyframing / map management (slam.cpp:268-282) ---
    new_kf_min_inliers: int = 80       # hidden.new_kf_min_inliers
    max_num_kfs: int = 10              # hidden.max_num_kfs (KF pairs in window)
    cam_z_threshold: float = 0.1       # hidden.cam_z_threshold
    motion_threshold: float = 0.5      # hidden.motion_threshold
    num_cov_threshold: int = 10        # hidden.num_cov_threshold (covis weight)
    num_ess_threshold: int = 30        # hidden.num_ess_threshold (essential)

    # --- loop closure (slam.cpp:289-294) ---
    enable_loop_closure: bool = True       # ui.loop_closure
    enable_gba_after_loop: bool = True     # ui.GBA_after
    enable_relocalization: bool = True     # ui.relocalization
    num_consistency: int = 3               # hidden.num_consistency
    loop_closing_time_threshold: int = 500  # hidden.loop_closing_time (frames)
    use_sim3: bool = True                  # hidden.use_sim3
    fixed_current_kf: bool = True          # hidden.fixed_current_kf
    # loop-correction solver: "pnp" = the reference's production path
    # (P3P RANSAC, SE3, sim3.h:228-359); "horn" = closed-form Sim(3) from
    # 3D-3D matches with a scale-consistency gate (sim3.h:48-141)
    sim3_solver: str = "pnp"

    # --- RANSAC / BA (slam.cpp:298-309) ---
    pnp_inlier_thresh_px: float = 3.0      # hidden.pnp_inlier_thresh
    # framework extra (off = reference parity): skip triangulating features
    # that had a gated landmark candidate — avoids near-duplicate landmarks
    # that erode the second-best ratio test
    suppress_duplicate_landmarks: bool = False
    # block lost (coasting) frames from becoming keyframes even when
    # relocalization is off. The reloc driver always applies this gate (a
    # lost frame entering the map at a coasted pose poisons the recognition
    # database — see pipeline/streaming.py); enabling it in a VO config
    # gives a control run the SAME keyframe hygiene as the full-SLAM
    # config, so an ATE comparison isolates the LC/reloc/GBA machinery
    # rather than conflating it with keyframe-gate differences.
    kf_require_tracked: bool = False
    ba_huber_px: float = 1.0               # hidden.ba_huber_width
    ba_max_iters: int = 20                 # BundleAdjustmentOptions
    # async global BA budget (GlobalBundleAdjustmentOptions, 20 iters in
    # the reference): the solve shares the single chip's queue with the
    # stream, so its iteration budget is streaming-throughput-visible;
    # both solvers also early-terminate on function tolerance.
    gba_max_iters: int = 15
    gba_cg_iters: int = 25
    ba_optimize_intrinsics: bool = False
    epipolar_error_threshold: float = 1e-3  # slam.cpp:1148
    ransac_min_matches: int = 10           # vo_utils.h:181
    ransac_hypotheses: int = 256           # batched-RANSAC width (TPU-native)
    track_max_retries: int = 5             # tracking.h:87
    # constant-velocity runaway guard (framework extra; the reference keeps
    # integrating a stale velocity through weak frames): decay the velocity
    # model toward rest when a frame is lost or localized on few inliers.
    enable_vel_decay: bool = True
    deterministic_async: bool = True   # merge async BA/GBA results at a
    # FIXED point (next frame / next poll) instead of when the device
    # happens to finish. The reference's background threads merge on
    # wall-clock readiness, which makes whole-run trajectories
    # load-dependent; a fixed merge point keeps runs bit-reproducible.
    # Set False to maximize tracking/solve overlap in production.
    vel_decay_factor: float = 0.5
    vel_decay_inlier_floor: int = 20

    # --- fixed capacities (TPU static shapes) ---
    max_keyframes: int = 2048              # KF pairs over a full run
    max_landmarks: int = 65536
    max_inview_landmarks: int = 2048       # P: compacted projection set
    lm_desc_bank: int = 4                  # descriptors kept per landmark
    # landmark slot recycling: when the valid count crosses the pressure
    # fraction, weakly-observed dead landmarks (< lm_cull_min_obs lifetime
    # left-cam observations, no windowed obs) are culled and their slots
    # reused (ORB-SLAM-style culling; the reference's unbounded map never
    # needs this). 1.0 disables recycling below a full map.
    lm_cull_pressure: float = 0.8
    lm_cull_min_obs: int = 3
    enable_lm_culling: bool = True
    window_cams: int = 24                  # 2 * (max_num_kfs + slack)
    # window capacities sized to actual EuRoC occupancy: 10 KF pairs x 1500
    # features with typical ~30% landmark overlap peaks near 3-4k active
    # landmarks and ~2.5 obs each; padding beyond that is pure BA cost
    # (every LM iteration pays the full padded shapes)
    window_points: int = 4096              # active landmarks, 10-KF window
    window_obs: int = 12288
    # keep only the k NEWEST in-window observations of each landmark in
    # the window BA (0 = all, reference semantics). Shape-determining:
    # shrinks the per-iteration Jacobian/Schur work on the keyframe hot
    # path; the newest views pin the live end of the window where the
    # estimated pose lives. See ba_window.build_window_problem.
    ba_obs_per_lm: int = 0
    # place the async window BA on this jax.devices() index (None = same
    # chip); on a multi-chip topology the solve then genuinely overlaps
    # tracking instead of sharing the tracking chip's queue
    ba_device: "int | None" = None
    # shard the async/offline GLOBAL BA over a data-axis mesh of this many
    # devices (0/1 = single device): observations sharded over 'data',
    # poses/points replicated, XLA inserts the CG-reduction psums
    # (parallel/sharded_ba.py). The driver falls back to single-device
    # when fewer devices exist. This is the driver path for the
    # 4K-keyframe stretch config (BASELINE configs[4]).
    gba_mesh_devices: int = 0
    # lockstep multi-sequence batching: pending keyframe requests latch on
    # device and the (vmapped, all-sequence) keyframe branch fires only on
    # frames divisible by this period, batching inserts together — with S
    # staggered sequences some sequence wants a keyframe almost every
    # frame, and paying the 8x-BA branch each time dominates. Keyframes
    # are delayed by at most period-1 frames (the reference's pending-BA
    # gate delays them similarly, slam.cpp:1374-1377). 1 = immediate.
    multiseq_kf_period: int = 4

    # --- BoW / place recognition ---
    vocab_branching: int = 10              # DBoW2 k
    vocab_depth: int = 4                   # DBoW2 L (ORBvoc uses 6)
    bow_levels_up: int = 4                 # transform(..., levelsup=4)
    reloc_max_candidates: int = 5          # tracking.h:214-217
    # streaming relocalization (the reference runs reloc inside its hot
    # loop, tracking.h:241-419, wired at slam.cpp:1348-1367; the streaming
    # driver reacts at poll granularity instead): attempt recovery once the
    # newest reloc_lost_frames frames all failed tracking, provided the
    # current frame still has at least reloc_min_features valid features
    # (a sensor blackout yields none — nothing to relocalize against).
    reloc_lost_frames: int = 2
    reloc_min_features: int = 30
    # failed-attempt backoff (framework extra; VERDICT r3 measured 12
    # futile multi-sync attempts in one bench run): after a failed
    # recovery, wait reloc_backoff_frames before the next attempt,
    # doubling per consecutive failure up to the cap; any tracked-ok
    # frame resets the backoff.
    reloc_backoff_frames: int = 16
    reloc_backoff_cap_frames: int = 128
    # absolute cap on the loss-scaled reloc motion gate: the gate grows
    # linearly with frames_lost (see loop/relocalize.py) but an unbounded
    # gate degrades to inlier-count-only acceptance on very long losses —
    # an aliased candidate far from the true trajectory could be accepted.
    # gate = motion_threshold * min(frames_lost, reloc_gate_cap_mult);
    # losses longer than the capped gate can explain fall through to the
    # sustained-loss re-bootstrap instead (r4 advisor finding).
    reloc_gate_cap_mult: int = 12
    # the cap when loop closure is DISABLED: a wide gate lets reloc accept
    # a recovery in a gauge far from the live track's (on a revisit after
    # drift, the coast-to-recovery jump IS the accumulated drift). With LC
    # on, the subsequent closure merges the gauges and the full config
    # wins; with LC off nothing can, and the map holds two internally-
    # consistent but mutually-drifted segments — the r5 ablation measured
    # pre-loss 0.42 m / post-loss 1.49 m / global 3.55 m (gauge tear).
    # The reference's reloc gate never scales at all (tracking.h:388-405),
    # so restricting the scale-up to LC-enabled configs is the faithful
    # rule; LC-off losses beyond this fall through to re-bootstrap, which
    # extends the map in the SINGLE live gauge.
    reloc_gate_cap_mult_no_lc: int = 3
    # sustained-loss re-bootstrap (reference semantics: a lost frame with
    # inliers < threshold takes a keyframe at the coasted pose,
    # slam.cpp:1374-1377 — the map keeps extending in a drifted gauge and
    # loop closure later merges the gauges). The streaming driver blocks
    # lost-frame keyframes so relocalization gets first shot at a clean
    # recovery (see pipeline/streaming.py); after this many consecutive
    # lost frames (set it beyond the reloc poll latency) a frame with
    # >= reloc_min_features features re-bootstraps mapping anyway.
    # 0 disables (pre-r4 behavior: a permanent reloc failure froze the
    # map forever). Device-tunable.
    lost_rebootstrap_frames: int = 30
    # geometric loop verification (framework extra — the reference's
    # landmark-fusion verification is an empty stub,
    # loop_closure_utils.h:424-428, and perceptually-aliased candidates
    # wreck its map): project the candidate side's map points through the
    # proposed correction and demand independent gated descriptor matches.
    enable_loop_verification: bool = True
    loop_verify_min_inliers: int = 30      # absolute match floor
    loop_verify_min_ratio: float = 0.15    # matched / visible floor
    loop_verify_px: float = 15.0           # reprojection gate (pixels)
    # identity-gain gate (framework extra): also project the candidate-side
    # map under the IDENTITY correction (current poses as-is) and accept
    # only when the proposed correction matches the old structure at least
    # this factor better. On an already-consistent map every correction is
    # PnP noise; applying it redistributes error (measured +6 m on the pano
    # world), and the reference would apply it blindly. 0 disables.
    loop_verify_min_gain: float = 1.1
    # cooldown after an accepted closure (framework extra): consecutive
    # keyframes re-detect the same revisit, and each re-closure drags the
    # old map again — measured to compound 4.6 -> 10.5 m ATE on the pano
    # world while a single closure is neutral. ORB-SLAM guards similarly;
    # the reference relies on its global BA to clean up instead.
    loop_cooldown_frames: int = 100

    # --- runtime ---
    dtype: str = "float32"
    seed: int = 0
    # debug: assert all state arrays stay finite after every frame (the
    # functional analogue of the reference's debug NaN-poisoned Eigen)
    debug_checks: bool = False

    def tune_vector(self):
        """Initial values of the device-tunable parameters, registry order.

        Entries with a DEVICE_TUNE_TRANSFORM are stored pre-derived (f64
        host math): deriving them in f32 inside the step is catastrophic
        for cancellation-heavy expressions — 1-cos(atan(px/500)) loses
        ~0.3% relative, enough to shift RANSAC inlier gating measurably.
        """
        return [DEVICE_TUNE_TRANSFORM.get(n, lambda v: v)(
            float(getattr(self, n))) for n in DEVICE_TUNABLE]

    @classmethod
    def from_json(cls, path: str) -> "SlamConfig":
        with open(path) as f:
            data = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in fields})

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)


# --------------------------------------------------------------------------
# Live-tunable parameters (the reference exposes ~40 pangolin::Var values
# mutable DURING a run, slam.cpp:223-310). Three tiers here:
#
# DEVICE_TUNABLE — gate/threshold scalars consumed INSIDE the fused jitted
#   step. They are carried in device state as a float32 vector (traced
#   values, not Python constants), so a driver's set_param() changes them
#   mid-run with ZERO recompilation — the streaming analogue of dragging a
#   Pangolin slider.
#
# HOST_TUNABLE — parameters read from the config object per call on the
#   host side (keyframe orchestration, loop-closure poll, relocalization).
#   set_param() mutates the config field; the next call sees it.
#
# Everything else (capacities, feature counts, octaves, window shapes) is
# STATIC: it determines compiled buffer shapes and requires a driver
# restart — the honest TPU equivalent of the reference's buffer-size
# rebuilds.
# --------------------------------------------------------------------------
DEVICE_TUNABLE = (
    "match_max_dist",            # Hamming gate (keypoints.h threshold=70)
    "match_next_best",           # second-best ratio (1.2)
    "match_max_dist_2d",         # guided-match pixel gate (20 px)
    "cam_z_threshold",           # min landmark depth (0.1 m)
    "quality_level",             # detector response fraction
    "pnp_inlier_thresh_px",      # RANSAC reprojection gate (3 px)
    "ransac_min_matches",        # PnP minimum match count
    "new_kf_min_inliers",        # keyframe trigger (slam.cpp:1374)
    "ba_huber_px",               # window-BA robust width (1 px)
    "vel_decay_factor",
    "vel_decay_inlier_floor",
    "epipolar_error_threshold",  # stereo inlier gate (slam.cpp:1148)
    "lost_rebootstrap_frames",   # sustained-loss re-bootstrap (0 = off)
    "reloc_min_features",        # min features to attempt reloc/rebootstrap
)
TUNE_INDEX = {n: i for i, n in enumerate(DEVICE_TUNABLE)}

# Values stored in the tune vector PRE-DERIVED on the host (f64). The
# user-facing set_param knob keeps the reference's units (pixels); the
# vector carries what the step actually compares against. Deriving
# 1-cos(atan(px/500)) in f32 on device cancels catastrophically (~0.3%
# relative error), which measurably perturbs RANSAC inlier gating.
DEVICE_TUNE_TRANSFORM = {
    "pnp_inlier_thresh_px":
        lambda px: 1.0 - _math.cos(_math.atan(px / 500.0)),
}

HOST_TUNABLE = frozenset({
    "motion_threshold", "track_max_retries", "num_cov_threshold",
    "num_ess_threshold", "num_consistency", "loop_closing_time_threshold",
    "use_sim3", "fixed_current_kf", "sim3_solver", "ba_max_iters",
    "gba_max_iters", "gba_cg_iters",
    "reloc_max_candidates", "reloc_lost_frames",
    "reloc_backoff_frames", "reloc_backoff_cap_frames",
    "reloc_gate_cap_mult", "reloc_gate_cap_mult_no_lc",
    "enable_loop_closure", "enable_gba_after_loop",
    "enable_loop_verification", "loop_verify_min_inliers",
    "loop_verify_min_ratio", "loop_verify_px", "loop_verify_min_gain",
    "loop_cooldown_frames", "lm_cull_min_obs", "lm_cull_pressure",
    "deterministic_async", "suppress_duplicate_landmarks",
})
