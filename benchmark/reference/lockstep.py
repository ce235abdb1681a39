"""The plain reference of the lockstep fleet: S stereo rigs, each with a
map of its own, served by one keyframe insert and one window BA a frame.

A Python loop over the rigs runs each rig's eager single-sequence step of
the port (``vslam_tpu_torch``) in float32 with TF32 off, with no CUDA
graph and no hand-written kernel: the Hamming matching takes the plain
``ops/hamming`` versions (``hamming_top2_plain`` / ``landmark_top2_plain``
behind ``match_descriptors`` / ``match_landmarks``) in place of the
kernels K1 / K2. The service rules are written out here:

- a rig asks for a keyframe on its first frame and whenever a tracked
  frame has fewer than ``new_kf_min_inliers`` inliers; the request stays
  latched until it is served;
- a rig whose window BA has not run yet may not take another keyframe
  (the reference system's ``!opt_running`` gate);
- each lockstep frame serves at most one request: the asking rig first
  in round-robin order from the rig after the one served last;
- each lockstep frame runs at most one window BA, of a rig that inserted
  and has not had its BA yet, round-robin in the same way, after that
  frame's insert.

Departure from an independent reference: the single-rig mathematics
(tracking, stereo matching, keyframe insertion, eviction, culling, the
window BA) are the port's own eager functions, which the repository's
tests hold against the JAX package. So this reference checks what the
multi-sequence driver adds on top of them (the batching over rigs, the
CUDA graphs, the in-place row updates and the service), not the
single-rig mathematics.

Draws. The batched step draws its RANSAC samples as one ``[S, H, N]``
block of uniforms from its generator per lockstep frame (``pnp.
sample_minimal``); the reference draws the same block from a generator
seeded alike and turns row ``s`` into rig ``s``'s samples over that rig's
own matches (``sample_idx``), so both sides solve the same hypotheses.

    python3 benchmark/reference/lockstep.py --workload vo_x8_corridors \
        --seeds 0 1 --frames 64

runs the cell's driver (``benchmark/drivers/<driver>.py``, graphed on the
card) and the reference over the first ``--frames`` lockstep frames of
the cell's stream at each seed and prints one JSON line per seed: the
largest pose difference per rig, and whether the keyframe frames and the
service order are equal. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

import numpy as np
import torch

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (ROOT, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@contextlib.contextmanager
def plain_matching():
    """The port's Hamming matching in its plain PyTorch form, on any
    device, while the block runs."""
    from vslam_tpu_torch.ops import hamming

    saved = hamming._use_kernel
    hamming._use_kernel = lambda t: False
    try:
        yield
    finally:
        hamming._use_kernel = saved


def gumbel_samples(u, valid, sample_size: int = 6):
    """[H, sample_size] distinct valid correspondences per hypothesis from
    uniforms ``u`` [H, N]: the largest Gumbel keys among the valid
    entries, lower index first among ties."""
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    g = -torch.log(-torch.log(u))
    g = torch.where(valid[None, :], g, torch.full_like(g, float("-inf")))
    return torch.sort(g, dim=-1, descending=True, stable=True)[1][
        :, :sample_size]


@dataclasses.dataclass
class Rig:
    """One rig's state."""
    kf: object
    lm: object
    pose: torch.Tensor            # [7]
    last_pose: torch.Tensor       # [7]
    vel: torch.Tensor             # [7]
    last_kf_slot: torch.Tensor    # [] int32
    take_kf: bool = True          # a keyframe request is latched
    ba_pending: bool = False      # inserted, window BA not run yet


class LockstepReference:
    """S rigs of ``calib`` at ``cfg`` stepped in lockstep on ``device``.
    ``step`` returns the frame's poses [S, 7]; the logs are per lockstep
    frame: ``inserted`` (the served rig or None), ``ba`` (the rig whose
    window BA ran or None), and per rig ``poses``, ``keyframe``,
    ``tracked`` and ``inliers``."""

    def __init__(self, calib, num_rigs: int, cfg, device="cpu"):
        import math

        from vslam_tpu_torch.core import state as state_mod
        from vslam_tpu_torch.geometry import lie

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.S, self.calib = cfg, num_rigs, calib
        self.device = torch.device(device)
        self.cam = calib.cam_types[0]
        f32 = dict(dtype=torch.float32, device=self.device)
        self.intr0 = torch.as_tensor(np.asarray(calib.intrinsics[0]), **f32)
        self.intr1 = torch.as_tensor(np.asarray(calib.intrinsics[1]), **f32)
        T_i_c0 = torch.as_tensor(np.asarray(calib.T_i_c[0]), **f32)
        T_i_c1 = torch.as_tensor(np.asarray(calib.T_i_c[1]), **f32)
        self.T_0_1 = lie.se3_mul(lie.se3_inv(T_i_c0), T_i_c1)
        # the tracking gate of the multi-sequence driver
        self.pnp_threshold = 1.0 - math.cos(
            math.atan(cfg.pnp_inlier_thresh_px / 500.0))
        ident = lie.identity_pose(torch.float32, self.device)
        self.rigs = [Rig(
            kf=state_mod.init_keyframes(cfg.max_keyframes, cfg.num_features,
                                        device=self.device),
            lm=state_mod.init_landmarks(cfg.max_landmarks, B=cfg.lm_desc_bank,
                                        device=self.device),
            pose=ident.clone(), last_pose=ident.clone(), vel=ident.clone(),
            last_kf_slot=torch.full((), -1, dtype=torch.int32,
                                    device=self.device))
            for _ in range(num_rigs)]
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.frame = 0
        self.next_insert = 0     # the rig after the one served last
        self.next_ba = 0
        self.inserted, self.ba = [], []
        self.poses, self.keyframe, self.tracked, self.inliers = [], [], [], []

    # -- one rig's parts ----------------------------------------------------

    def _track(self, rig: Rig, img, u):
        from vslam_tpu_torch.pipeline import tracking

        cfg = self.cfg
        kw = dict(
            cam_name=self.cam, num_features=cfg.num_features,
            inview_cap=cfg.max_inview_landmarks, width=self.calib.width,
            height=self.calib.height, z_threshold=cfg.cam_z_threshold,
            match_max_dist_2d=cfg.match_max_dist_2d,
            match_threshold=cfg.match_max_dist,
            match_ratio=cfg.match_next_best,
            pnp_threshold=self.pnp_threshold,
            num_hypotheses=cfg.ransac_hypotheses,
            min_matches=cfg.ransac_min_matches,
            quality_level=cfg.quality_level, min_distance=cfg.min_distance,
            rotate_features=cfg.rotate_features, num_octaves=cfg.num_octaves)
        args = (img, rig.lm, rig.pose, rig.last_pose, rig.vel, self.intr0)
        # the matches do not depend on the draws: a first call finds them,
        # the second solves with this rig's row of the shared draws
        first = tracking.track_frame(*args, sample_idx=torch.zeros(
            (cfg.ransac_hypotheses, 6), dtype=torch.int64,
            device=self.device), **kw)
        idx = gumbel_samples(u, first.match_lm >= 0)
        return tracking.track_frame(*args, sample_idx=idx, feats=first.feats,
                                    **kw)

    def _insert(self, rig: Rig, res, pose, img_r):
        from vslam_tpu_torch.frontend.features import extract_features
        from vslam_tpu_torch.pipeline import keyframe as kf_mod

        cfg = self.cfg
        feats_r = extract_features(
            img_r, num_features=cfg.num_features,
            quality_level=cfg.quality_level, min_distance=cfg.min_distance,
            rotate_features=cfg.rotate_features, num_octaves=cfg.num_octaves)
        sj, sinl = kf_mod.stereo_match(
            res.feats, feats_r, self.T_0_1, self.intr0, self.intr1,
            cam_name=self.cam, threshold=cfg.match_max_dist,
            ratio=cfg.match_next_best,
            epipolar_threshold=cfg.epipolar_error_threshold)
        out = kf_mod.insert_keyframe(
            rig.kf, rig.lm, self.frame, rig.last_kf_slot, pose, self.T_0_1,
            res.feats, feats_r, sj, sinl, res.match_lm, res.inlier,
            self.intr0, self.intr1, cam_name=self.cam)
        if int(out.slot) < rig.kf.frame_id.shape[0]:
            rig.last_kf_slot = out.slot.to(torch.int32)
        kf, lm = kf_mod.evict_to_newest(out.kf, out.lm, cfg.max_num_kfs)
        if cfg.enable_lm_culling:
            kf, lm = kf_mod.cull_under_pressure(
                kf, lm, cfg.lm_cull_pressure, cfg.lm_cull_min_obs)
        rig.kf, rig.lm = kf, lm

    def _window_ba(self, rig: Rig):
        from vslam_tpu_torch.pipeline import ba_window

        cfg = self.cfg
        rig.kf, rig.lm, _ = ba_window.run_window_ba(
            rig.kf, rig.lm, self.intr0, self.intr1, cam_name=self.cam,
            huber=cfg.ba_huber_px, max_iters=cfg.ba_max_iters,
            W2=cfg.window_cams // 2, Lw=cfg.window_points, O=cfg.window_obs,
            obs_per_lm=cfg.ba_obs_per_lm, early_exit=True)

    def _advance(self, rig: Rig, res, pose, served: bool):
        from vslam_tpu_torch.geometry import lie

        cfg = self.cfg
        ok = bool(res.pnp_ok)
        n_inl = int(res.num_inliers) if ok else 0
        vel = lie.se3_mul(lie.se3_inv(rig.last_pose), pose)
        if cfg.enable_vel_decay and (not ok
                                     or n_inl < cfg.vel_decay_inlier_floor):
            vel = lie.se3_exp(cfg.vel_decay_factor * lie.se3_log(vel))
        rig.take_kf = ((rig.take_kf or n_inl < cfg.new_kf_min_inliers)
                       and not served)
        rig.pose, rig.last_pose, rig.vel = pose, pose, vel
        return ok, n_inl

    # -- the lockstep frame ---------------------------------------------------

    def _round_robin(self, wants, start: int):
        for k in range(self.S):
            s = (start + k) % self.S
            if wants(self.rigs[s]):
                return s
        return None

    def step(self, imgs_l, imgs_r):
        """One lockstep frame of imgs_* [S, H, W] (uint8, any device)."""
        cfg, S = self.cfg, self.S
        imgs_l = torch.as_tensor(imgs_l).to(self.device)
        u = torch.rand((S, cfg.ransac_hypotheses, cfg.num_features),
                       generator=self.generator, device=self.device)
        with plain_matching():
            tracked = []
            for s, rig in enumerate(self.rigs):
                res = self._track(rig, imgs_l[s], u[s])
                pose = torch.where(res.pnp_ok, res.T_w_c, rig.pose)
                tracked.append((res, pose))
            sel = self._round_robin(
                lambda r: r.take_kf and not r.ba_pending, self.next_insert)
            if sel is not None:
                rig = self.rigs[sel]
                self._insert(rig, *tracked[sel],
                             torch.as_tensor(imgs_r[sel]).to(self.device))
                rig.ba_pending = True
                self.next_insert = sel + 1
            ba = self._round_robin(lambda r: r.ba_pending, self.next_ba)
            if ba is not None:
                self._window_ba(self.rigs[ba])
                self.rigs[ba].ba_pending = False
                self.next_ba = ba + 1
        oks, inls = [], []
        for s, (rig, (res, pose)) in enumerate(zip(self.rigs, tracked)):
            ok, n = self._advance(rig, res, pose, served=s == sel)
            oks.append(ok)
            inls.append(n)
        poses = torch.stack([r.pose for r in self.rigs])
        self.inserted.append(sel)
        self.ba.append(ba)
        self.poses.append(poses.cpu().numpy())
        self.keyframe.append([s == sel for s in range(S)])
        self.tracked.append(oks)
        self.inliers.append(inls)
        self.frame += 1
        return poses


def compare(drv_infos, drv_results, ref: LockstepReference, n: int):
    """The driver's first ``n`` lockstep frames against the reference's:
    (largest position difference per rig in m, largest quaternion
    component difference per rig, keyframe frames equal, service order
    equal, tracked flags equal; where the keyframe frames differ, the
    first lockstep frame that differs, with both sides' keyframe flags
    and inlier counts per rig over it and the three frames before, and
    the largest position difference before it)."""
    poses = np.stack(ref.poses[:n], 1)                    # [S, n, 7]
    got = drv_results["trajectories"][:, :n]
    dpos = np.abs(got[..., :3] - poses[..., :3]).max(axis=(1, 2))
    dq = np.abs(got[..., 3:] - poses[..., 3:]).max(axis=(1, 2))
    kf_ref = np.asarray(ref.keyframe[:n]).T
    ok_ref = np.asarray(ref.tracked[:n]).T
    served = [(int(np.flatnonzero(i.inserted)[0]) if i.fire else None,
               i.ba_seq) for i in drv_infos[:n]]
    kf_drv = drv_results["is_keyframe"][:, :n]
    out = dict(
        pos_diff_m=dpos.tolist(), quat_diff=dq.tolist(),
        keyframes_equal=bool((kf_drv == kf_ref).all()),
        service_equal=served == list(zip(ref.inserted[:n], ref.ba[:n])),
        tracked_equal=bool((drv_results["tracked_ok"][:, :n]
                            == ok_ref).all()))
    differ = np.flatnonzero((kf_drv != kf_ref).any(0))
    if len(differ):
        f = int(differ[0])
        a = max(0, f - 3)
        out["first_keyframe_difference"] = dict(
            frame=f, frames=[a, f],
            driver_keyframes=kf_drv[:, a:f + 1].astype(int).tolist(),
            reference_keyframes=kf_ref[:, a:f + 1].astype(int).tolist(),
            driver_inliers=drv_results["inliers"][:, a:f + 1].tolist(),
            reference_inliers=np.asarray(ref.inliers[a:f + 1]).T.tolist(),
            pos_diff_before_m=float(np.abs(
                got[:, :f, :3] - poses[:, :f, :3]).max()) if f else 0.0)
    return out


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="vo_x8_corridors")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from harness import cells, geometry, stream
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.io.calib import Calibration

    cell = cells.load(args.workload)
    conf = cell.config
    S = conf["driver_args"]["num_sequences"]
    cfg = SlamConfig(**conf["slam_config"])
    rig = geometry.rig_of(conf)
    calib = Calibration(T_i_c=rig.T_i_c, intrinsics=rig.intrinsics,
                        cam_types=[conf["camera_model"]] * 2,
                        width=rig.width, height=rig.height)
    adapter = cells.module("drivers", conf["driver"])
    for seed in args.seeds:
        tr = dict(cell.traffic, rendered_frames=S * args.frames)
        world = stream.build(tr, rig, seed, args.device)
        drv = adapter.make(calib, cfg, S * args.frames, args.device,
                           **conf["driver_args"])
        ref = LockstepReference(calib, S, cfg, args.device)
        fleet = cells.module("trajectories", "fleet")
        for t in range(args.frames):
            adapter.step(drv, [world.frame(f)
                               for f in range(S * t, S * (t + 1))])
            by_rig = [world.frame(int(fleet.stream_index(s, t, S)))
                      for s in range(S)]
            ref.step(np.stack([f[0] for f in by_rig]),
                     np.stack([f[1] for f in by_rig]))
        line = compare(drv.infos, drv.results(), ref, args.frames)
        line.update(seed=seed, frames=args.frames,
                    new_kf_min_inliers=cfg.new_kf_min_inliers,
                    graphed=bool(getattr(drv, "cuda_graphs", False)),
                    keyframes=int(np.asarray(ref.keyframe).sum()))
        print(json.dumps(line), flush=True)
        del drv, ref, world
    return 0


if __name__ == "__main__":
    sys.exit(main())
