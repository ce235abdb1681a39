"""The non-pinhole camera models (double-sphere, Kannala-Brandt kb4,
extended-unified eucm) through the port's pipeline against the JAX
package, on the CPU.

The world is tests/test_e2e_ds_model.py's,
``synthetic.generate(num_frames=14, num_points=500, seed=7,
cam_type=...)``, at that test's configuration. A map is built by the
port's ``StreamingVO`` over the first ``MAP_FRAMES`` frames and handed to
both packages; from it, for each model:

- one ``track_frame`` on the next frame, the JAX package's RANSAC draws
  injected: the matches equal bit for bit, the pose within 1e-4;
- one ``stereo_match`` + ``insert_keyframe`` from the JAX step's tracking
  result: the same matched pairs, the same keyframe record, new landmark
  positions within 1e-4 m;
- one window-BA build (the whole problem equal) and ``run_window_ba``
  from keyframe poses perturbed by numpy noise: final cost within 1e-4
  relative, poses within 1e-4 of a float64 solve and of the JAX
  package's where both take the same LM steps (see the test);
- the loop closure's camera sites from the newest keyframe against the
  others: the guided refinement (match count equal, pose within 1e-4),
  ``verify_loop`` (counts equal) and ``compute_sim3`` with the JAX draws
  (sim3 within 1e-4);
- the projection gate of ``project_landmarks`` on points at every angle
  (behind the camera, at the image edge, past the ds model's valid
  region): the same landmarks let through, the same pixels;
- the projection Jacobian (``torch.func.jvp``, the JAX package's
  ``jacfwd``) at ordinary points and at kb4's ``r < 1e-12`` branch, and
  the intrinsics blocks of the free-intrinsics window BA for kb4 and eucm
  (``tests/test_torch_ba.py`` holds ds).

End to end, port only (hazard e: RANSAC streams differ): ``SlamSystem``
and ``StreamingVO`` on that world with the JAX test's bars, at least 3
keyframes and keyframe ATE < 0.12 m.
"""

import dataclasses
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ba_golden import build_problem
from vslam_tpu.core import state as jstate
from vslam_tpu.frontend import features as jfeat
from vslam_tpu.geometry import cameras as jcam
from vslam_tpu.geometry import lie as jlie
from vslam_tpu.loop import closure as jclosure
from vslam_tpu.pipeline import ba_window as jbaw
from vslam_tpu.pipeline import keyframe as jkf
from vslam_tpu.pipeline import tracking as jtrack
from vslam_tpu.solvers import ba as jba
from vslam_tpu.solvers import pnp as jpnp
from vslam_tpu_torch import interop, synthetic
from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.core.state import KeyframeState, LandmarkState
from vslam_tpu_torch.eval import ate
from vslam_tpu_torch.frontend.features import Features
from vslam_tpu_torch.geometry import cameras as tcam
from vslam_tpu_torch.geometry import lie as tlie
from vslam_tpu_torch.loop import closure as tclosure
from vslam_tpu_torch.pipeline import ba_window as tbaw
from vslam_tpu_torch.pipeline import keyframe as tkf
from vslam_tpu_torch.pipeline import tracking as ttrack
from vslam_tpu_torch.pipeline.slam import SlamSystem
from vslam_tpu_torch.pipeline.streaming import StreamingVO
from vslam_tpu_torch.solvers import ba as tba

CAMS = ["ds", "kb4", "eucm"]
MAP_FRAMES = 8
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tests run in parallel workers, and small
    tensors gain nothing from more (oversubscribed, they lose much)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def e2e_config():
    """tests/test_e2e_ds_model.py's configuration."""
    return SlamConfig(
        num_features=400, ransac_hypotheses=128, max_landmarks=8192,
        max_keyframes=64, max_inview_landmarks=512, window_cams=24,
        window_points=2048, window_obs=6144, ba_max_iters=8,
        enable_relocalization=False, enable_loop_closure=False,
        new_kf_min_inliers=60)


def tt(x):
    return torch.as_tensor(np.array(x))


def jax_tree(cls, arrays):
    return cls(**{k: jnp.asarray(v) for k, v in arrays.items()
                  if k in cls._fields})


@functools.cache
def world(cam):
    return synthetic.generate(num_frames=14, num_points=500, seed=7,
                              cam_type=cam)


@functools.cache
def mapped(cam):
    """The port's StreamingVO over the first MAP_FRAMES frames: the map
    both packages start from, as numpy arrays (kf, lm, rest)."""
    seq = world(cam)
    vo = StreamingVO(seq.calib, e2e_config(), max_frames=32, device="cpu")
    vo.run(seq.images[:MAP_FRAMES])
    st = interop.to_arrays(vo.state)
    assert int(st["kf"]["valid"].sum()) >= 2
    return st


@functools.cache
def jax_step(cam):
    """The JAX package's tracking of frame MAP_FRAMES from the map, its
    right-image features, its RANSAC draws and its predicted pose."""
    seq, st, cfg = world(cam), mapped(cam), e2e_config()
    lm = jax_tree(jstate.LandmarkState, st["lm"])
    key = jax.random.PRNGKey(11)
    img_l, img_r = seq.images[MAP_FRAMES]
    pred = jlie.se3_mul(jnp.asarray(st["cur_pose"]), jnp.asarray(st["vel"]))
    res = jtrack.track_frame(
        key, jnp.asarray(img_l), lm, pred, jnp.asarray(st["cur_pose"]),
        jnp.asarray(st["vel"]), jnp.asarray(st["intr0"]), cam_name=cam,
        **track_kwargs(cfg, seq.calib))
    feats_r = jfeat.extract_features(jnp.asarray(img_r),
                                     num_features=cfg.num_features)
    idx = np.asarray(jpnp._sample_minimal(
        key, res.match_lm >= 0, cfg.ransac_hypotheses, 6))
    return res, feats_r, idx, pred


def track_kwargs(cfg, calib):
    return dict(
        num_features=cfg.num_features, inview_cap=cfg.max_inview_landmarks,
        width=calib.width, height=calib.height,
        z_threshold=cfg.cam_z_threshold,
        match_max_dist_2d=cfg.match_max_dist_2d,
        match_threshold=cfg.match_max_dist, match_ratio=cfg.match_next_best,
        pnp_threshold=1.0 - math.cos(math.atan(
            cfg.pnp_inlier_thresh_px / 500.0)),
        num_hypotheses=cfg.ransac_hypotheses,
        min_matches=cfg.ransac_min_matches, quality_level=cfg.quality_level,
        min_distance=cfg.min_distance, rotate_features=cfg.rotate_features,
        num_octaves=cfg.num_octaves)


def port_state(cam):
    st = mapped(cam)
    return (interop.from_arrays(KeyframeState, st["kf"], "cpu"),
            interop.from_arrays(LandmarkState, st["lm"], "cpu"))


def assert_same(port_obj, jax_obj, atol=1e-5, rtol=None):
    """Integer and boolean fields equal; float fields within atol, or a
    per-field relative tolerance ``rtol[name]``."""
    got = interop.to_arrays(port_obj)
    want = jax_obj._asdict()
    for name, value in got.items():
        ref = np.asarray(want[name])
        if value.dtype.kind == "f":
            np.testing.assert_allclose(value, ref, atol=atol,
                                       rtol=(rtol or {}).get(name, 0),
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(value, ref.astype(value.dtype),
                                          err_msg=name)


# ---------------------------------------------------------------------------
# one step of each stage, from the same map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cam", CAMS)
def test_track_frame_matches_jax(cam):
    seq, st, cfg = world(cam), mapped(cam), e2e_config()
    res_j, _, idx, pred = jax_step(cam)
    _, lm = port_state(cam)
    img_l = seq.images[MAP_FRAMES][0]
    res_t = ttrack.track_frame(
        torch.as_tensor(img_l), lm, tt(pred), tt(st["cur_pose"]),
        tt(st["vel"]), tt(st["intr0"]), cam_name=cam,
        sample_idx=torch.as_tensor(idx), **track_kwargs(cfg, seq.calib))
    assert int(res_t.num_matches) == int(res_j.num_matches) > 20
    np.testing.assert_array_equal(res_t.match_lm.numpy(),
                                  np.asarray(res_j.match_lm))
    np.testing.assert_array_equal(res_t.had_candidate.numpy(),
                                  np.asarray(res_j.had_candidate))
    np.testing.assert_array_equal(res_t.inlier.numpy(),
                                  np.asarray(res_j.inlier))
    assert int(res_t.num_inliers) == int(res_j.num_inliers) > 15
    assert bool(res_t.pnp_ok) and bool(res_j.pnp_ok)
    np.testing.assert_allclose(res_t.T_w_c.numpy(), np.asarray(res_j.T_w_c),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(float(res_t.motion_err),
                               float(res_j.motion_err), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cam", CAMS)
def test_stereo_match_and_insert_keyframe_match_jax(cam):
    st = mapped(cam)
    res, feats_r, _, _ = jax_step(cam)
    T_0_1, intr0, intr1 = (jnp.asarray(st[k]) for k in
                           ("T_0_1", "intr0", "intr1"))
    sj, sinl = jkf.stereo_match(res.feats, feats_r, T_0_1, intr0, intr1,
                                cam_name=cam)
    fl = interop.from_arrays(Features, res.feats._asdict(), "cpu")
    fr = interop.from_arrays(Features, feats_r._asdict(), "cpu")
    sj_t, sinl_t = tkf.stereo_match(fl, fr, tt(T_0_1), tt(intr0), tt(intr1),
                                    cam_name=cam)
    np.testing.assert_array_equal(sinl_t.numpy(), np.asarray(sinl))
    np.testing.assert_array_equal(sj_t.numpy(), np.asarray(sj))
    assert int(sinl_t.sum()) > 50

    out_j = jkf.insert_keyframe(
        jax_tree(jstate.KeyframeState, st["kf"]),
        jax_tree(jstate.LandmarkState, st["lm"]),
        jnp.asarray(MAP_FRAMES, jnp.int32), jnp.asarray(st["last_kf_slot"]),
        res.T_w_c, T_0_1, res.feats, feats_r, sj, sinl, res.match_lm,
        res.inlier, intr0, intr1, cam_name=cam)
    kf, lm = port_state(cam)
    out_t = tkf.insert_keyframe(
        kf, lm, MAP_FRAMES, tt(st["last_kf_slot"]), tt(res.T_w_c),
        tt(T_0_1), fl, fr, sj_t, sinl_t, tt(res.match_lm), tt(res.inlier),
        tt(intr0), tt(intr1), cam_name=cam)
    assert int(out_t.num_new) == int(out_j.num_new) > 20
    assert int(out_t.slot) == int(out_j.slot)
    assert_same(out_t.kf, out_j.kf)
    new = np.asarray(out_j.lm.valid) & ~st["lm"]["valid"]
    old = ~new
    for name in ("pos", "pos_c"):
        np.testing.assert_allclose(getattr(out_t.lm, name).numpy()[old],
                                   np.asarray(getattr(out_j.lm, name))[old],
                                   atol=0, rtol=0, err_msg=name)
    assert_same(dataclasses.replace(out_t.lm, pos=out_t.lm.pos[:0],
                                    pos_c=out_t.lm.pos_c[:0]),
                out_j.lm._replace(pos=out_j.lm.pos[:0],
                                  pos_c=out_j.lm.pos_c[:0]))
    # the new landmarks: the float32 midpoint of two rays 11 cm apart
    # divides by det = sin^2 of the ray angle (~1e-4 at 10 m), so an ulp
    # of difference in a bearing or a dot product (the two frameworks
    # round and sum in different orders) moves the point by eps |p| / det:
    # up to ~5 cm at 15 m in either package against the float64 midpoint.
    # Held within 1e-4 m plus 8 such ulps.
    kfs = int(out_t.slot)
    mp = out_t.kf.map_points[kfs].numpy()
    feats = np.flatnonzero((mp >= 0) & new[np.clip(mp, 0, None)])
    rows = mp[feats]
    assert len(rows) == int(out_t.num_new)
    f0 = tcam.unproject(cam, tt(intr0).double(),
                        fl.corners[feats].double())
    f1 = tcam.unproject(cam, tt(intr1).double(),
                        fr.corners[sj_t[feats]].double())
    T01 = tt(T_0_1).double()
    cos = torch.sum(f0 * tlie.quat_rotate(tlie.se3_q(T01), f1), dim=-1)
    det = (1.0 - cos * cos).numpy()
    p_c = np.asarray(out_j.lm.pos_c)[rows]
    bound = TOL + 8 * np.finfo(np.float32).eps * np.linalg.norm(
        p_c, axis=1) / det
    for name in ("pos", "pos_c"):
        err = np.linalg.norm(getattr(out_t.lm, name).numpy()[rows]
                             - np.asarray(getattr(out_j.lm, name))[rows],
                             axis=1)
        assert (err <= bound).all(), (name, err.max(), (err / bound).max())
    np.testing.assert_array_equal(out_t.covis_weight.numpy(),
                                  np.asarray(out_j.covis_weight))


@pytest.mark.parametrize("cam", CAMS)
def test_window_ba_matches_jax(cam):
    """The window problem from the map equal; one build + solve + merge
    from keyframe poses perturbed by 2 mm (as tests/test_torch_streaming
    .py): the same costs, and the port's poses and points within 1e-4 of
    the same solver run in float64 on the same problem (the exact answer
    of its LM schedule). Where both packages end on the same damping (the
    same accept / reject decisions) the port's poses and points are also
    within 1e-4 of the JAX package's. On the eucm world the JAX package's
    float32 rejects one step that the port and the float64 run accept
    (the trial costs differ in their last bits): it then ends 1.6e-4 from
    the float64 answer, and is held within 1e-3."""
    st, cfg = mapped(cam), e2e_config()
    kw = dict(W2=cfg.window_cams // 2, Lw=cfg.window_points,
              O=cfg.window_obs)
    kf_a = dict(st["kf"])
    noise = np.random.RandomState(1).normal(0, 2e-3, kf_a["pose_l"].shape)
    noise[:, 3:] = 0.0
    kf_a["pose_l"] = (kf_a["pose_l"] + noise).astype(np.float32)
    kf_j = jax_tree(jstate.KeyframeState, kf_a)
    lm_j = jax_tree(jstate.LandmarkState, st["lm"])
    kf_t = interop.from_arrays(KeyframeState, kf_a, "cpu")
    lm_t = interop.from_arrays(LandmarkState, st["lm"], "cpu")
    intr0, intr1 = jnp.asarray(st["intr0"]), jnp.asarray(st["intr1"])

    wj = jbaw.build_window_problem(kf_j, lm_j, intr0, intr1, **kw)
    wt = tbaw.build_window_problem(kf_t, lm_t, tt(intr0), tt(intr1), **kw)
    assert_same(wt.prob, wj.prob, atol=0)
    for name in ("sel_kf", "sel_kf_valid", "sel_lm", "sel_lm_valid",
                 "obs_dropped"):
        np.testing.assert_array_equal(getattr(wt, name).numpy(),
                                      np.asarray(getattr(wj, name)),
                                      err_msg=name)
    assert int(wt.prob.obs_valid.sum()) > 100

    kj, lj, sj = jbaw.run_window_ba(kf_j, lm_j, intr0, intr1, cam_name=cam,
                                    max_iters=cfg.ba_max_iters, **kw)
    kt, lt, stt = tbaw.run_window_ba(kf_t, lm_t, tt(intr0), tt(intr1),
                                     cam_name=cam,
                                     max_iters=cfg.ba_max_iters, **kw)
    np.testing.assert_allclose(float(stt["initial_cost"]),
                               float(sj["initial_cost"]), rtol=TOL)
    np.testing.assert_allclose(float(stt["final_cost"]),
                               float(sj["final_cost"]), rtol=TOL)
    assert float(stt["final_cost"]) < float(stt["initial_cost"])
    assert int(stt["iterations"]) == int(sj["iterations"])

    # the same solve in float64: what the merged poses and points hold
    p64 = dataclasses.replace(wt.prob, **{
        f.name: getattr(wt.prob, f.name).double()
        for f in dataclasses.fields(wt.prob)
        if getattr(wt.prob, f.name).dtype == torch.float32})
    poses64, points64, _ = tba.solve_ba_schur(
        p64, cam_name=cam, huber=1.0, max_iters=cfg.ba_max_iters)
    kv, lv = wt.sel_kf_valid, wt.sel_lm_valid
    sel_kf, sel_lm = wt.sel_kf.long(), wt.sel_lm.long()

    def window_of(kf, lm):
        """The merged poses [2 W2, 7] and points [Lw, 3] of the window,
        from either package's state."""
        pose_l, pose_r, pos = (torch.as_tensor(np.asarray(x)).double()
                               for x in (kf.pose_l, kf.pose_r, lm.pos))
        poses = torch.stack([pose_l[sel_kf], pose_r[sel_kf]], 1)
        return poses.reshape(-1, 7), pos[sel_lm]

    def pixels(poses, points):
        """Every window observation's residual [O, 2] in pixels."""
        r = tba._residuals(cam, p64, poses, points)
        return r[p64.obs_valid].numpy()

    port, ref = window_of(kt, lt), window_of(kj, lj)
    pose_ok = kv.repeat_interleave(2)
    np.testing.assert_allclose(port[0][pose_ok].numpy(),
                               poses64[pose_ok].numpy(), atol=TOL, rtol=0)
    # a far point sits on a flat valley along its ray (the cost moves by
    # float32 noise over centimetres at 15 m), so points are held by the
    # pixels they project to, which the cost measures
    np.testing.assert_allclose(pixels(*port), pixels(poses64, points64),
                               atol=1e-3, rtol=0)
    same_schedule = float(stt["lambda"]) == float(sj["lambda"])
    assert same_schedule or cam == "eucm"
    tol = TOL if same_schedule else 1e-3
    np.testing.assert_allclose(kt.pose_l.numpy(), np.asarray(kj.pose_l),
                               atol=tol, rtol=0)
    np.testing.assert_allclose(pixels(*port), pixels(*ref),
                               atol=10 * tol, rtol=0)


# ---------------------------------------------------------------------------
# the loop-closure sites that take the camera (guided refinement, the
# verification, the PnP sim3 with the JAX draws), on the same map
# ---------------------------------------------------------------------------

def closure_inputs(cam):
    """The map in both packages' types; the newest keyframe as the query,
    the others as the candidate side."""
    st = mapped(cam)
    kf_j = jax_tree(jstate.KeyframeState, st["kf"])
    lm_j = jax_tree(jstate.LandmarkState, st["lm"])
    kf_t, lm_t = port_state(cam)
    cur = int(st["kf"]["next_slot"]) - 1
    kmask = st["kf"]["valid"].copy()
    kmask[cur] = False
    return kf_j, lm_j, kf_t, lm_t, cur, kmask, st["intr0"]


@pytest.mark.parametrize("cam", CAMS)
def test_guided_refine_and_verify_match_jax(cam):
    kf_j, lm_j, kf_t, lm_t, cur, kmask, intr = closure_inputs(cam)
    # a start 2 cm / 10 mrad off the keyframe's pose
    T0 = np.asarray(jlie.se3_mul(kf_j.pose_l[cur], jlie.se3_exp(
        jnp.asarray([0.02, -0.01, 0.01, 0.004, -0.006, 0.002]))))
    Tj, nj = jclosure._guided_refine_device(
        kf_j, lm_j, jnp.asarray(cur, jnp.int32), jnp.asarray(kmask),
        jnp.asarray(T0), jnp.asarray(intr), cam_name=cam)
    Tt, nt = tclosure._guided_refine_device(
        kf_t, lm_t, cur, tt(kmask), tt(T0), tt(intr), cam_name=cam)
    assert int(nt) == int(nj) >= 40
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=TOL)
    seq = world(cam)
    cand = int(np.flatnonzero(kmask)[0])
    nb = [int(s) for s in np.flatnonzero(kmask)[1:2]]
    kw = dict(px_gate=15.0, threshold=70, ratio=1.2)
    vj = jclosure.verify_loop(
        kf_j, lm_j, cur, cand, nb, jnp.asarray(np.asarray(jlie.se3_mul(
            jlie.se3_inv(kf_j.pose_l[cand]), kf_j.pose_l[cur]))),
        jnp.asarray(intr), cam, seq.calib.width, seq.calib.height, **kw)
    sim3 = tlie.se3_mul(tlie.se3_inv(kf_t.pose_l[cand]), kf_t.pose_l[cur])
    vt = tclosure.verify_loop(kf_t, lm_t, cur, cand, nb, sim3, tt(intr),
                              cam, seq.calib.width, seq.calib.height, **kw)
    assert vt == vj and vt[0] >= 8, (vt, vj)


@pytest.mark.parametrize("cam", CAMS)
def test_compute_sim3_matches_jax_with_injected_draws(cam):
    kf_j, lm_j, kf_t, lm_t, cur, kmask, intr = closure_inputs(cam)
    slots = [int(s) for s in np.flatnonzero(kmask)]
    okj, sim3_j = jclosure.compute_sim3(
        kf_j, lm_j, cur, slots[0], slots[1:2], jnp.asarray(intr), cam,
        pnp_threshold=1.8e-5, key=jax.random.PRNGKey(3), num_hypotheses=64)
    key = [jax.random.PRNGKey(3)]

    def jax_draws(valid, num_hypotheses):
        key[0], k = jax.random.split(key[0])
        return torch.as_tensor(np.array(jpnp._sample_minimal(
            k, jnp.asarray(valid.numpy()), num_hypotheses, 6)))

    okt, sim3_t = tclosure.compute_sim3(
        kf_t, lm_t, cur, slots[0], slots[1:2], tt(intr), cam,
        pnp_threshold=1.8e-5, num_hypotheses=64, sampler=jax_draws)
    assert okt and okj
    np.testing.assert_allclose(sim3_t.numpy(), np.asarray(sim3_j), atol=TOL)


# ---------------------------------------------------------------------------
# the camera models where they are hardest
# ---------------------------------------------------------------------------

def wide_points(rng, n=4000):
    """Directions over the whole sphere (behind the camera included), at
    depths 0.2-20 m, and a few on the optical axis."""
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = d * rng.uniform(0.2, 20.0, (n, 1))
    p[:8] = [[0, 0, z] for z in (0.5, 1, 2, 4, 8, -1, -2, 3)]
    return p.astype(np.float32)


@pytest.mark.parametrize("cam", CAMS)
@pytest.mark.parametrize("width,height", [(320, 240), (752, 480)])
def test_projection_gate_matches_jax(cam, width, height):
    """``project_landmarks`` at every angle: which landmarks each package
    lets through (z and the image box: a ds point past the model's valid
    region projects through a near-zero or negative denominator) and
    their pixels. At the full width (fx = 220 at 752 px) the image corners
    lie 2.0 focal lengths off the axis."""
    rng = np.random.RandomState(3)
    intr = np.asarray(synthetic.make_calib(width, height, cam)
                      .intrinsics[0], np.float32)
    pos = wide_points(rng)
    L = len(pos)
    T = np.asarray([0.1, -0.2, 0.3, 0.0, 0.0, 0.0, 1.0], np.float32)
    # project_landmarks reads the positions and the validity alone
    lj = jstate.LandmarkState(*[None] * len(jstate.LandmarkState._fields))
    lj = lj._replace(pos=jnp.asarray(pos), valid=jnp.ones(L, bool))
    lt = types.SimpleNamespace(pos=torch.as_tensor(pos),
                               valid=torch.ones(L, dtype=torch.bool))
    pj, okj = jtrack.project_landmarks(lj, jnp.asarray(T), cam,
                                       jnp.asarray(intr), width, height, 0.1)
    pt, okt = ttrack.project_landmarks(lt, torch.as_tensor(T), cam,
                                       torch.as_tensor(intr), width, height,
                                       0.1)
    okj = np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert 200 < okj.sum() < L
    pj = np.asarray(pj)
    np.testing.assert_allclose(pt.numpy()[okj], pj[okj], atol=1e-3, rtol=0)
    # every point let through unprojects back onto its ray
    p_c = np.asarray(jlie.se3_apply(jlie.se3_inv(jnp.asarray(T)),
                                    jnp.asarray(pos)))[okj]
    rays = tcam.unproject(cam, torch.as_tensor(intr),
                          pt[torch.as_tensor(okj)]).numpy()
    cos = np.sum(rays * p_c, axis=1) / np.linalg.norm(p_c, axis=1)
    assert cos.min() > 1 - 1e-4, cos.min()


@pytest.mark.parametrize("cam", CAMS)
def test_projection_jacobian_matches_jax(cam):
    """The BA's projection Jacobian (``torch.func.jvp``) against the JAX
    package's ``jacfwd`` at camera-frame points, kb4's on-axis branch
    (``r < 1e-12``) included."""
    rng = np.random.RandomState(5)
    intr = np.asarray(synthetic.make_calib(320, 240, cam).intrinsics[0],
                      np.float32)
    p = rng.normal(size=(256, 3)).astype(np.float32)
    p[:, 2] = np.abs(p[:, 2]) + 0.5
    p[:4, :2] = 0.0                      # on the optical axis
    p[4:8, :2] = 1e-14
    pred_t, J_t = tba.project_jacobian(cam, torch.as_tensor(intr),
                                       torch.as_tensor(p))
    J_j = jax.vmap(jax.jacfwd(lambda x: jcam.project(cam, intr, x)))(
        jnp.asarray(p))
    J_j = np.asarray(J_j)
    assert np.isfinite(J_t.numpy()).all()
    np.testing.assert_allclose(pred_t.numpy(),
                               np.asarray(jcam.project(cam, intr, p)),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(J_t.numpy(), J_j, rtol=1e-4,
                               atol=1e-4 * np.abs(J_j).max())


def intr_problem(cam):
    """tests/test_ba_golden.py's scene observed through ``cam`` (numpy
    noise), six cameras, the intrinsics of both blocks off by 1% in focal
    length and 2 px in cx."""
    (_, _, poses0, pts0, obs_cam, obs_pt, _) = build_problem(
        seed=4, n_cams=6, n_pts=60)
    intr = np.asarray(synthetic.make_calib(640, 480, cam).intrinsics[0],
                      np.float32)
    intr[:2] = [349.0, 348.0]
    pc = np.asarray(jlie.se3_apply(
        jlie.se3_inv(jnp.asarray(poses0[obs_cam], jnp.float32)),
        jnp.asarray(pts0[obs_pt], jnp.float32)))
    uv = np.asarray(jcam.project(cam, jnp.asarray(intr), jnp.asarray(pc)))
    uv = uv + np.random.RandomState(4).normal(0, 0.4, uv.shape)
    n_obs, n_pts = len(obs_cam), len(pts0)
    off = intr * np.asarray([1.01, 1.01, 1, 1, 1, 1, 1, 1], np.float32) \
        + np.asarray([0, 0, 2.0, 0, 0, 0, 0, 0], np.float32)
    return dict(
        poses=np.asarray(poses0, np.float32),
        pose_fixed=np.arange(6) < 2, intr=np.tile(off, (6, 1)),
        points=np.asarray(pts0, np.float32),
        point_valid=np.ones(n_pts, bool),
        obs_cam=obs_cam.astype(np.int32), obs_point=obs_pt.astype(np.int32),
        obs_uv=uv.astype(np.float32), obs_valid=np.ones(n_obs, bool))


@pytest.mark.parametrize("cam", ["kb4", "eucm"])
def test_intrinsics_blocks_match_jax(cam):
    """The free-intrinsics window BA's normal equations, whose intrinsics
    Jacobian covers the distortion parameters (kb4's k1..k4, eucm's
    alpha and beta), and a solve: the intrinsics are weakly determined
    against depth (tests/test_torch_ba.py), so the two runs part after
    the first step and are held to the same initial cost, final costs
    within 1% of each other and below a tenth of the initial one."""
    arrays = intr_problem(cam)
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
    out_j = jba._normal_equations_intr(cam, jp, jp.poses, jp.points,
                                       jp.intr[:2], 1.0)
    tp = interop.from_arrays(tba.BAProblem, arrays, "cpu")
    out_t = tba._normal_equations_intr(cam, tp, tp.poses, tp.points,
                                       tp.intr[:2], 1.0)
    names = ["Hcc", "Hpp", "U", "bc", "bp", "r", "Hii", "bi", "Hci", "Upi"]
    for name, a, b in zip(names, out_t, out_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=name)
    used = 8 if cam == "kb4" else 6
    Hii = out_t[6].numpy()
    assert np.abs(Hii[0, used - 1, used - 1]) > 0   # distortion is free
    _, _, ij, sj = jba.solve_ba_schur_intrinsics(jp, cam_name=cam,
                                                 huber=1.0, max_iters=30)
    _, _, it, st = tba.solve_ba_schur_intrinsics(tp, cam_name=cam,
                                                 huber=1.0, max_iters=30)
    np.testing.assert_allclose(float(st["initial_cost"]),
                               float(sj["initial_cost"]), rtol=TOL)
    np.testing.assert_allclose(float(st["final_cost"]),
                               float(sj["final_cost"]), rtol=1e-2)
    assert float(st["final_cost"]) < 0.1 * float(st["initial_cost"])
    assert torch.isfinite(it).all()


# ---------------------------------------------------------------------------
# end to end through both drivers (port only, the JAX test's bars)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("driver", ["SlamSystem", "StreamingVO"])
@pytest.mark.parametrize("cam", CAMS)
def test_drivers_end_to_end(cam, driver):
    seq = world(cam)
    assert seq.calib.cam_types == [cam, cam]
    if driver == "SlamSystem":
        drv = SlamSystem(seq.calib, e2e_config(), device="cpu")
        for img_l, img_r in seq.images:
            drv.process_frame(img_l, img_r)
    else:
        drv = StreamingVO(seq.calib, e2e_config(), max_frames=32,
                          device="cpu")
        drv.run(seq.images)
    assert drv.cam_name == cam
    fids, est_pos, _ = drv.keyframe_trajectory()
    assert len(fids) >= 3
    rmse = ate.align_svd(est_pos, seq.poses[fids, :3])[2]
    assert rmse < 0.12, f"{cam}-model {driver} ATE {rmse:.3f} m"

