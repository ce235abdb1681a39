"""The port's large-map solvers against the JAX package's, on the same
numpy-seeded inputs on the CPU, at a small size.

- ``synthetic.make_big_problem`` / ``make_ring_graph`` (the port's numpy
  generators) give tests/test_ba_scale.py's and tests/test_pose_graph.py's
  problems: index arrays equal, floats within 1e-4 (pixels within 2e-3);
- ``solve_ba_cg`` (and ``solve_ba_cg_stepped``, the same function in the
  port) on a small orbit problem: costs within 1e-3 relative of the JAX
  solver's after the same iterations, poses within 1e-3, fixed cameras and
  invalid points untouched;
- ``solve_pose_graph_cg`` against the JAX one (poses within 1e-3, the cost
  history within 1e-3 relative + 1e-6) and against the port's dense solver
  (tests/test_pose_graph.py::test_pose_graph_cg_matches_dense's bars);
- the flat global-BA build (``ba_global._build``) field by field against
  JAX on one keyframe / landmark state, with and without the observation
  cap biting, and ``run_global_ba`` / ``dispatch_global_ba`` through the
  matrix-free branch with ``BLOCKED_MAX_PAIRS`` patched low in both
  packages: costs within 1e-3 relative, poses within 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ba_scale import make_big_problem as jax_big_problem
from test_pose_graph import make_chain
from vslam_tpu.core import state as jstate
from vslam_tpu.pipeline import ba_global as jgba
from vslam_tpu.solvers import ba as jba
from vslam_tpu.solvers import ba_cg as jba_cg
from vslam_tpu.solvers import pose_graph as jpg
from vslam_tpu.solvers import pose_graph_cg as jpg_cg
from vslam_tpu_torch import interop, synthetic
from vslam_tpu_torch.core.state import KeyframeState, LandmarkState
from vslam_tpu_torch.pipeline import ba_global as tgba
from vslam_tpu_torch.solvers import ba as tba
from vslam_tpu_torch.solvers import ba_cg as tba_cg
from vslam_tpu_torch.solvers import pose_graph as tpg
from vslam_tpu_torch.solvers import pose_graph_cg as tpg_cg


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tests run in parallel workers, and small
    tensors gain nothing from more (oversubscribed, they lose much)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tt(x):
    return torch.as_tensor(np.array(x))


SMALL = dict(n_pairs=24, pts_per_kf=6, obs_per_pt=8)


def test_big_problem_generator_matches_jax_test():
    pj, poses_gt_j, points_gt_j = jax_big_problem(**SMALL)
    pt, poses_gt_t, points_gt_t = synthetic.make_big_problem(**SMALL)
    np.testing.assert_array_equal(poses_gt_t, poses_gt_j)
    np.testing.assert_array_equal(points_gt_t, points_gt_j)
    for name in ("obs_cam", "obs_point", "pose_fixed", "point_valid"):
        np.testing.assert_array_equal(pt[name], np.asarray(getattr(pj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(pt["poses"], np.asarray(pj.poses), atol=1e-5)
    np.testing.assert_allclose(pt["points"], np.asarray(pj.points),
                               atol=1e-5)
    np.testing.assert_array_equal(pt["intr"], np.asarray(pj.intr))
    # the port also drops observations behind the camera (a pinhole
    # projects them into the image); in front of it the masks agree
    vj, vt = np.asarray(pj.obs_valid), pt["obs_valid"]
    assert not (vt & ~vj).any()
    assert vt.sum() > 0.2 * len(vt)
    np.testing.assert_allclose(pt["obs_uv"][vt], np.asarray(pj.obs_uv)[vt],
                               atol=2e-3)
    assert set(pt) == set(pj._fields)


def test_ring_graph_matches_make_chain():
    gt_j, poses_j, (ei, ej, meas) = make_chain(n=8, drift=0.4)
    gt_t, poses_t, ei_t, ej_t, meas_t = synthetic.make_ring_graph(8, 0.4)
    np.testing.assert_allclose(gt_t, np.asarray(gt_j), atol=1e-6)
    np.testing.assert_allclose(poses_t, np.asarray(poses_j), atol=1e-5)
    np.testing.assert_array_equal(ei_t, np.asarray(ei))
    np.testing.assert_array_equal(ej_t, np.asarray(ej))
    np.testing.assert_allclose(meas_t, np.asarray(meas), atol=1e-5)


def orbit_problem():
    arrays, poses_gt, _ = synthetic.make_big_problem(**SMALL)
    arrays = {k: np.array(v) for k, v in arrays.items()}
    # exercise the masks: a second fixed pair, some invalid points
    arrays["pose_fixed"][10:12] = True
    arrays["point_valid"][::7] = False
    return arrays, poses_gt


@pytest.mark.parametrize("huber", [2.0, 0.5])
def test_solve_ba_cg_matches_jax(huber):
    arrays, poses_gt = orbit_problem()
    pj = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
    pt = interop.from_arrays(tba.BAProblem, arrays, "cpu")
    kw = dict(cam_name="pinhole", huber=huber, max_iters=4, cg_iters=10)
    poses_j, points_j, sj = jba_cg.solve_ba_cg(pj, **kw)
    poses_t, points_t, st = tba_cg.solve_ba_cg(pt, **kw)
    assert st["iterations"] == int(sj["iterations"]) >= 1
    assert st["cg_iterations"] == 10 * st["iterations"]
    np.testing.assert_allclose(float(st["initial_cost"]),
                               float(sj["initial_cost"]), rtol=1e-3)
    np.testing.assert_allclose(float(st["final_cost"]),
                               float(sj["final_cost"]), rtol=1e-3)
    assert float(st["final_cost"]) < 0.5 * float(st["initial_cost"])
    np.testing.assert_allclose(poses_t.numpy(), np.asarray(poses_j),
                               atol=1e-3)
    pv = arrays["point_valid"]
    np.testing.assert_allclose(points_t.numpy()[pv],
                               np.asarray(points_j)[pv], atol=2e-3)
    # the masks: fixed cameras and invalid points keep their values
    np.testing.assert_array_equal(poses_t.numpy()[arrays["pose_fixed"]],
                                  arrays["poses"][arrays["pose_fixed"]])
    np.testing.assert_array_equal(points_t.numpy()[~pv],
                                  arrays["points"][~pv])
    assert bool(torch.isfinite(poses_t).all() & torch.isfinite(points_t).all())
    err0 = np.linalg.norm(arrays["poses"][:, :3] - poses_gt[:, :3],
                          axis=1).mean()
    err1 = np.linalg.norm(poses_t.numpy()[:, :3] - poses_gt[:, :3],
                          axis=1).mean()
    assert err1 < err0


def test_solve_ba_cg_stepped_is_the_same_solve():
    arrays, _ = orbit_problem()
    pj = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
    pt = interop.from_arrays(tba.BAProblem, arrays, "cpu")
    kw = dict(cam_name="pinhole", huber=2.0, max_iters=2, cg_iters=6)
    poses_j, _, sj = jba_cg.solve_ba_cg_stepped(pj, **kw)
    poses_t, _, st = tba_cg.solve_ba_cg_stepped(pt, **kw)
    np.testing.assert_allclose(float(st["final_cost"]),
                               float(sj["final_cost"]), rtol=1e-3)
    np.testing.assert_allclose(poses_t.numpy(), np.asarray(poses_j),
                               atol=1e-3)


def ring_problem(n, drift, fixed=(0,)):
    _, poses0, ei, ej, meas = synthetic.make_ring_graph(n, drift)
    fx = np.zeros(n, bool)
    fx[list(fixed)] = True
    # two padding edges, invalid
    return dict(poses=poses0, fixed=fx,
                edge_i=np.concatenate([ei, [0, 0]]).astype(np.int32),
                edge_j=np.concatenate([ej, [0, 0]]).astype(np.int32),
                edge_meas=np.concatenate([meas, np.zeros((2, 6), np.float32)]),
                edge_valid=np.arange(n + 2) < n)


@pytest.mark.parametrize("n,huber,fixed", [(8, 1.0, (0,)),
                                           (12, 0.05, (0, 6))])
def test_pose_graph_cg_matches_jax_and_dense(n, huber, fixed):
    g = ring_problem(n, 0.4, fixed)
    pj = jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in g.items()})
    pt = tpg.PoseGraphProblem(**{k: tt(v) for k, v in g.items()})
    cg_j, sj = jpg_cg.solve_pose_graph_cg(pj, huber=huber, max_iters=25,
                                          cg_iters=40)
    cg_t, st = tpg_cg.solve_pose_graph_cg(pt, huber=huber, max_iters=25,
                                          cg_iters=40)
    np.testing.assert_allclose(cg_t.numpy(), np.asarray(cg_j), atol=1e-3)
    np.testing.assert_allclose(st["history"].numpy(),
                               np.asarray(sj["history"]), rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(float(st["final_cost"]),
                               float(sj["final_cost"]), rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(cg_t.numpy()[g["fixed"]],
                                  g["poses"][g["fixed"]])
    # the JAX test's bars against the dense solver
    dense, sd = tpg.solve_pose_graph(pt, huber=huber, max_iters=25)
    if len(fixed) == 1:     # a second fixed keyframe holds the drift in
        assert float(st["final_cost"]) < 0.2 * float(st["initial_cost"])
    assert float(st["final_cost"]) < float(st["initial_cost"])
    assert float(st["final_cost"]) < 1.5 * float(sd["final_cost"]) + 1e-3
    np.testing.assert_allclose(cg_t.numpy()[:, :3], dense.numpy()[:, :3],
                               atol=0.05)


# ---------------------------------------------------------------------------
# the global BA above the blocked solver's limit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def orbit_state():
    """A 20-keyframe orbit map in both packages' state types: capacity
    above the live counts, one dead keyframe, a few dead landmarks."""
    kfa, lma, gt = synthetic.make_orbit_state(
        n_pairs=20, pts_per_kf=6, obs_per_pt=8, capacity_kf=24,
        capacity_lm=160)
    kfa["valid"][7] = False
    lma["valid"][::11] = False
    intr = synthetic.ORBIT_PINHOLE
    kj = jstate.KeyframeState(**{k: jnp.asarray(v) for k, v in kfa.items()})
    lj = jstate.LandmarkState(**{k: jnp.asarray(v) for k, v in lma.items()})
    kt = interop.from_arrays(KeyframeState, kfa, "cpu")
    lt = interop.from_arrays(LandmarkState, lma, "cpu")
    return (kj, lj, jnp.asarray(intr)), (kt, lt, tt(intr)), gt


@pytest.mark.parametrize("O", [1024, 256])
def test_flat_build_matches_jax(orbit_state, O):
    """O = 1024 holds every observation; O = 256 cuts the list (the lowest
    landmark rows stay, as in the reference)."""
    (kj, lj, ij), (kt, lt, it), _ = orbit_state
    K2, Lw = 32, 256
    pj = jgba._build(kj, lj, ij, ij, K2=K2, Lw=Lw, O=O)
    pt = tgba._build(kt, lt, it, it, K2=K2, Lw=Lw, O=O)
    for name in ("poses", "pose_fixed", "intr", "points", "point_valid",
                 "obs_valid"):
        got, want = getattr(pt, name).numpy(), np.asarray(getattr(pj, name))
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    ov = np.asarray(pj.obs_valid)
    assert ov.sum() == (O if O == 256 else ov.sum()) > 200
    for name in ("obs_cam", "obs_point", "obs_uv"):
        got, want = getattr(pt, name).numpy(), np.asarray(getattr(pj, name))
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got[ov], want[ov], err_msg=name)
    # gauge and dead rows are fixed, dead landmarks invalid
    fixed = pt.pose_fixed.numpy().reshape(K2, 2)
    assert fixed[0].all() and fixed[7].all() and fixed[20:].all()
    assert not fixed[1:7].any()
    assert not pt.point_valid.numpy()[::11][:10].any()


def test_global_ba_cg_branch_matches_jax(orbit_state, monkeypatch):
    (kj, lj, ij), (kt, lt, it), gt = orbit_state
    monkeypatch.setattr(jgba, "BLOCKED_MAX_PAIRS", 16)
    monkeypatch.setattr(tgba, "BLOCKED_MAX_PAIRS", 16)
    kw = dict(cam_name="pinhole", huber=2.0, max_iters=4, cg_iters=10)
    kj2, lj2, sj = jgba.run_global_ba(kj, lj, ij, ij, **kw)
    kt2, lt2, st = tgba.run_global_ba(kt, lt, it, it, **kw)
    assert st["cg_iterations"] == 10 * st["iterations"]   # the CG branch
    assert st["iterations"] == int(sj["iterations"])
    np.testing.assert_allclose(float(st["initial_cost"]),
                               float(sj["initial_cost"]), rtol=1e-3)
    np.testing.assert_allclose(float(st["final_cost"]),
                               float(sj["final_cost"]), rtol=1e-3)
    assert float(st["final_cost"]) < 0.5 * float(st["initial_cost"])
    np.testing.assert_allclose(kt2.pose_l.numpy(), np.asarray(kj2.pose_l),
                               atol=1e-3)
    np.testing.assert_allclose(kt2.pose_r.numpy(), np.asarray(kj2.pose_r),
                               atol=1e-3)
    valid = lt.valid.numpy()
    np.testing.assert_allclose(lt2.pos.numpy()[valid],
                               np.asarray(lj2.pos)[valid], atol=2e-3)
    np.testing.assert_allclose(lt2.pos_c.numpy()[valid],
                               np.asarray(lj2.pos_c)[valid], atol=2e-3)
    # the gauge pair, the dead keyframe and the rows past the map stay
    for slot in (0, 7, 21, 23):
        np.testing.assert_array_equal(kt2.pose_l.numpy()[slot],
                                      kt.pose_l.numpy()[slot])
    live = np.r_[1:7, 8:20]
    err0 = np.linalg.norm(kt.pose_l.numpy()[live, :3] - gt[live, 0, :3],
                          axis=1).mean()
    err1 = np.linalg.norm(kt2.pose_l.numpy()[live, :3] - gt[live, 0, :3],
                          axis=1).mean()
    assert err1 < err0


def test_dispatch_global_ba_cg_branch_matches_jax(orbit_state, monkeypatch):
    (kj, lj, ij), (kt, lt, it), _ = orbit_state
    monkeypatch.setattr(jgba, "BLOCKED_MAX_PAIRS", 16)
    monkeypatch.setattr(tgba, "BLOCKED_MAX_PAIRS", 16)
    kw = dict(cam_name="pinhole", huber=2.0, max_iters=3, cg_iters=8)
    pend_j = jgba.dispatch_global_ba(kj, lj, ij, ij, **kw)
    pend_t = tgba.dispatch_global_ba(kt, lt, it, it, **kw)
    assert pend_t.stats["cg_iterations"] == 8 * pend_t.stats["iterations"]
    assert pend_t.n_kf == int(pend_j.n_kf) == 20
    np.testing.assert_allclose(pend_t.poses.numpy(), np.asarray(pend_j.poses),
                               atol=1e-3)
    mj_kf, _ = jgba.merge_global_ba(kj, lj, pend_j)
    mt_kf, _ = tgba.merge_global_ba(kt, lt, pend_t)
    np.testing.assert_allclose(mt_kf.pose_l.numpy(), np.asarray(mj_kf.pose_l),
                               atol=1e-3)
