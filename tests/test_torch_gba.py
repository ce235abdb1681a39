"""The port's pose graph, blocked bundle adjustment and global BA against
the JAX package's, on the same seeded inputs on the CPU.

- ``solve_pose_graph`` on a random graph (a drifted chain with random
  covisibility edges, a loop edge, padding edges and fixed keyframes):
  poses within 1e-4, iteration count equal;
- ``solve_ba_blocked`` on a perturbed window of a short JAX ``StreamingVO``
  run's map: poses and points within 1e-4, iteration count equal;
- ``dispatch_global_ba`` + ``merge_global_ba``: the snapshot masks and the
  skip-merge equal exactly (the scenario of tests/test_gba_async.py at a
  small size), merged poses within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pose_graph import make_chain
from test_streaming import small_config
from vslam_tpu.pipeline import ba_global as jgba
from vslam_tpu.pipeline.streaming import StreamingVO as JaxStreamingVO
from vslam_tpu.solvers import ba_blocked as jbab
from vslam_tpu.solvers import pose_graph as jpg
from vslam_tpu_torch import interop, synthetic
from vslam_tpu_torch.core.state import KeyframeState, LandmarkState
from vslam_tpu_torch.pipeline import ba_global as tgba
from vslam_tpu_torch.solvers import ba_blocked as tbab
from vslam_tpu_torch.solvers import pose_graph as tpg


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


def random_graph(n, seed, extra_edges=6, pad=4):
    """make_chain's drifted circle plus random covisibility edges (noisy
    measurements of the true relative poses), invalid padding edges and
    two fixed keyframes."""
    from vslam_tpu.geometry import lie

    gt, poses0, (ei, ej, meas) = make_chain(n=n, drift=0.4)
    rng = np.random.RandomState(seed)
    ei, ej, meas = list(np.asarray(ei)), list(np.asarray(ej)), \
        list(np.asarray(meas))
    for _ in range(extra_edges):
        i, j = sorted(rng.choice(n, 2, replace=False))
        rel = lie.se3_log(lie.se3_mul(lie.se3_inv(gt[i]), gt[j]))
        ei.append(i)
        ej.append(j)
        meas.append(np.asarray(rel) + rng.normal(0, 0.01, 6))
    E = len(ei)
    ei += [0] * pad
    ej += [0] * pad
    meas += [np.zeros(6)] * pad
    fixed = np.zeros(n, bool)
    fixed[[0, n // 2]] = True
    return dict(poses=np.asarray(poses0, np.float32), fixed=fixed,
                edge_i=np.asarray(ei, np.int32),
                edge_j=np.asarray(ej, np.int32),
                edge_meas=np.asarray(meas, np.float32),
                edge_valid=np.arange(E + pad) < E)


@pytest.mark.parametrize("n,seed,huber", [(8, 0, 1.0), (12, 1, 0.1)])
def test_pose_graph_matches_jax(n, seed, huber):
    g = random_graph(n, seed)
    pj, sj = jpg.solve_pose_graph(
        jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in g.items()}),
        huber=huber, max_iters=20)
    pt, st = tpg.solve_pose_graph(
        tpg.PoseGraphProblem(**{k: tt(v) for k, v in g.items()}),
        huber=huber, max_iters=20)
    assert st["iterations"] == int(sj["iterations"]) > 1
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
    np.testing.assert_allclose(float(st["final_cost"]),
                               float(sj["final_cost"]), rtol=1e-3,
                               atol=1e-6)
    assert float(st["final_cost"]) < float(st["initial_cost"])
    # fixed keyframes do not move
    np.testing.assert_array_equal(pt.numpy()[g["fixed"]],
                                  g["poses"][g["fixed"]])


def gba_config():
    """tests/test_gba_async.py's configuration: a two-pair window, so old
    keyframes leave it while the map grows."""
    cfg = small_config()
    cfg.ba_max_iters = 8
    cfg.new_kf_min_inliers = 65
    cfg.quality_level = 0.001
    cfg.max_num_kfs = 2
    return cfg


def snapshot(st):
    """Host copies of the JAX driver's map (its step donates the state)."""
    return ({k: np.array(v) for k, v in st.kf._asdict().items()},
            {k: np.array(v) for k, v in st.lm._asdict().items()},
            np.array(st.intr0), np.array(st.intr1))


@pytest.fixture(scope="module")
def jax_maps():
    """The JAX StreamingVO's map after 12 frames (the GBA snapshot) and
    after 4 more (work that lands while the solve is in flight)."""
    seq = synthetic.generate(num_frames=16, num_points=500, seed=3)
    vo = JaxStreamingVO(seq.calib, gba_config(), max_frames=32)
    vo.run(seq.images[:12], sync_every=0)
    first = snapshot(vo.state)
    vo.run(seq.images[12:], sync_every=0)
    jax.block_until_ready(vo.state.frame)
    return first, snapshot(vo.state)


def jax_state(snap):
    from vslam_tpu.core.state import KeyframeState as JK, LandmarkState as JL

    kf, lm, i0, i1 = snap
    return (JK(**{k: jnp.asarray(v) for k, v in kf.items()}),
            JL(**{k: jnp.asarray(v) for k, v in lm.items()}),
            jnp.asarray(i0), jnp.asarray(i1))


def port_state(snap):
    kf, lm, i0, i1 = snap
    return (interop.from_arrays(KeyframeState, kf, "cpu"),
            interop.from_arrays(LandmarkState, lm, "cpu"), tt(i0), tt(i1))


def test_build_blocked_matches_jax(jax_maps):
    kj, lj, i0j, i1j = jax_state(jax_maps[0])
    kt, lt, i0t, i1t = port_state(jax_maps[0])
    K2 = jgba._pow2(int(kj.next_slot))
    Lw = jgba._pow2(int(lj.next_slot), lo=256)
    pj = jgba._build_blocked(kj, lj, i0j, i1j, K2=K2, Lw=Lw)
    pt = tgba._build_blocked(kt, lt, i0t, i1t, K2=K2, Lw=Lw)
    for name in ("poses", "pose_fixed", "intr", "points", "point_valid",
                 "obs_valid"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(pj, name)),
                                      err_msg=name)
    ov = np.asarray(pj.obs_valid)
    assert ov.sum() > 500
    np.testing.assert_array_equal(pt.obs_cam.numpy()[ov],
                                  np.asarray(pj.obs_cam)[ov])
    np.testing.assert_array_equal(pt.obs_uv.numpy()[ov],
                                  np.asarray(pj.obs_uv)[ov])


def test_solve_ba_blocked_matches_jax(jax_maps):
    """The blocked solver from the same perturbed global problem: poses and
    points within 1e-4, the same number of LM iterations."""
    kj, lj, i0j, i1j = jax_state(jax_maps[0])
    K2 = jgba._pow2(int(kj.next_slot))
    Lw = jgba._pow2(int(lj.next_slot), lo=256)
    pj = jgba._build_blocked(kj, lj, i0j, i1j, K2=K2, Lw=Lw)
    rng = np.random.RandomState(2)
    noise = rng.normal(0, 3e-3, np.asarray(pj.poses).shape)
    noise[:, 3:] = 0.0
    noise[np.asarray(pj.pose_fixed)] = 0.0
    pj = pj._replace(poses=pj.poses + noise.astype(np.float32))
    poses_j, points_j, sj = jbab.solve_ba_blocked(pj, cam_name="pinhole",
                                                  max_iters=10)
    pt = tbab.BlockProblem(**{k: tt(v) for k, v in pj._asdict().items()})
    poses_t, points_t, st = tbab.solve_ba_blocked(pt, cam_name="pinhole",
                                                  max_iters=10)
    assert st["iterations"] == int(sj["iterations"]) > 1
    assert float(st["final_cost"]) < float(st["initial_cost"])
    np.testing.assert_allclose(float(st["final_cost"]),
                               float(sj["final_cost"]), rtol=1e-3)
    np.testing.assert_allclose(poses_t.numpy(), np.asarray(poses_j),
                               atol=1e-4)
    valid = np.asarray(pj.point_valid)
    np.testing.assert_allclose(points_t.numpy()[valid],
                               np.asarray(points_j)[valid], atol=1e-4,
                               rtol=1e-4)


def test_gba_dispatch_and_skip_merge_match_jax(jax_maps):
    """Dispatch on the 12-frame map, merge into the 16-frame map: the
    snapshot, the skip masks and the entries kept are the reference's;
    the merged poses agree within 1e-4."""
    kj, lj, i0j, i1j = jax_state(jax_maps[0])
    kt, lt, i0t, i1t = port_state(jax_maps[0])
    pend_j = jgba.dispatch_global_ba(kj, lj, i0j, i1j, cam_name="pinhole",
                                     max_iters=8)
    pend_t = tgba.dispatch_global_ba(kt, lt, i0t, i1t, cam_name="pinhole",
                                     max_iters=8)
    assert pend_t.n_kf == int(pend_j.n_kf)
    assert pend_t.n_lm == int(pend_j.n_lm)
    np.testing.assert_array_equal(pend_t.snap_active_kf.numpy(),
                                  np.asarray(pend_j.snap_active_kf))
    np.testing.assert_array_equal(pend_t.snap_active_lm.numpy(),
                                  np.asarray(pend_j.snap_active_lm))
    np.testing.assert_allclose(pend_t.poses.numpy(), np.asarray(pend_j.poses),
                               atol=1e-4)

    kj2, lj2, _, _ = jax_state(jax_maps[1])
    kt2, lt2, _, _ = port_state(jax_maps[1])
    new_slots = np.arange(pend_t.n_kf, int(kt2.next_slot))
    assert len(new_slots), "no keyframe landed after the snapshot"
    mj_kf, mj_lm = jgba.merge_global_ba(kj2, lj2, pend_j)
    mt_kf, mt_lm = tgba.merge_global_ba(kt2, lt2, pend_t)

    before = np.asarray(kj2.pose_l)
    lbefore = np.asarray(lj2.pos)
    taken_j = np.any(np.asarray(mj_kf.pose_l) != before, axis=1)
    taken_t = np.any(mt_kf.pose_l.numpy() != before, axis=1)
    np.testing.assert_array_equal(taken_t, taken_j)
    assert taken_t.any(), "the merge took no keyframe"
    modified = (np.asarray(pend_j.snap_active_kf) | np.asarray(kj2.active))
    assert not (taken_t & modified).any()
    assert not taken_t[new_slots].any()
    ltaken_j = np.any(np.asarray(mj_lm.pos) != lbefore, axis=1)
    ltaken_t = np.any(mt_lm.pos.numpy() != lbefore, axis=1)
    np.testing.assert_array_equal(ltaken_t, ltaken_j)
    np.testing.assert_allclose(mt_kf.pose_l.numpy(), np.asarray(mj_kf.pose_l),
                               atol=1e-4)
    np.testing.assert_allclose(mt_kf.pose_r.numpy(), np.asarray(mj_kf.pose_r),
                               atol=1e-4)
    valid = np.asarray(lj2.valid)
    np.testing.assert_allclose(mt_lm.pos.numpy()[valid],
                               np.asarray(mj_lm.pos)[valid], atol=1e-3,
                               rtol=1e-4)
    np.testing.assert_allclose(mt_lm.pos_c.numpy()[valid],
                               np.asarray(mj_lm.pos_c)[valid], atol=1e-3,
                               rtol=1e-4)


def test_unported_global_ba_branches_raise(jax_maps, monkeypatch):
    """No branch of the global BA raises any more: a mesh shards the solve
    (the flat CG branch, whatever the map's size), ``gba_mesh`` falls back
    to the single-device solve where the process has too few devices, and
    a map above ``BLOCKED_MAX_PAIRS`` keyframe pairs (patched low here)
    takes the matrix-free branch."""
    from vslam_tpu_torch.parallel.mesh import make_mesh

    kt, lt, i0t, i1t = port_state(jax_maps[0])
    pending = tgba.dispatch_global_ba(
        kt, lt, i0t, i1t, cam_name="pinhole", max_iters=2, cg_iters=5,
        mesh=make_mesh(2, devices=["cpu", "cpu"]))
    assert pending.stats["cg_iterations"] == 5 * pending.stats["iterations"]
    cfg = gba_config()
    cfg.gba_mesh_devices = 64
    assert tgba.gba_mesh(cfg) is None
    monkeypatch.setattr(tgba, "BLOCKED_MAX_PAIRS", 2)
    kf2, lm2, stats = tgba.run_global_ba(kt, lt, i0t, i1t,
                                         cam_name="pinhole", max_iters=4,
                                         cg_iters=10)
    assert stats["cg_iterations"] == 10 * stats["iterations"] > 0
    assert float(stats["final_cost"]) <= float(stats["initial_cost"])
    assert bool(torch.isfinite(kf2.pose_l).all()
                & torch.isfinite(lm2.pos).all())
