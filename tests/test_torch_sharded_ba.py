"""The port's mesh, its sharded global BA and the mesh setting of the
global-BA entry points, against the unsharded solve and the JAX package,
on the CPU (a CPU mesh lists the CPU several times: n shards on one
device).

The problem is tests/test_multichip.py's (K=6 cameras, L=48 points, O=128
observations, pinhole), made from a numpy seed and handed to both
packages. Tolerances: sharded against unsharded ``atol=5e-3`` on poses, as
the JAX test states it (the shards' partial sums are added in another
order and 20 unconverged CG iterations amplify the difference), and 1e-2
on points: with this seed's observations the depth of a point 6 m away,
seen over a 1 m baseline, moves by 6-8 mm between any two of the runs,
the JAX solver's included. The port against the JAX ``solve_ba_cg`` gets
the same two tolerances (its products go through per-observation blocks
where the JAX solver differentiates the residual function)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gba import gba_config, jax_maps, port_state  # noqa: F401
from vslam_tpu.solvers import ba as jba
from vslam_tpu.solvers import ba_cg as jcg
from vslam_tpu_torch import interop
from vslam_tpu_torch.parallel import sharded_ba
from vslam_tpu_torch.parallel.mesh import Mesh, available_devices, make_mesh
from vslam_tpu_torch.pipeline import ba_global as tgba
from vslam_tpu_torch.solvers import ba as tba
from vslam_tpu_torch.solvers import ba_cg as tcg

K, L, O = 6, 48, 128


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tests run in parallel workers, and small
    tensors gain nothing from more (oversubscribed, they lose much)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def problem_arrays(seed=7):
    rng = np.random.RandomState(seed)
    points = rng.uniform(-2, 2, (L, 3)) + np.array([0.0, 0.0, 6.0])
    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (K, 1))
    poses[:, 0] = np.linspace(0, 1.0, K)
    obs_cam = rng.randint(0, K, O)
    obs_point = rng.randint(0, L, O)
    intr = np.array([110.0, 110, 64, 48, 0, 0, 0, 0])
    pc = points[obs_point] - poses[obs_cam, :3]      # identity rotations
    uv = np.stack([intr[0] * pc[:, 0] / pc[:, 2] + intr[2],
                   intr[1] * pc[:, 1] / pc[:, 2] + intr[3]], 1)
    return dict(
        poses=poses.astype(np.float32), pose_fixed=np.arange(K) < 2,
        intr=np.tile(intr, (K, 1)).astype(np.float32),
        points=(points + 0.02 * rng.normal(size=(L, 3))).astype(np.float32),
        point_valid=np.ones(L, bool), obs_cam=obs_cam.astype(np.int32),
        obs_point=obs_point.astype(np.int32), obs_uv=uv.astype(np.float32),
        obs_valid=np.ones(O, bool))


@pytest.fixture(scope="module")
def unsharded():
    prob = interop.from_arrays(tba.BAProblem, problem_arrays(), "cpu")
    return prob, tcg.solve_ba_cg(prob, cam_name="pinhole", max_iters=6,
                                 cg_iters=20)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_ba_matches_single_device(unsharded, shards):
    prob, (p1, x1, s1) = unsharded
    mesh = make_mesh(shards, devices=["cpu"] * shards)
    parts = sharded_ba.shard_problem(prob, mesh)
    assert len(parts) == shards
    assert sum(int(p.obs_cam.shape[0]) for p in parts) == O
    assert torch.equal(torch.cat([p.obs_uv for p in parts]), prob.obs_uv)
    assert all(torch.equal(p.points, prob.points) for p in parts)
    p2, x2, s2 = sharded_ba.solve_sharded(prob, mesh, cam_name="pinhole",
                                          max_iters=6, cg_iters=20)
    np.testing.assert_allclose(p2.numpy(), p1.numpy(), atol=5e-3)
    np.testing.assert_allclose(x2.numpy(), x1.numpy(), atol=1e-2)
    # both end far below the start
    assert float(s2["final_cost"]) < float(s2["initial_cost"]) * 0.05
    assert torch.equal(s2["initial_cost"], s1["initial_cost"]) or abs(
        float(s2["initial_cost"]) / float(s1["initial_cost"]) - 1) < 1e-5
    assert s2["iterations"] == s1["iterations"]
    assert float(s1["final_cost"]) < float(s1["initial_cost"]) * 0.9


def test_unsharded_solve_is_the_one_shard_case(unsharded):
    """A list of one problem runs the same loop: bit-equal results."""
    prob, (p1, x1, s1) = unsharded
    p2, x2, s2 = tcg.solve_ba_cg([prob], cam_name="pinhole", max_iters=6,
                                 cg_iters=20)
    assert torch.equal(p1, p2) and torch.equal(x1, x2)
    assert torch.equal(s1["final_cost"], s2["final_cost"])


def test_sharded_ba_matches_jax(unsharded):
    arrays = problem_arrays()
    pj, xj, sj = jcg.solve_ba_cg(
        jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        cam_name="pinhole", max_iters=6, cg_iters=20)
    prob, _ = unsharded
    p2, x2, s2 = sharded_ba.solve_sharded(
        prob, make_mesh(4, devices=["cpu"] * 4), cam_name="pinhole",
        max_iters=6, cg_iters=20)
    np.testing.assert_allclose(float(s2["initial_cost"]),
                               float(sj["initial_cost"]), rtol=1e-4)
    np.testing.assert_allclose(p2.numpy(), np.asarray(pj), atol=5e-3)
    np.testing.assert_allclose(x2.numpy(), np.asarray(xj), atol=1e-2)
    assert float(s2["final_cost"]) < float(s2["initial_cost"]) * 0.9


@pytest.mark.parametrize("n,axes,shape", [
    (1, ("data",), {"data": 1}), (8, ("data",), {"data": 8}),
    (8, ("data", "model"), {"data": 4, "model": 2}),
    (6, ("data", "model"), {"data": 3, "model": 2}),
    (3, ("data", "model"), {"data": 3, "model": 1}),
    (2, ("data", "model"), {"data": 2, "model": 1})])
def test_make_mesh_shapes(n, axes, shape):
    """The reference's shape rule (vslam_tpu/parallel/mesh.py:22-29)."""
    mesh = make_mesh(n, axes=axes, devices=["cpu"] * n)
    assert isinstance(mesh, Mesh) and mesh.shape == shape and mesh.size == n
    assert mesh.axis_devices("data") == [torch.device("cpu")] * shape["data"]


def test_make_mesh_defaults_and_errors():
    devs = available_devices()
    assert devs and all(isinstance(d, torch.device) for d in devs)
    assert make_mesh().size == len(devs)
    # more devices asked for than there are: the first ones, as the
    # reference's ``devices[:n]``
    assert make_mesh(len(devs) + 3).size == len(devs)
    with pytest.raises(ValueError, match="unsupported axes"):
        make_mesh(2, axes=("a", "b", "c"), devices=["cpu"] * 2)


@pytest.mark.parametrize("n", [0, 1, 64])
def test_gba_mesh_falls_back_to_single_device(n):
    """``gba_mesh`` is None when sharding is off (0, 1) and when the
    process has fewer devices than asked for: the reference's documented
    fall-back to the single-device solve (vslam_tpu/config.py:122-128)."""
    cfg = gba_config()
    cfg.gba_mesh_devices = n
    assert tgba.gba_mesh(cfg) is None


def test_gba_mesh_with_enough_devices(monkeypatch):
    from vslam_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "available_devices",
                        lambda: [torch.device("cpu")] * 4)
    cfg = gba_config()
    cfg.gba_mesh_devices = 4
    mesh = tgba.gba_mesh(cfg)
    assert mesh.shape == {"data": 4}
    cfg.gba_mesh_devices = 8
    assert tgba.gba_mesh(cfg) is None


def test_run_global_ba_with_mesh_takes_cg_branch(jax_maps):  # noqa: F811
    """With a mesh the global BA always solves with the flat CG solver (the
    map here is small enough for the blocked one) and matches the same
    solve unsharded: poses 5e-3, points 5e-3, as above."""
    mesh = make_mesh(2, devices=["cpu"] * 2)
    kt, lt, i0t, i1t = port_state(jax_maps[0])
    kf2, lm2, stats = tgba.run_global_ba(kt, lt, i0t, i1t,
                                         cam_name="pinhole", max_iters=4,
                                         cg_iters=10, mesh=mesh)
    assert stats["cg_iterations"] == 10 * stats["iterations"] > 0
    kt, lt, i0t, i1t = port_state(jax_maps[0])
    n_kf, n_lm, K2, Lw = tgba._problem_size(kt, lt)
    assert K2 <= tgba.BLOCKED_MAX_PAIRS
    prob = tgba._build(kt, lt, i0t, i1t, K2=K2, Lw=Lw,
                       O=tgba._pow2(min(n_lm * 6, Lw * lt.all_kf.shape[1]),
                                    lo=1024))
    poses, points, s1 = tcg.solve_ba_cg(prob, cam_name="pinhole",
                                        max_iters=4, cg_iters=10)
    np.testing.assert_allclose(float(stats["final_cost"]),
                               float(s1["final_cost"]), rtol=1e-2)
    n = int(kt.next_slot)
    np.testing.assert_allclose(kf2.pose_l[:n].numpy(),
                               poses.reshape(K2, 2, 7)[:n, 0].numpy(),
                               atol=5e-3)
    pending = tgba.dispatch_global_ba(kt, lt, i0t, i1t, cam_name="pinhole",
                                      max_iters=4, cg_iters=10, mesh=mesh)
    assert "cg_iterations" in pending.stats
    assert pending.poses.device == kt.pose_l.device
