"""The port's driver entry points (``vslam_tpu_torch/entry.py``) against
``__graft_entry__.py``, on the CPU at the reference's own shapes.

Each program runs in both packages on the same arrays (the JAX draws
carried across with ``interop.from_arrays``, the RANSAC draws injected).
Tolerances: features, matches, candidates and counts are integer work or
elementwise float32 and must be equal; poses within 1e-4 (the PnP's sums
add in another order); the sharded BA's costs within 1e-3 relative (LM-CG
in float32, the shards' partial sums in another order); the training
step's loss within 1e-4 relative and its gradients within 1e-3 of each
tensor's largest (float32 convolutions in other algorithms). The split
training step against the unsplit one on the same weights: the loss
within 1e-6 relative, each gradient within 1e-5 of its tensor's largest
(float32 sums over thousands of terms, blocked otherwise for channel
slices and batch shards), the weights after the Adam step within 1e-6
where the gradient exceeds 1e-5 (Adam's first step moves a weight by
about the learning rate whatever its gradient's size, so a gradient near
Adam's eps of 1e-8 moves its weight by an amount its last bits decide)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from vslam_tpu.models import superpoint as jsp
from vslam_tpu.parallel import multiseq as jmultiseq
from vslam_tpu.parallel import sharded_ba as jsharded
from vslam_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vslam_tpu.solvers import pnp as jpnp
from vslam_tpu.solvers.ba import BAProblem as JaxBAProblem
from vslam_tpu_torch import entry, interop
from vslam_tpu_torch.core.state import LandmarkState
from vslam_tpu_torch.models import superpoint as tsp
from vslam_tpu_torch.parallel.mesh import make_mesh
from vslam_tpu_torch.solvers.ba import BAProblem

from test_torch_streaming import assert_same


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def host(tree):
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.as_tensor(np.array(x))


def port_lm(jlm):
    return interop.from_arrays(LandmarkState, host(jlm)._asdict(), "cpu")


def assert_tracking_equal(res, res_j):
    """Features, matches, candidates and counts equal; pose within 1e-4."""
    assert_same(res.feats, res_j.feats)
    for name in ("match_lm", "had_candidate", "num_matches", "pnp_ok"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(res_j, name)),
                                      err_msg=name)
    np.testing.assert_allclose(res.T_w_c.numpy(), np.asarray(res_j.T_w_c),
                               atol=1e-4)
    assert np.isfinite(res.T_w_c.numpy()).all()


def test_entry_matches_jax():
    """``entry()``'s step on the JAX ``entry()``'s image and landmark
    table, with its draws; the port's arguments have the reference's
    shapes, dtypes and intrinsics, and ``_lm_state`` builds the JAX table
    from its arrays."""
    fn_j, args_j = jentry.entry()
    key, img, lm_j, pose, _, _, intr = args_j
    res_j = jax.jit(fn_j)(*args_j)
    fn, args = entry.entry("cpu")
    img_t, lm_t, pose_t, _, _, intr_t = args
    assert img_t.shape == img.shape and img_t.dtype == torch.uint8
    np.testing.assert_array_equal(intr_t.numpy(), np.asarray(intr))
    np.testing.assert_array_equal(pose_t.numpy(), np.asarray(pose))
    lm = port_lm(lm_j)
    for name, value in host(lm_j)._asdict().items():
        assert tuple(getattr(lm_t, name).shape) == value.shape, name
    assert_same(entry._lm_state(t(lm_j.pos), t(lm_j.bank_bits)), lm_j)
    idx = jpnp._sample_minimal(key, res_j.match_lm >= 0, 64, 6)
    res = fn(t(img), lm, t(pose), t(pose), t(pose), t(intr),
             sample_idx=t(idx))
    assert_tracking_equal(res, res_j)
    assert int(res.had_candidate.sum()) > 10
    # the bound generator draws the same without injection, run to run
    again = entry.entry("cpu")
    assert torch.equal(fn(*args).T_w_c, again[0](*again[1]).T_w_c)


def test_dryrun_multiseq_matches_jax():
    """The dryrun's batched tracking at S=2 on the JAX dryrun's arrays,
    with one intrinsics row per sequence (two different cameras), over a
    2-entry mesh in both packages."""
    S, H, W = 2, 240, 320
    run = jmultiseq.batched_track_frame(
        jax_make_mesh(S), "pinhole", num_features=400, inview_cap=512,
        width=W, height=H, num_hypotheses=64)
    keys = jax.random.split(jax.random.PRNGKey(1), S)
    imgs = jax.random.randint(jax.random.PRNGKey(2), (S, H, W), 0, 255
                              ).astype(jnp.uint8)
    lm = jax.tree.map(lambda x: jnp.stack([x] * S),
                      jentry._small_lm_state(L=1024))
    pose = jnp.tile(jnp.asarray([0.0, 0, 0, 0, 0, 0, 1]), (S, 1))
    intr = jnp.asarray([[240.0, 240.0, W / 2, H / 2, 0, 0, 0, 0],
                        [250.0, 245.0, W / 2 + 3, H / 2 - 2, 0, 0, 0, 0]])
    res_j = run(keys, imgs, lm, pose, pose, pose, intr)
    idx = np.stack([np.asarray(jpnp._sample_minimal(
        keys[s], res_j.match_lm[s] >= 0, 64, 6)) for s in range(S)])
    res = entry.multiseq_step(
        make_mesh(S, devices=["cpu"] * S),
        inputs=(t(imgs), port_lm(lm), t(pose), t(intr)), sample_idx=t(idx))
    assert_tracking_equal(res, res_j)
    assert int(res.had_candidate.sum()) > 100
    # the cameras differ, so the two sequences' gates do too
    assert not torch.equal(res.had_candidate[0], res.had_candidate[1])


@pytest.mark.parametrize("step,intr,lo,hi", [
    (entry.DRYRUN_STEP, [240.0, 240.0, 160, 120], [-2, -2, 3], [2, 2, 7]),
    (entry.FULL_WIDTH_STEP, [380.0, 380, 376, 240], [-4, -4, 2],
     [4, 4, 10])])
def test_multiseq_inputs_have_the_reference_sizes(step, intr, lo, hi):
    """The dryrun's inputs are ``__graft_entry__._dryrun_multiseq``'s, the
    full-width ones ``tests/test_multichip_scale.py``'s EuRoC-scale step's:
    their shapes, intrinsics and landmark box."""
    S = 2
    imgs, lm, pose, intr0 = entry.multiseq_inputs(S, step, device="cpu")
    assert imgs.shape == (S, step.H, step.W) and imgs.dtype == torch.uint8
    assert lm.pos.shape == (S, step.L, 3)
    assert lm.bank_bits.shape == (S, step.L, 2, 256)
    assert bool(lm.valid.all() and lm.bank_valid.all())
    for k in range(3):
        assert lo[k] <= float(lm.pos[..., k].min())
        assert float(lm.pos[..., k].max()) <= hi[k]
    np.testing.assert_array_equal(pose.numpy(), [[0, 0, 0, 0, 0, 0, 1]] * S)
    np.testing.assert_array_equal(intr0.numpy(),
                                  [intr + [0, 0, 0, 0]] * S)


def jax_ba_problem(n):
    """``__graft_entry__._dryrun_sharded_ba``'s problem."""
    from vslam_tpu.geometry import cameras, lie

    intr = jentry._intr()
    K, L = 128, 2048
    O = max(n * 1024, 8192)
    ks = jax.random.split(jax.random.PRNGKey(3), 4)
    points = jax.random.uniform(ks[0], (L, 3), minval=-2, maxval=2) + \
        jnp.array([0.0, 0.0, 6.0])
    poses = jnp.tile(lie.identity_pose(), (K, 1))
    poses = poses.at[:, 0].set(jnp.linspace(0, 1.0, K))
    obs_cam = jax.random.randint(ks[1], (O,), 0, K)
    obs_point = jax.random.randint(ks[2], (O,), 0, L)
    pc = jax.vmap(lambda c, p: lie.se3_apply(lie.se3_inv(poses[c]),
                                             points[p]))(obs_cam, obs_point)
    return JaxBAProblem(
        poses=poses, pose_fixed=jnp.arange(K) < 2,
        intr=jnp.tile(intr, (K, 1)),
        points=points + 0.01 * jax.random.normal(ks[3], (L, 3)),
        point_valid=jnp.ones((L,), bool), obs_cam=obs_cam,
        obs_point=obs_point, obs_uv=cameras.project("pinhole", intr, pc),
        obs_valid=jnp.ones((O,), bool))


def test_dryrun_sharded_ba_matches_jax():
    """The dryrun's sharded solve on the JAX dryrun's problem over two
    shards in both packages: the same initial and final cost; the port's
    own problem has the same sizes and falls as far."""
    n = 2
    prob_j = jax_ba_problem(n)
    _, _, stats_j = jsharded.solve_sharded(
        prob_j, jax_make_mesh(n), cam_name="pinhole", max_iters=2,
        cg_iters=5)
    prob = interop.from_arrays(BAProblem, host(prob_j)._asdict(), "cpu")
    mesh = make_mesh(n, devices=["cpu"] * n)
    stats = entry._dryrun_sharded_ba(mesh, n, prob)
    for name in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(stats[name]),
                                   float(stats_j[name]), rtol=1e-3,
                                   err_msg=name)
    assert float(stats["final_cost"]) < 0.9 * float(stats["initial_cost"])
    own = entry._ba_problem(n, device="cpu")
    for name, value in host(prob_j)._asdict().items():
        assert tuple(getattr(own, name).shape) == value.shape, name
    stats_own = entry._dryrun_sharded_ba(mesh, n, own)
    assert float(stats_own["final_cost"]) < 0.9 * float(
        stats_own["initial_cost"])


def jax_train_inputs(n_data):
    """The JAX dryrun's model, weights and batch (keys 4 and 5)."""
    model = jsp.SuperPointTPU(dim=64, width=16)
    batch = jsp.synthetic_batch(jax.random.PRNGKey(4), batch=n_data, h=32,
                                w=32, m=8)
    return (model, jax.jit(model.init)(jax.random.PRNGKey(5), batch["img_a"]),
            batch)


def port_model(params):
    return tsp.from_flax_params(tsp.SuperPointTPU(dim=64, width=16), params)


def test_dryrun_train_step_matches_jax_and_the_unsplit_step():
    """One step on a (data, model) mesh of 4 CPU entries, on the JAX
    dryrun's weights and batch: the loss and gradients of the JAX step;
    and the split step equals the port's unsplit step (loss, gradients,
    the weights after the Adam update)."""
    model_j, params, batch_j = jax_train_inputs(2)

    def loss_fn(p, bt):   # jsp.make_train_step's loss
        la, da = model_j.apply(p, bt["img_a"])
        lb, db = model_j.apply(p, bt["img_b"])
        return (jsp.detector_loss(la, bt["heat_a"])
                + jsp.detector_loss(lb, bt["heat_b"])
                + jsp.descriptor_loss(da, db, bt["uv_a"], bt["uv_b"],
                                      bt["valid"]))

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params, batch_j)

    batch = {k: t(v) for k, v in batch_j.items()}
    assert entry._train_mesh(4, torch.device("cpu")).shape == {
        "data": 2, "model": 2}
    loss, split = entry._dryrun_train_step(4, "cpu",
                                           model=port_model(params),
                                           batch=batch)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    names = [(f"ConvBlock_{b}", f"Conv_{c}") for b in range(4)
             for c in range(2)] + [(f"Conv_{h}",) for h in range(4)]
    for conv, path in zip(split.convs(), names):
        leaf = grads_j["params"]
        for key in path:
            leaf = leaf[key]
        for got, want in (
                (conv.weight.grad.numpy(),
                 np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1)),
                (conv.bias.grad.numpy(), np.asarray(leaf["bias"]))):
            scale = max(np.abs(want).max(), 1e-12)
            assert np.abs(got - want).max() <= 1e-3 * scale, path

    whole = port_model(params)
    loss_w = tsp.make_train_step(
        whole, torch.optim.Adam(whole.parameters(), lr=1e-3))(batch)
    np.testing.assert_allclose(float(loss), float(loss_w), rtol=1e-6)
    for a, b in zip(split.parameters(), whole.parameters()):
        scale = max(float(b.grad.abs().max()), 1e-12)
        assert float((a.grad - b.grad).abs().max()) <= 1e-5 * scale
        clear = b.grad.abs() > 1e-5
        assert int(clear.sum()) > 0.5 * clear.numel()
        np.testing.assert_allclose(a.detach()[clear].numpy(),
                                   b.detach()[clear].numpy(), atol=1e-6)


@pytest.mark.parametrize("cout,row,slices", [
    (64, 2, 2), (32, 2, 2), (65, 2, 1), (16, 2, 1), (64, 1, 1)])
def test_split_conv_slices_wide_output_channels(cout, row, slices):
    """A convolution is split over the 'model' entries where its output
    channels divide over them and number at least 32; either way it
    computes the convolution."""
    conv = torch.nn.Conv2d(8, cout, 3, padding=1)
    x = torch.randn((2, 8, 6, 6), generator=torch.Generator().manual_seed(0))
    calls = []
    real = entry.F.conv2d

    def counting(*a, **k):
        calls.append(a[1].shape[0])
        return real(*a, **k)

    entry.F.conv2d = counting
    try:
        got = entry._split_conv(conv, x, [torch.device("cpu")] * row)
    finally:
        entry.F.conv2d = real
    assert calls == [cout // slices] * slices
    torch.testing.assert_close(got, conv(x), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_a_cpu_mesh(n):
    r = entry.dryrun_multichip(n, "cpu")
    assert r["poses"].shape == (n, 7) and bool(torch.isfinite(r["poses"]).all())
    assert float(r["ba"]["final_cost"]) <= float(r["ba"]["initial_cost"])
    assert bool(torch.isfinite(r["loss"]))
    assert all(r[f"{k}_ms"] > 0 for k in ("multiseq", "sharded_ba",
                                          "train_step"))


@pytest.mark.slow
def test_dryrun_multichip_8_on_a_cpu_mesh():
    r = entry.dryrun_multichip(8, "cpu")
    assert r["poses"].shape == (8, 7) and bool(torch.isfinite(r["poses"]).all())


def test_entry_points_default_to_the_card(capsys):
    """Without a card ``entry()`` and ``dryrun_multichip`` raise; the
    command line runs both on the CPU when asked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(2)
    entry.main(["2", "--entry", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "dryrun_multichip(2) OK" in out and "entry OK; pose:" in out
