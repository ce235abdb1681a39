"""The port's learned frontend against the JAX package's, and the drivers'
``feature_fn`` hook.

- ``SuperPointTPU`` loaded with ``from_flax_params`` computes the flax
  model's logits and descriptors (1e-4); ``heatmap_to_cells`` equals;
  ``detector_loss`` and ``descriptor_loss`` agree to 1e-5; one training
  step's gradients agree with ``jax.grad`` (1e-4 of each tensor's
  largest), and five ``torch.optim.Adam`` steps land on ``optax.adam``'s
  parameters (1e-4);
- ``extract_features_learned``: corners and validity equal, descriptor
  bits equal wherever the descriptor value is clear of zero (1e-4);
- ``StreamingVO`` / ``StreamingSLAM`` take ``feature_fn``: with a hook
  that returns the built-in extraction, the port's run is the run without
  the hook, bit for bit, and it meets the JAX driver with the same hook
  by outcome (RANSAC draws differ between the packages).

The training from scratch and the learned VO are in
``test_torch_learned_vo.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_streaming import small_config
from vslam_tpu.frontend import features as jfeat
from vslam_tpu.models import learned_frontend as jlf
from vslam_tpu.models import superpoint as jsp
from vslam_tpu.pipeline.streaming import StreamingVO as JaxStreamingVO
from vslam_tpu_torch import synthetic
from vslam_tpu_torch.eval import ate
from vslam_tpu_torch.frontend.features import extract_features
from vslam_tpu_torch.loop import vocabulary as tvocab
from vslam_tpu_torch.models import learned_frontend as tlf
from vslam_tpu_torch.models import superpoint as tsp
from vslam_tpu_torch.ops.compact import top_k
from vslam_tpu_torch.pipeline.streaming import StreamingSLAM, StreamingVO

FLAX_NAMES = [(f"ConvBlock_{b}", f"Conv_{c}") for b in range(4)
              for c in range(2)] + [(f"Conv_{h}",) for h in range(4)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tests run in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_model(dim, width, shape, key=0):
    model = jsp.SuperPointTPU(dim=dim, width=width)
    params = model.init(jax.random.PRNGKey(key), jnp.zeros(shape))
    return model, params


def port_of(params, dim, width):
    return tsp.from_flax_params(tsp.SuperPointTPU(dim=dim, width=width),
                                params)


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("dim,width,shape", [
    (32, 8, (2, 32, 48, 1)), (256, 64, (1, 16, 24, 1))],
    ids=["small", "default_width"])
def test_forward_matches_flax(dim, width, shape):
    model, params = flax_model(dim, width, shape)
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    lj, dj = model.apply(params, jnp.asarray(x))
    lt, dt = port_of(params, dim, width)(t(x))
    assert lt.shape == lj.shape and dt.shape == dj.shape
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                               atol=1e-4)
    np.testing.assert_allclose(dt.detach().numpy(), np.asarray(dj),
                               atol=1e-4)


def test_default_init_is_flax_like():
    """The port's own initialization: flax's default shapes and scales
    (LeCun-normal truncated at two standard deviations, zero biases)."""
    _, params = flax_model(64, 8, (1, 16, 16, 1))
    model = tsp.SuperPointTPU(dim=64, width=8,
                              generator=torch.Generator().manual_seed(0))
    for conv, path in zip(model.convs(), FLAX_NAMES):
        leaf = params["params"]
        for key in path:
            leaf = leaf[key]
        kernel = np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1)
        assert tuple(conv.weight.shape) == kernel.shape
        assert not conv.bias.any()
        std = 1.0 / np.sqrt(conv.weight[0].numel())
        w = conv.weight.detach().numpy()
        assert np.abs(w).max() <= 2 * std / 0.8796 + 1e-6
        assert 0.7 * std < w.std() < 1.3 * std


def test_from_flax_params_refuses_a_wrong_width():
    _, params = flax_model(32, 8, (1, 16, 16, 1))
    with pytest.raises(ValueError, match="ConvBlock_0/Conv_0"):
        tsp.from_flax_params(tsp.SuperPointTPU(dim=32, width=16), params)


def test_heatmap_to_cells_matches():
    rng = np.random.RandomState(1)
    heat = (rng.rand(3, 32, 40) < 0.02).astype(np.float32)
    heat[0, :8, :8] = 0.0
    heat[0, 3, 5] = heat[0, 4, 6] = 1.0         # two corners in one cell
    want = np.asarray(jsp.heatmap_to_cells(jnp.asarray(heat)))
    got = tsp.heatmap_to_cells(t(heat)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0] == 3 * 8 + 5 and (got == 64).any()


def random_heads(seed, b=2, hc=4, wc=6, d=16, m=10):
    rng = np.random.RandomState(seed)
    desc = rng.randn(2, b, hc, wc, d).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    uv = rng.uniform(0, [wc * 8, hc * 8], (2, b, m, 2)).astype(np.float32)
    uv[0, 0, 0] = [-3.0, 100.0]                     # clipped to the edge
    return dict(
        logits=rng.randn(b, hc, wc, 65).astype(np.float32),
        heat=(rng.rand(b, hc * 8, wc * 8) < 0.03).astype(np.float32),
        desc_a=desc[0], desc_b=desc[1], uv_a=uv[0], uv_b=uv[1],
        valid=rng.rand(b, m) < 0.8)


@pytest.mark.parametrize("seed", [0, 1])
def test_losses_match(seed):
    h = random_heads(seed)
    want = float(jsp.detector_loss(jnp.asarray(h["logits"]),
                                   jnp.asarray(h["heat"])))
    got = float(tsp.detector_loss(t(h["logits"]), t(h["heat"])))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    args = [h[k] for k in ("desc_a", "desc_b", "uv_a", "uv_b", "valid")]
    want = float(jsp.descriptor_loss(*map(jnp.asarray, args)))
    got = float(tsp.descriptor_loss(*map(t, args)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def small_batch(seed=3, b=2, h=32, w=48, m=12):
    rng = np.random.RandomState(seed)
    uv = rng.uniform(4, [w - 4, h - 4], (b, m, 2)).astype(np.float32)
    heat = np.zeros((b, h, w), np.float32)
    bi = np.repeat(np.arange(b), m)
    iy, ix = uv[..., 1].astype(int).ravel(), uv[..., 0].astype(int).ravel()
    heat[bi, iy, ix] = 1
    return {"img_a": rng.rand(b, h, w, 1).astype(np.float32),
            "img_b": rng.rand(b, h, w, 1).astype(np.float32),
            "heat_a": heat, "heat_b": heat,
            "uv_a": uv, "uv_b": uv + 0.5, "valid": rng.rand(b, m) < 0.9}


def test_train_step_gradients_match_jax_grad():
    batch = small_batch()
    model, params = flax_model(32, 8, batch["img_a"].shape, key=2)

    def loss_fn(p, bt):
        la, da = model.apply(p, bt["img_a"])
        lb, db = model.apply(p, bt["img_b"])
        return (jsp.detector_loss(la, bt["heat_a"])
                + jsp.detector_loss(lb, bt["heat_b"])
                + jsp.descriptor_loss(da, db, bt["uv_a"], bt["uv_b"],
                                      bt["valid"]))

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lj, gj = jax.value_and_grad(loss_fn)(params, jb)
    port = port_of(params, 32, 8)
    lt = tsp.loss_fn(port, {k: t(v) for k, v in batch.items()})
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for conv, path in zip(port.convs(), FLAX_NAMES):
        leaf = gj["params"]
        for key in path:
            leaf = leaf[key]
        for got, want in ((conv.weight.grad.numpy(),
                           np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1)),
                          (conv.bias.grad.numpy(), np.asarray(leaf["bias"]))):
            scale = max(np.abs(want).max(), 1e-12)
            assert np.abs(got - want).max() <= 1e-4 * scale, path


def test_adam_steps_match_optax():
    # an initialization whose gradients keep clear of zero: Adam's first
    # steps move a parameter by about the learning rate whatever the size
    # of its gradient, so a gradient of 1e-9 whose sign rounds apart moves
    # it 4e-3 apart
    batch = small_batch(seed=4)
    model, params = flax_model(32, 8, batch["img_a"].shape, key=6)
    tx = optax.adam(2e-3)
    step = jax.jit(jsp.make_train_step(model, tx))
    opt_state = tx.init(params)
    port = port_of(params, 32, 8)
    port_step = tsp.make_train_step(
        port, torch.optim.Adam(port.parameters(), lr=2e-3))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: t(v) for k, v in batch.items()}
    for _ in range(5):
        params, opt_state, lj = step(params, opt_state, jb)
        lt = port_step(tb)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)
    want = port_of(params, 32, 8)
    for a, b in zip(port.parameters(), want.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-4)


def test_synthetic_batch_shapes():
    b = tsp.synthetic_batch(torch.Generator().manual_seed(1), batch=2, h=32,
                            w=32, m=8)
    assert b["img_a"].shape == (2, 32, 32, 1)
    assert b["uv_a"].shape == (2, 8, 2) and bool(b["valid"].all())
    assert ((b["uv_a"] >= 4) & (b["uv_a"] <= 28)).all()
    assert b["heat_a"].sum() <= 16 and b["heat_a"].sum() > 0
    labels = tsp.heatmap_to_cells(b["heat_a"])
    assert (labels < 64).sum() >= 1


@pytest.mark.parametrize("dim,num_features", [(64, 48), (32, 96)])
def test_extract_features_learned_matches(dim, num_features):
    """Corners and validity equal; bits equal where |d| > 1e-4 (a value
    nearer zero may flip its sign between the packages); a descriptor
    narrower than 256 is tiled."""
    img = synthetic.generate(num_frames=1, num_points=300,
                             seed=5).images[0][0][64:128, :128]
    model, params = flax_model(dim, 8, (1, 64, 128, 1), key=4)
    # a wider spread of cell scores than the initialization's near-uniform
    # softmax (a detector head 30 x as large), so that neither the top-k
    # order nor the threshold is decided by rounding
    params = jax.tree_util.tree_map(lambda p: p, params)
    params["params"]["Conv_1"]["kernel"] = \
        params["params"]["Conv_1"]["kernel"] * 30.0
    jf = jlf.extract_features_learned(model, params, jnp.asarray(img),
                                      num_features=num_features,
                                      score_threshold=0.04)
    port = port_of(params, dim, 8)
    tf = tlf.extract_features_learned(port, torch.as_tensor(img),
                                      num_features=num_features,
                                      score_threshold=0.04)
    valid = np.asarray(jf.valid)
    assert 0 < valid.sum() < num_features
    np.testing.assert_array_equal(tf.valid.numpy(), valid)
    np.testing.assert_array_equal(tf.corners.numpy(), np.asarray(jf.corners))
    np.testing.assert_array_equal(tf.angles.numpy(), 0)
    np.testing.assert_array_equal(tf.octave.numpy(), 0)
    assert tf.bits.shape == (num_features, 256)
    assert tf.bits.dtype == torch.uint8
    # the descriptor values behind each bit
    x = torch.as_tensor(img, dtype=torch.float32)[None, :, :, None] / 255
    with torch.no_grad():
        logits, desc = port(x)
    score = torch.softmax(logits[0], -1)[..., :64].amax(-1).reshape(-1)
    idx = top_k(score, num_features)[1]
    d = desc[0].reshape(-1, dim)[idx].numpy()
    d = np.tile(d, (1, -(-256 // dim)))[:, :256]
    clear = (np.abs(d) > 1e-4) & valid[:, None]
    assert clear.mean() > 0.2
    got, want = tf.bits.numpy(), np.asarray(jf.bits)
    np.testing.assert_array_equal(got[clear], want[clear])
    assert (got[~valid] == 0).all()


def test_make_feature_fn_takes_numpy_and_refuses_another_device():
    model = tsp.SuperPointTPU(dim=32, width=8,
                              generator=torch.Generator().manual_seed(0))
    fn = tlf.make_feature_fn(model, num_features=16, score_threshold=0.0)
    img = np.random.RandomState(0).randint(0, 255, (32, 48)).astype(np.uint8)
    a, b = fn(img), fn(torch.as_tensor(img))
    assert torch.equal(a.corners, b.corners) and torch.equal(a.bits, b.bits)
    assert a.corners.shape == (16, 2) and bool(a.valid.all())
    with pytest.raises(ValueError, match="image on meta"):
        fn(torch.empty((32, 48), dtype=torch.uint8, device="meta"))


# ---------------------------------------------------------------------------
# the drivers' feature_fn hook
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seq():
    return synthetic.generate(num_frames=24, num_points=500, seed=3)


def builtin_hook(extract, calls):
    """A feature_fn that returns the built-in extraction at the drivers'
    settings (``small_config``)."""
    cfg = small_config()

    def feature_fn(img):
        calls.append(tuple(img.shape))
        return extract(img, num_features=cfg.num_features,
                       quality_level=cfg.quality_level,
                       min_distance=cfg.min_distance,
                       rotate_features=cfg.rotate_features,
                       num_octaves=cfg.num_octaves)

    return feature_fn


def test_streaming_feature_fn_matches_the_jax_driver(seq):
    """The fault: ``StreamingVO(feature_fn=...)`` raised TypeError in the
    port. Now the hook is called on the left image of every frame and the
    right image of every keyframe; returning the built-in extraction it
    reproduces the plain run bit for bit, and the JAX driver with the same
    hook by outcome (the streaming tests' bounds)."""
    calls, jcalls = [], []
    vo = StreamingVO(seq.calib, small_config(), max_frames=64, device="cpu",
                     feature_fn=builtin_hook(extract_features, calls))
    vo.run(seq.images)
    plain = StreamingVO(seq.calib, small_config(), max_frames=64,
                        device="cpu")
    plain.run(seq.images)
    res, ref = vo.results(), plain.results()
    for key in ("trajectory", "inliers", "is_keyframe", "tracked_ok"):
        np.testing.assert_array_equal(res[key], ref[key], err_msg=key)
    n_kf = int(res["is_keyframe"].sum())
    assert len(calls) == len(seq.images) + n_kf
    assert set(calls) == {(240, 320)}

    jvo = JaxStreamingVO(seq.calib, small_config(), max_frames=64,
                         feature_fn=builtin_hook(jfeat.extract_features,
                                                 jcalls))
    jvo.run(seq.images, sync_every=0)
    jax.block_until_ready(jvo.state.frame)
    assert jcalls   # traced into the JAX driver's step
    fa, pa, _ = jvo.keyframe_trajectory()
    fb, pb, _ = vo.keyframe_trajectory()
    rmse_jax = ate.align_svd(pa, seq.poses[fa, :3])[2]
    rmse = ate.align_svd(pb, seq.poses[fb, :3])[2]
    assert rmse < 0.08 and rmse < max(2.0 * rmse_jax, 0.05), (rmse,
                                                               rmse_jax)
    assert len(fa) == len(fb) and np.abs(fa - fb).max() <= 1, (fa, fb)
    assert res["tracked_ok"][2:].all()
    full = ate.align_svd(res["trajectory"][:, :3],
                         seq.poses[:len(seq.images), :3])[2]
    assert full < 0.10


def test_streaming_slam_takes_feature_fn(seq):
    voc = tvocab.synthetic_vocab(k=4, depth=3, seed=1)
    cfg = small_config()
    cfg.enable_loop_closure = True
    calls = []
    slam = StreamingSLAM(seq.calib, cfg, voc, max_frames=32, poll_every=4,
                         device="cpu",
                         feature_fn=builtin_hook(extract_features, calls))
    slam.run(seq.images[:8])
    res = slam.results()
    assert len(calls) == 8 + int(res["is_keyframe"].sum())
    assert res["tracked_ok"][2:].all()
    assert len(slam.events) == int(res["is_keyframe"].sum())
