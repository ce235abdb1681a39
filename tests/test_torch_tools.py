"""The calibration tool, the dataset viewer, the generators the pyramid and
photometric tests need, and the native I/O binding, through the port.

- ``tools.calibrate``: the packed problem's residuals and ``jacfwd``
  Jacobians equal the reference's (1e-5 of their largest), a few LM
  iterations reach the JAX tool's parameters (1e-4 in the packed
  parameter's units), and on tests/test_calibrate.py's problem it meets
  that test's bars;
- ``synthetic.degrade`` / ``multiscale_texture`` / ``render_plane_view``
  give the JAX package's bytes, and tests/test_pyramid.py's fast cases and
  ``test_degradation_actually_degrades`` hold through the port's frontend
  and matcher;
- ``io.native``: the decoder and the vocabulary reader give what the numpy
  paths give, and ``euroc.load_image`` / ``load_dbow2_text`` use them;
- ``tools.view_dataset`` writes the overlays of a dataset;
- ``eval.recovery``'s loss episodes and attempt records on hand-made
  logs, and ``tools/slam_seed_sweep.py --summarize`` on hand-made lines:
  acceptance by frames-lost bin and the Fisher tests between packages.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu import synthetic as jsyn
from vslam_tpu.geometry import cameras as jcam
from vslam_tpu.geometry import lie as jlie
from vslam_tpu.tools import calibrate as jcal
from vslam_tpu_torch import synthetic
from vslam_tpu_torch.eval import recovery
from vslam_tpu_torch.frontend.features import extract_features
from vslam_tpu_torch.io import euroc, native
from vslam_tpu_torch.loop import vocabulary as vocab_mod
from vslam_tpu_torch.ops import hamming
from vslam_tpu_torch.tools import calibrate as tcal

INTR_SCALE = np.array([100.0, 100, 100, 100, 0.1, 0.1, 0.1, 0.1])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tests run in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def port_problem(prob):
    return tcal.CalibProblem(**{k: torch.as_tensor(v) for k, v in
                                prob.items()})


def jax_residuals(prob, cam_name="ds"):
    """The reference's ``residuals`` closure (vslam_tpu/tools/calibrate.py)
    over the same packed theta."""
    P = {k: jnp.asarray(v) for k, v in prob.items()}
    F = P["T_w_i0"].shape[0]
    n_pose, n_ext = 6 * F, 12
    scale = jnp.asarray(INTR_SCALE, jnp.float32)

    def res(theta):
        T_w_i = jax.vmap(jlie.se3_retract)(P["T_w_i0"],
                                           theta[:n_pose].reshape(F, 6))
        T_i_c = jax.vmap(jlie.se3_retract)(
            P["T_i_c0"], theta[n_pose:n_pose + n_ext].reshape(2, 6))
        intr = P["intr0"] + theta[n_pose + n_ext:].reshape(2, 8) * scale

        def one(f, c, g, uv):
            T_w_c = jlie.se3_mul(T_w_i[f], T_i_c[c])
            p_c = jlie.se3_apply(jlie.se3_inv(T_w_c), P["grid"][g])
            return jnp.clip(uv - jcam.project(cam_name, intr[c], p_c),
                            -1e5, 1e5)

        r = jax.vmap(one)(P["obs_frame"], P["obs_cam"], P["obs_corner"],
                          P["obs_uv"])
        return jnp.nan_to_num(r, nan=0.0, posinf=0.0, neginf=0.0)

    return res


@pytest.fixture(scope="module")
def small_problem():
    return synthetic.make_calib_problem(num_frames=4, rows=2, cols=2)[0]


@pytest.mark.parametrize("step", [0.0, 1e-2])
def test_calibration_residuals_and_jacobians_match(small_problem, step):
    _, residuals = tcal._problem_fns(port_problem(small_problem), "ds")
    n = 6 * 4 + 12 + 16
    theta = (step * np.random.RandomState(0).randn(n)).astype(np.float32)
    res_j = jax_residuals(small_problem)
    rj = np.asarray(jax.jit(res_j)(jnp.asarray(theta)))
    Jj = np.asarray(jax.jit(jax.jacfwd(res_j))(jnp.asarray(theta)))
    rt = residuals(torch.as_tensor(theta)).numpy()
    Jt = torch.func.jacfwd(residuals)(torch.as_tensor(theta)).numpy()
    assert rt.shape == rj.shape == (4 * 2 * 16, 2)
    assert Jt.shape == Jj.shape == (4 * 2 * 16, 2, n)
    assert np.abs(rt - rj).max() <= 1e-5 * np.abs(rj).max()
    assert np.abs(Jt - Jj).max() <= 1e-5 * np.abs(Jj).max()


def test_calibration_lm_reaches_the_jax_parameters(small_problem):
    """Ten LM iterations of both tools end on the same parameters, in the
    units of the packed theta (poses and extrinsics as they are, the
    intrinsics over their preconditioning scale)."""
    a = tcal.calibrate(port_problem(small_problem), max_iters=10,
                       device="cpu")
    b = jcal.calibrate(jcal.CalibProblem(**{
        k: jnp.asarray(v) for k, v in small_problem.items()}), max_iters=10)
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4)
    np.testing.assert_allclose(a[2].numpy() / INTR_SCALE,
                               np.asarray(b[2]) / INTR_SCALE, atol=1e-4)
    assert a[3]["history"].shape == (10,)
    np.testing.assert_allclose(float(a[3]["initial_cost"]),
                               float(b[3]["initial_cost"]), rtol=1e-5)
    assert float(a[3]["final_cost"]) < 1e-3 * float(a[3]["initial_cost"])
    # frame 0 is the gauge: it never moves
    np.testing.assert_array_equal(a[0][0].numpy(),
                                  small_problem["T_w_i0"][0])


def test_calibration_recovers_intrinsics():
    """tests/test_calibrate.py's problem and bars (its perturbations drawn
    with numpy)."""
    prob, truth = synthetic.make_calib_problem()
    T_w_i, T_i_c, intr, stats = tcal.calibrate(
        port_problem(prob), cam_name="ds", max_iters=40, device="cpu")
    assert float(stats["final_cost"]) < float(stats["initial_cost"]) * 1e-4
    err = np.abs(intr.numpy() - truth["intr"])
    assert err[:, :4].max() < 1.0, err   # focal/center within 1 px
    assert err[:, 4:6].max() < 0.01, err  # xi/alpha
    t_err = np.abs(T_i_c.numpy()[:, :3] - truth["T_i_c"][:, :3])
    assert t_err.max() < 1e-3, t_err


def test_calibration_fixed_intrinsics(small_problem):
    out = tcal.calibrate(port_problem(small_problem), max_iters=3,
                         optimize_intrinsics=False, device="cpu")
    np.testing.assert_array_equal(out[2].numpy(), small_problem["intr0"])


def test_calibrate_defaults_to_the_card(small_problem):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcal.calibrate(port_problem(small_problem), max_iters=1)


def test_calib_problem_matches_the_jax_test_s_construction():
    """The builder's ground truth projects as the JAX package projects it."""
    prob, truth = synthetic.make_calib_problem(num_frames=5)
    G = prob["grid"].shape[0]
    for f in range(5):
        for c in range(2):
            T_w_c = jlie.se3_mul(jnp.asarray(truth["T_w_i"][f]),
                                 jnp.asarray(truth["T_i_c"][c]))
            pc = jlie.se3_apply(jlie.se3_inv(T_w_c),
                                jnp.asarray(prob["grid"]))
            uv = np.asarray(jcam.project("ds", jnp.asarray(
                truth["intr"][c]), pc))
            rows = (prob["obs_frame"] == f) & (prob["obs_cam"] == c)
            assert rows.sum() == G
            np.testing.assert_allclose(prob["obs_uv"][rows], uv, atol=1e-3)
    np.testing.assert_array_equal(tcal.aprilgrid_points(4, 4),
                                  jcal.aprilgrid_points(4, 4))


# ---------------------------------------------------------------------------
# the generators, the pyramid and the photometric degradation
# ---------------------------------------------------------------------------

def test_generators_byte_equal():
    seq = synthetic.generate(num_frames=3, num_points=300, seed=3)
    a = jsyn.degrade(seq.images, seed=3)
    b = synthetic.degrade(seq.images, seed=3)
    for (la, ra), (lb, rb) in zip(a, b):
        assert la.tobytes() == lb.tobytes() and ra.tobytes() == rb.tobytes()
    ta = jsyn.multiscale_texture(256, seed=3)
    tb = synthetic.multiscale_texture(256, seed=3)
    assert ta.tobytes() == tb.tobytes()
    intr = np.array([380.0, 380.0, 80, 60, 0, 0, 0, 0])
    for z in (1.0, 2.0):
        va = jsyn.render_plane_view(ta, intr, z=z, width=160, height=120)
        vb = synthetic.render_plane_view(tb, intr, z=z, width=160, height=120)
        assert va.tobytes() == vb.tobytes()
    rng_a, rng_b = np.random.RandomState(0), np.random.RandomState(0)
    ia, ib = np.zeros((20, 20), np.uint8), np.zeros((20, 20), np.uint8)
    for uv in ((10.0, 10.0), (2.0, 10.0), (15.4, 4.6)):
        jsyn._splat(ia, uv, 200, rng_a)
        synthetic._splat(ib, uv, 200, rng_b)
    assert ia.tobytes() == ib.tobytes() and ia.sum() > 0


W, H = 640, 480
INTR = np.array([380.0, 380.0, W / 2, H / 2, 0, 0, 0, 0])


@pytest.fixture(scope="module")
def plane_views():
    tex = synthetic.multiscale_texture(2048, seed=3)
    near = synthetic.render_plane_view(tex, INTR, z=1.0, width=W, height=H,
                                       meters_per_texel=0.002)
    far = synthetic.render_plane_view(tex, INTR, z=2.0, width=W, height=H,
                                      meters_per_texel=0.002)
    return near, far


def _extract(img, octaves):
    return extract_features(torch.as_tensor(img), num_features=1000,
                            num_octaves=octaves)


def _count_good_matches(fa, fb):
    """Mutual ratio-tested matches within 3 px of the exact similarity
    (u_far - c) = 0.5 (u_near - c) of the fronto-parallel plane."""
    j, acc = hamming.match_descriptors(fa.bits, fb.bits, fa.valid, fb.valid)
    j, acc = j.numpy(), acc.numpy()
    ca, cb = fa.corners.numpy(), fb.corners.numpy()
    c = np.array([INTR[2], INTR[3]])
    idx = np.nonzero(acc)[0]
    if len(idx) == 0:
        return 0
    err = np.linalg.norm(0.5 * (ca[idx] - c) + c - cb[j[idx]], axis=-1)
    return int(np.sum(err < 3.0))


@pytest.fixture(scope="module")
def plane_features(plane_views):
    near, far = plane_views
    return {(name, o): _extract(img, o) for name, img in
            (("near", near), ("far", far)) for o in (1, 3)}


def test_single_scale_fails_one_octave_revisit(plane_features):
    n = _count_good_matches(plane_features["near", 1],
                            plane_features["far", 1])
    assert n < 30, f"expected single-scale matching to fail, got {n}"


def test_pyramid_recovers_one_octave_revisit(plane_features):
    n_ss = _count_good_matches(plane_features["near", 1],
                               plane_features["far", 1])
    n_pyr = _count_good_matches(plane_features["near", 3],
                                plane_features["far", 3])
    assert n_pyr >= 60, f"pyramid matching too weak: {n_pyr}"
    assert n_pyr > 3 * max(n_ss, 1), (n_pyr, n_ss)


def test_pyramid_bow_recall(plane_features):
    """The revisit ranks first in BoW similarity with pyramid
    descriptors (tests/test_pyramid.py::test_pyramid_bow_recall)."""
    rng = np.random.RandomState(0)
    feats = {"near": plane_features["near", 3],
             "far": plane_features["far", 3]}
    for i in range(3):
        feats[f"d{i}"] = _extract(synthetic.render_plane_view(
            synthetic.multiscale_texture(2048, seed=10 + i), INTR, z=1.0,
            width=W, height=H, meters_per_texel=0.002), 3)
    pool = np.concatenate([f.bits.numpy()[f.valid.numpy()]
                           for f in feats.values()])
    sub = pool[rng.choice(len(pool), min(4000, len(pool)), replace=False)]
    voc = vocab_mod.train(sub, k=10, depth=3, seed=0)
    dv = vocab_mod.DeviceVocabulary(voc, "cpu")

    def bow(f):
        return vocab_mod.bow_from_words(voc, dv.words(f.bits,
                                                      f.valid).numpy())

    q = bow(feats["far"])
    scores = {n: vocab_mod.l1_score(q, bow(f))
              for n, f in feats.items() if n != "far"}
    ranked = sorted(scores, key=scores.get, reverse=True)
    assert ranked.index("near") == 0, scores


def test_pyramid_shapes_and_octave_field():
    img = synthetic.multiscale_texture(256, seed=1)
    f = extract_features(torch.as_tensor(img), num_features=300,
                         num_octaves=3)
    assert f.corners.shape == (300, 2) and f.bits.shape == (300, 256)
    oct_np, valid = f.octave.numpy(), f.valid.numpy()
    assert set(np.unique(oct_np[valid])) <= {0, 1, 2}
    assert len(set(np.unique(oct_np[valid]))) >= 2
    c = f.corners.numpy()[valid]
    assert (c >= -0.5).all() and (c <= 255.5).all()


def test_single_scale_path_unchanged():
    img = torch.as_tensor(synthetic.multiscale_texture(256, seed=2))
    f1 = extract_features(img, num_features=200)
    f2 = extract_features(img, num_features=200, num_octaves=1)
    assert torch.equal(f1.corners, f2.corners)
    assert torch.equal(f1.bits, f2.bits)
    assert int(f1.octave.sum()) == 0


def test_degradation_actually_degrades():
    seq = synthetic.generate(num_frames=24, num_points=500, seed=3)
    images = synthetic.degrade(seq.images, seed=3)
    diff = np.abs(seq.images[5][0].astype(np.int32)
                  - images[5][0].astype(np.int32)).mean()
    assert 2.0 < diff < 60.0, f"mean abs diff {diff}"
    means = [im[0].astype(np.float64).mean() for im in images]
    assert np.ptp(means) > 2.0


# ---------------------------------------------------------------------------
# native I/O
# ---------------------------------------------------------------------------

def test_native_library_loads_from_the_repository_root():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert native._LIB_PATH == os.path.join(root, "native",
                                            "libvslam_native.so")
    if not os.path.exists(native._LIB_PATH):
        pytest.skip("native/libvslam_native.so is not built")
    assert native.available()


def test_native_decode_matches_pil(tmp_path, monkeypatch):
    Image = pytest.importorskip("PIL.Image")
    if not native.available():
        pytest.skip("native/libvslam_native.so is not built")
    img = synthetic.generate(num_frames=1, num_points=300,
                             seed=2).images[0][0]
    path = str(tmp_path / "a.jpg")
    Image.fromarray(img).save(path, quality=95)
    got = native.decode_gray(path)
    want = np.asarray(Image.open(path).convert("L"))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1
    # euroc.load_image takes the native path for a JPEG: PIL is not asked
    monkeypatch.setattr(euroc, "_decode_pil", lambda p: pytest.fail(p))
    np.testing.assert_array_equal(euroc.load_image(path), got)
    # a PNG is not the decoder's: None, and the loader goes to PIL
    png = str(tmp_path / "a.png")
    Image.fromarray(img).save(png)
    assert native.decode_gray(png) is None


def test_native_vocabulary_reader_matches_numpy(tmp_path, monkeypatch):
    if not native.available():
        pytest.skip("native/libvslam_native.so is not built")
    voc = vocab_mod.synthetic_vocab(k=4, depth=3, seed=1)
    path = str(tmp_path / "voc.txt")
    vocab_mod.save_dbow2_text(voc, path)
    fast = vocab_mod.load_dbow2_text(path)
    # without the library the reader parses with numpy
    monkeypatch.setattr(native, "parse_vocab_text", lambda p: None)
    slow = vocab_mod.load_dbow2_text(path)
    for field in dataclasses.fields(fast):
        a, b = getattr(fast, field.name), getattr(slow, field.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, field.name
        np.testing.assert_array_equal(a, b, err_msg=field.name)
    assert (fast.k, fast.depth, fast.num_words) == (voc.k, voc.depth,
                                                    voc.num_words)


def test_view_dataset_writes_overlays(tmp_path):
    pytest.importorskip("PIL.Image")
    from vslam_tpu_torch.tools import view_dataset

    seq = synthetic.generate(num_frames=3, num_points=300, seed=3)
    synthetic.write_mav0(seq, str(tmp_path / "mav0"))
    out = tmp_path / "view"
    assert view_dataset.main([str(tmp_path / "mav0"), str(out), "2",
                              "cpu"]) == 0
    from PIL import Image

    names = sorted(os.listdir(out))
    assert names == ["frame_0000.png", "frame_0001.png"]
    img = np.asarray(Image.open(out / names[0]))
    assert img.shape == (240, 640, 3)
    assert (img != img[..., :1]).any()      # green crosses drawn
    assert view_dataset.main([]) == 1


# ---------------------------------------------------------------------------
# the relocalization census and the seed sweep's summary
# ---------------------------------------------------------------------------

def test_loss_episodes_and_how_they_end():
    ok = np.array([0, 1, 1, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0, 1, 0, 0], bool)
    kf = np.zeros(len(ok), bool)
    kf[[0, 1, 8]] = True     # frame 8: a keyframe on a lost frame
    events = [(4, False), (5, True), (12, False)]
    assert recovery.loss_episodes(ok, kf, events) == [
        (3, 2, "relocalized"),   # accepted after frame 4, frame 5 tracks
        (6, 3, "rebootstrap"),
        (11, 2, "self"),         # the attempt after frame 11 failed
        (14, 2, "open")]
    # an accepted attempt after a re-bootstrap keyframe does not end it
    kf[3] = True
    assert recovery.loss_episodes(ok, kf, events)[0] == (3, 2,
                                                         "rebootstrap")


def test_attempt_records_and_bins():
    gt = np.zeros((20, 7))
    gt[:, 6] = 1.0
    gt[:, 0] = np.arange(20) * 0.1
    traj = gt.copy()
    traj[9, 1] = 0.5                       # the coasted pose, 0.5 m off
    half = np.sin(np.radians(10.0) / 2)    # and 10 degrees about z
    traj[9, 5:7] = half, np.cos(np.radians(10.0) / 2)
    diags = [dict(frame=10, frames_lost=3, gate=1.5, candidates=2, best_n=7,
                  best_gate_err=None, applied_frame=9),
             dict(frame=16, frames_lost=12, gate=6.0, candidates=1,
                  best_n=40, best_gate_err=0.8, T_wc=[0.0] * 7,
                  applied_frame=15)]
    recs = recovery.attempt_records(diags, traj, gt, harvests=[[12, 4],
                                                               [33]])
    assert [r["bin"] for r in recs] == ["2-3", ">=12"]
    assert [r["ok"] for r in recs] == [False, True]
    assert recs[0]["harvest"] == [12, 4] and recs[1]["harvest"] == [33]
    assert recs[0]["coasted_err_m"] == 0.5
    assert recs[0]["coasted_err_deg"] == pytest.approx(10.0, abs=1e-3)
    assert recs[0]["last_tracked_err_m"] == 0.0     # frame 6
    assert recovery.acceptance_by_bin(recs) == {
        "2-3": [0, 1], "4-7": [0, 0], "8-11": [0, 0], ">=12": [1, 1]}
    assert [recovery.frames_lost_bin(n) for n in (2, 3, 4, 7, 8, 11, 12,
                                                  40)] == [
        "2-3", "2-3", "4-7", "4-7", "8-11", "8-11", ">=12", ">=12"]


def sweep_module():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "slam_seed_sweep.py")
    spec = importlib.util.spec_from_file_location("slam_seed_sweep", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sweep_line(backend, schedule, seed, loops, attempts, episodes):
    """A ``--scenario bench`` line; attempts: [(frames_lost, ok)]; a failed
    one had no pose, except at 12 or more frames lost: over the gate."""
    recs = [dict(frame=40 + 8 * i, frames_lost=n,
                 bin=recovery.frames_lost_bin(n), gate=0.5 * min(n, 12),
                 candidates=1, harvest=[20],
                 best_n=30 if ok or n >= 12 else 4,
                 best_gate_err=0.1 if ok else 7.0 if n >= 12 else None,
                 ok=ok)
            for i, (n, ok) in enumerate(attempts)]
    return dict(scenario="bench", backend=backend, schedule=schedule,
                seed=seed, loop_frames=loops,
                reloc_attempts=len(attempts),
                reloc_ok=sum(ok for _, ok in attempts), attempts=recs,
                loss_episodes=episodes)


def test_seed_sweep_summary_bins_and_fisher(tmp_path, capsys):
    from scipy import stats

    lines = [
        sweep_line("jax", "chunk8_stride1", 0, [[180, 40]],
                   [(2, False), (5, True), (9, True), (14, True)],
                   [[60, 14, "relocalized"], [120, 3, "self"]]),
        sweep_line("jax", "chunk8_stride1", 1, [],
                   [(3, False), (12, True)],
                   [[70, 20, "relocalized"]]),
        sweep_line("torch", "chunk8", 0, [[230, 50]],
                   [(2, False), (2, False), (3, False), (6, True)],
                   [[60, 31, "rebootstrap"]]),
        sweep_line("torch", "chunk8", 1, [[190, 40]], [(13, False)],
                   [[80, 40, "open"]]),
    ]
    path = tmp_path / "sweep.jsonl"
    path.write_text("".join(json.dumps(d) + "\n" for d in lines)
                    + "not a record\n")
    out = sweep_module().summarize([str(path)])
    jax_rec, port_rec, tests = out
    assert (jax_rec["backend"], port_rec["backend"]) == ("jax", "torch")
    assert jax_rec["accepted_by_frames_lost"] == {
        "2-3": [0, 2], "4-7": [1, 1], "8-11": [1, 1], ">=12": [2, 2]}
    assert port_rec["accepted_by_frames_lost"] == {
        "2-3": [0, 3], "4-7": [1, 1], "8-11": [0, 0], ">=12": [0, 1]}
    assert port_rec["reloc_diagnosed"] == dict(
        attempts=5, no_pose=3, over_gate=1, frames_lost=[2, 2, 3, 6, 13])
    assert (jax_rec["reloc_accepted"], jax_rec["reloc_attempts"]) == (4, 6)
    assert (port_rec["reloc_accepted"], port_rec["reloc_attempts"]) == (1,
                                                                        5)
    assert jax_rec["loss_episodes"] == dict(
        per_run=1.5, median_length=14.0,
        ended=dict(relocalized=2, self=1, rebootstrap=0, open=0))
    assert port_rec["loss_episodes"]["ended"] == dict(
        relocalized=0, self=0, rebootstrap=1, open=1)
    assert (jax_rec["closed"], port_rec["closed"]) == (1, 2)
    assert port_rec["closed_in_first_revisit"] == 1
    assert tests["port_schedule"] == "chunk8"
    assert tests["jax_schedule"] == "chunk8_stride1"
    assert tests["fisher_reloc_accepted_p"] == pytest.approx(
        stats.fisher_exact([[4, 2], [1, 4]])[1])
    assert tests["fisher_closed_p"] == pytest.approx(
        stats.fisher_exact([[1, 1], [2, 0]])[1])
    assert tests["fisher_first_revisit_p"] == 1.0
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == json.loads(json.dumps(out))
