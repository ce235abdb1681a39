"""Reporting and viewers: the port's reprojection report against the JAX
package's, ``SlamSystem.reprojection_report`` / ``render_overlay``, the
viewers (tests/test_viz.py's cases through the port) and the command
line's viewer and overlay flags.

- ``compute_projections`` on a map carried across (``interop``): selection,
  flags and measured points equal, projections and errors within 1e-3 px;
  a tight ``O`` compacts the same rows;
- a short ``SlamSystem`` run: a report with every windowed observation, a
  finite RMSE of a few pixels, an overlay that draws on the frame;
- ``viz/``: ``tests/test_viz.py``'s cases (``plot`` needs matplotlib,
  ``save_png`` Pillow: skipped where absent);
- ``cli.main`` with ``--viz-html`` on both drivers and with
  ``--overlay-every`` / ``--overlay-dir`` on the faithful one.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_e2e_vo import small_config
from vslam_tpu.core import state as jstate
from vslam_tpu.pipeline import projections as jproj
from vslam_tpu_torch import cli, interop, synthetic
from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.core.state import KeyframeState, LandmarkState
from vslam_tpu_torch.io import calib as tcalib
from vslam_tpu_torch.pipeline import projections as tproj
from vslam_tpu_torch.pipeline.slam import SlamSystem
from vslam_tpu_torch.viz import html_viewer, overlays


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tests run in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(**kw):
    import dataclasses

    return SlamConfig(**{**dataclasses.asdict(small_config()), **kw})


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate(num_frames=10, num_points=500, seed=3)


@pytest.fixture(scope="module")
def slam(seq):
    s = SlamSystem(seq.calib, port_config(), device="cpu")
    for img_l, img_r in seq.images:
        s.process_frame(img_l, img_r)
    return s


def report_arrays(rep):
    if hasattr(rep, "_asdict"):
        return {k: np.asarray(v) for k, v in rep._asdict().items()}
    return interop.to_arrays(rep)


@pytest.mark.parametrize("O,cam", [(6144, "pinhole"), (300, "pinhole"),
                                   (6144, "ds")])
def test_compute_projections_matches_jax(slam, O, cam):
    # copies: on the CPU ``to_arrays`` shares the state's memory
    kf_arrays = {k: v.copy() for k, v in interop.to_arrays(slam.kf).items()}
    lm_arrays = {k: v.copy() for k, v in interop.to_arrays(slam.lm).items()}
    # a few landmarks far off and one behind its cameras: every flag fires
    rng = np.random.RandomState(0)
    live = np.nonzero(lm_arrays["valid"] & lm_arrays["active"])[0]
    lm_arrays["pos"][live[:5]] += rng.normal(0, 0.3, (5, 3))
    lm_arrays["pos"][live[5]] = kf_arrays["pose_l"][0, :3] + [0, 0, -0.05]
    jkf = jstate.KeyframeState(**{k: jnp.asarray(v)
                                  for k, v in kf_arrays.items()})
    jlm = jstate.LandmarkState(**{k: jnp.asarray(v)
                                  for k, v in lm_arrays.items()})
    intr0, intr1 = slam.intr0.numpy(), slam.intr1.numpy()
    if cam == "ds":
        intr0 = np.array([*intr0[:4], -0.2, 0.55, 0, 0], np.float32)
        intr1 = np.array([*intr1[:4], -0.2, 0.55, 0, 0], np.float32)
    want = jproj.compute_projections(jkf, jlm, jnp.asarray(intr0),
                                     jnp.asarray(intr1), cam_name=cam, O=O)
    got = tproj.compute_projections(
        interop.from_arrays(KeyframeState, jkf._asdict(), "cpu"),
        interop.from_arrays(LandmarkState, jlm._asdict(), "cpu"),
        torch.as_tensor(intr0), torch.as_tensor(intr1), cam_name=cam, O=O)
    a, b = report_arrays(got), report_arrays(want)
    assert set(a) == set(b)
    for name in ("obs_kf", "obs_cam", "obs_lm", "valid", "outlier_flags"):
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    np.testing.assert_array_equal(a["measured"], b["measured"])
    v = b["valid"]
    np.testing.assert_allclose(a["projected"][v], b["projected"][v],
                               atol=1e-3)
    np.testing.assert_allclose(a["error"], b["error"], atol=1e-3)
    flags = b["outlier_flags"][v]
    if cam == "pinhole":
        for bit in (1, 2, 8):
            assert (flags & bit).any(), bit
    assert v.sum() == min(O, int((lm_arrays["obs_kf"][
        lm_arrays["valid"] & lm_arrays["active"]] >= 0).sum()))
    np.testing.assert_allclose(tproj.reprojection_rmse(got),
                               jproj.reprojection_rmse(want), rtol=1e-4)


def test_reprojection_report_of_a_run(slam):
    rep = slam.reprojection_report()
    lm = slam.lm
    n_obs = int((lm.obs_kf[lm.valid & lm.active] >= 0).sum())
    assert 0 < int(rep.valid.sum()) == min(n_obs, slam.cfg.window_obs)
    rmse = tproj.reprojection_rmse(rep)
    assert np.isfinite(rmse) and rmse < 0.5, rmse
    assert rep.obs_kf.shape == (slam.cfg.window_obs,)
    assert (rep.obs_kf[~rep.valid] == -1).all()
    assert (rep.error[~rep.valid] == 0).all()
    assert rep.outlier_flags.dtype == torch.int32


def test_render_overlay(slam, seq):
    img = seq.images[-1][0]
    out = slam.render_overlay(img)
    assert out.shape == img.shape + (3,) and out.dtype == np.uint8
    gray = np.stack([img] * 3, -1)
    assert (out != gray).any()
    # blue circles: projected landmarks, drawn where matches were made
    assert (out == overlays.BLUE).all(-1).sum() > 20
    assert np.array_equal(slam.render_overlay(torch.as_tensor(img)), out)
    fresh = SlamSystem(seq.calib, port_config(), device="cpu")
    np.testing.assert_array_equal(fresh.render_overlay(img), gray)


# ---------------------------------------------------------------------------
# tests/test_viz.py through the port
# ---------------------------------------------------------------------------

def test_overlays_render():
    img = np.full((60, 80), 100, np.uint8)
    corners = np.array([[10.0, 10], [40, 30], [70, 50]])
    out = overlays.draw_keypoints(img, corners)
    assert out.shape == (60, 80, 3)
    assert (out != np.stack([img] * 3, -1)).any()
    out2 = overlays.draw_matches(img, img, corners, corners,
                                 np.array([0, 2, -1]),
                                 inlier=np.array([True, False, False]))
    assert out2.shape == (60, 160, 3)
    out3 = overlays.draw_reprojections(
        img, corners, corners + 3.0, valid=np.array([True, True, False]))
    assert out3.shape == (60, 80, 3)


def test_save_png(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    img = overlays.draw_keypoints(np.full((20, 30), 90, np.uint8),
                                  np.array([[5.0, 5.0]]))
    path = str(tmp_path / "o.png")
    overlays.save_png(img, path)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_plot_map(tmp_path):
    pytest.importorskip("matplotlib")
    from vslam_tpu_torch.io import map_io
    from vslam_tpu_torch.viz import plot_map

    p = str(tmp_path / "m.json")
    rng = np.random.RandomState(0)
    cams = [((i, 0), np.array([i * 0.1, 0, 0, 0, 0, 0, 1.0]))
            for i in range(5)]
    lms = [(i, rng.randn(3)) for i in range(20)]
    est = rng.randn(5, 3)
    map_io.save_map(p, cams, lms, est, est + 0.01, 0.01)
    outs = plot_map.plot(p, str(tmp_path / "view"))
    assert len(outs) == 2 and all(os.path.exists(o) for o in outs)


def embedded(path):
    s = open(path).read()
    assert "__DATA__" not in s           # data was embedded
    start = s.index("const D = ") + len("const D = ")
    return s, json.loads(s[start:s.index(";\n", start)])


def test_html_viewer(tmp_path):
    rng = np.random.RandomState(0)
    traj = np.cumsum(rng.randn(50, 3) * 0.1, 0)
    lm = rng.randn(40000, 3) * 3  # over the downsample cap
    p = html_viewer.write_html(
        str(tmp_path / "v.html"), traj, landmarks=lm, gt=traj + 0.05,
        keyframes=traj[::5], inliers=rng.randint(40, 140, 50),
        is_keyframe=(np.arange(50) % 5 == 0),
        loop_edges=[(traj[2], traj[40])], title="test map")
    s, data = embedded(p)
    assert "test map" in s
    assert len(data["traj"]) == 50
    assert len(data["lm"]) <= 30000
    assert len(data["loops"]) == 1


def test_html_viewer_accepts_pose7(tmp_path):
    traj7 = np.zeros((10, 7))
    traj7[:, 0] = np.arange(10)
    traj7[:, 6] = 1.0
    p = html_viewer.write_html(str(tmp_path / "v7.html"), traj7)
    _, data = embedded(p)
    assert np.array(data["traj"]).shape == (10, 3)


# ---------------------------------------------------------------------------
# the command line's viewer and overlay flags
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory, seq):
    root = tmp_path_factory.mktemp("data")
    synthetic.write_mav0(seq, str(root / "mav0"))
    tcalib.save_calibration(seq.calib, str(root / "calib.json"))
    port_config().to_json(str(root / "cfg.json"))
    return root


def cli_args(root, out, name, *extra):
    return ["--device", "cpu", "--dataset-path", str(root / "mav0"),
            "--cam-calib", str(root / "calib.json"),
            "--config", str(root / "cfg.json"),
            "--map-name", str(out / name), *extra]


@pytest.mark.parametrize("driver", ["slam", "streaming"])
def test_cli_viz_html(dataset, tmp_path, driver, capsys):
    html = str(tmp_path / "view.html")
    rc = cli.main(cli_args(dataset, tmp_path, "map", "--viz-html", html,
                           "--driver", driver, "--max-frames", "8"))
    assert rc == 0
    assert f"Wrote viewer: {html}" in capsys.readouterr().err
    s, data = embedded(html)
    assert "vslam_tpu_torch" in s
    drv = cli.LAST_DRIVER
    if driver == "slam":
        traj = np.asarray(drv.trajectory)[:, :3]
        n_kf = sum(st["kind"] == "keyframe" for st in drv.stats)
    else:
        traj = drv.results()["trajectory"][:, :3]
        n_kf = int(drv.results()["is_keyframe"].sum())
    np.testing.assert_allclose(np.array(data["traj"]), traj, atol=1e-6)
    assert len(data["traj"]) == 8 and sum(data["iskf"]) == n_kf
    assert len(data["inl"]) == 8 and len(data["kf"]) == n_kf
    assert len(data["gt"]) == 10 and len(data["lm"]) > 100


def test_cli_overlays(dataset, tmp_path):
    Image = pytest.importorskip("PIL.Image")
    odir = tmp_path / "ov"
    rc = cli.main(cli_args(dataset, tmp_path, "map", "--overlay-every", "3",
                           "--overlay-dir", str(odir), "--max-frames", "7"))
    assert rc == 0
    names = sorted(os.listdir(odir))
    assert names == [f"frame_{i:05d}.png" for i in (0, 3, 6)]
    img = np.asarray(Image.open(odir / names[-1]))
    assert img.shape == (240, 320, 3)
    assert (img == overlays.BLUE).all(-1).sum() > 20
