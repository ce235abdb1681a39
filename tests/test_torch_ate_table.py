"""The port's ATE-table tool (``python -m vslam_tpu_torch.tools.ate_table``)
on tests/test_eval_table.py's fixture, on the CPU.

The fixture tree (a mav0 layout with ground truth and a calibration
file) is written with the port's ``synthetic.write_mav0`` (PGM images)
and ``io/calib.save_calibration``, once with the pinhole calibration of
that test and once with a double-sphere one, EuRoC's model. Where the
JAX fixture writes the same file the two are held equal: the calibration
JSON byte for byte, the ground truth and the timestamps number for
number, the images pixel for pixel (PNG there, PGM here). Then that
test's three cases through the port: ``discover_sequences``, the loader
round trip, and the ``--dataset-root`` table end to end (the faithful
driver's full-SLAM and VO arms, both under 0.2 m); and the hermetic
mode's arc rows.
"""

import ast
import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

from test_e2e_vo import small_config
from test_eval_table import _write_mav0
from test_eval_table import ate_table as jtool
from vslam_tpu import synthetic as jsyn
from vslam_tpu.io import calib as jcalib
from vslam_tpu_torch import synthetic
from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.io import calib as calib_mod
from vslam_tpu_torch.io import euroc
from vslam_tpu_torch.tools import ate_table

NAME = "SYN_01_easy"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tests run in parallel workers, and small
    tensors gain nothing from more (oversubscribed, they lose much)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["pinhole", "ds"])
def mav0_tree(request, tmp_path_factory):
    cam = request.param
    root = tmp_path_factory.mktemp(f"euroc_root_{cam}")
    seq = synthetic.generate(num_frames=12, num_points=500, seed=3,
                             cam_type=cam)
    synthetic.write_mav0(seq, str(root / NAME / "mav0"))
    calib_path = str(root / "calib.json")
    calib_mod.save_calibration(seq.calib, calib_path)
    return str(root), calib_path, seq, cam


def test_fixture_matches_the_jax_fixture(mav0_tree, tmp_path):
    root, calib_path, seq, cam = mav0_tree
    jseq = jsyn.generate(num_frames=12, num_points=500, seed=3,
                         cam_type=cam)
    jmav0 = _write_mav0(jseq, str(tmp_path), NAME)
    jcalib_path = str(tmp_path / "calib.json")
    jcalib.save_calibration(jseq.calib, jcalib_path)
    with open(calib_path, "rb") as a, open(jcalib_path, "rb") as b:
        assert a.read() == b.read()
    mav0 = os.path.join(root, NAME, "mav0")

    def rows(path):
        with open(path) as f:
            return [ln.split(",") for ln in f.read().splitlines()
                    if ln and not ln.startswith("#")]

    gt = "state_groundtruth_estimate0/data.csv"
    np.testing.assert_array_equal(
        np.asarray(rows(os.path.join(mav0, gt)), np.float64),
        np.asarray(rows(os.path.join(jmav0, gt)), np.float64))
    mine, theirs = (rows(os.path.join(p, "cam0", "data.csv"))
                    for p in (mav0, jmav0))
    assert [r[0] for r in mine] == [r[0] for r in theirs]
    for (_, a), (_, b) in zip(mine, theirs):
        for cam_dir in ("cam0", "cam1"):
            np.testing.assert_array_equal(
                euroc.load_image(os.path.join(mav0, cam_dir, "data", a)),
                euroc.load_image(os.path.join(jmav0, cam_dir, "data", b)))


def test_discover_sequences(mav0_tree):
    root, _, _, _ = mav0_tree
    seqs = ate_table.discover_sequences(root)
    assert [name for name, _ in seqs] == [NAME]
    # a sequence dir given directly also resolves
    direct = ate_table.discover_sequences(os.path.join(root, NAME))
    assert len(direct) == 1 and direct[0][1].endswith("mav0")


def test_loader_roundtrip(mav0_tree):
    root, calib_path, seq, cam = mav0_tree
    loaded = euroc.load_sequence(os.path.join(root, NAME, "mav0"))
    assert loaded.num_frames == len(seq.images)
    assert loaded.gt_positions is not None
    np.testing.assert_allclose(loaded.gt_positions, seq.poses[:, :3],
                               atol=1e-6)
    img = euroc.load_image(loaded.image_paths[0][0])
    np.testing.assert_array_equal(img, seq.images[0][0])
    calib = calib_mod.load_calibration(calib_path)
    assert calib.cam_types == [cam, cam]
    np.testing.assert_array_equal(np.asarray(calib.intrinsics),
                                  np.asarray(seq.calib.intrinsics))


def test_dataset_table_end_to_end(mav0_tree, tmp_path):
    """The full --dataset-root command on the fixture tree: both arms run,
    the table is written, and the ATE matches a healthy tracked run."""
    root, calib_path, _, _ = mav0_tree
    cfg_path = str(tmp_path / "cfg.json")
    SlamConfig(**dataclasses.asdict(small_config())).to_json(cfg_path)
    out_path = str(tmp_path / "EUROC_TABLE.md")

    rows = []
    rc = ate_table.main(["--dataset-root", root, "--cam-calib", calib_path,
                         "--config", cfg_path, "--out", out_path,
                         "--device", "cpu"], rows)
    assert rc == 0
    with open(out_path) as f:
        table = f.read()
    assert NAME in table
    row = [ln for ln in table.splitlines() if NAME in ln][0]
    cells = [c.strip() for c in row.split("|")[1:-1]]
    slam_ate, vo_ate = float(cells[1]), float(cells[2])
    # synthetic GT is exact; a tracked run lands well under 0.2 m
    assert slam_ate == slam_ate and slam_ate < 0.2, table
    assert vo_ate == vo_ate and vo_ate < 0.2, table
    (got,) = rows
    for arm in ("slam", "vo"):
        r = got[arm]
        assert r["frames"] == 12 and len(r["frame_ms"]) == 12
        assert r["keyframes"] >= 3 and r["tracked"] >= 10


def test_failed_sequence_gives_a_nan_row(mav0_tree, tmp_path):
    """A sequence that fails prints FAILED and gives NaN; the table is
    still written (the reference tool's per-row handling)."""
    root, calib_path, _, _ = mav0_tree
    broken = tmp_path / "root" / "BROKEN" / "mav0" / "cam0"
    broken.mkdir(parents=True)
    (broken / "data.csv").write_text("#timestamp,filename\n1,missing.pgm\n")
    out_path = str(tmp_path / "table.md")
    rows = []
    rc = ate_table.main(["--dataset-root", str(tmp_path / "root"),
                         "--cam-calib", calib_path, "--out", out_path,
                         "--device", "cpu"], rows)
    assert rc == 0
    (row,) = rows
    assert np.isnan(row["slam"]["ate_m"]) and np.isnan(row["vo"]["ate_m"])
    with open(out_path) as f:
        assert "| BROKEN | nan | nan |" in f.read()


def test_discover_sequences_is_the_original():
    assert inspect.getsource(ate_table.discover_sequences) == \
        inspect.getsource(jtool.discover_sequences)


def test_flags_are_the_original_s_and_device():
    def flags(module):
        tree = ast.parse(inspect.getsource(module))
        return {n.args[0].value for n in ast.walk(tree)
                if isinstance(n, ast.Call)
                and getattr(n.func, "attr", "") == "add_argument"}

    assert flags(ate_table) == flags(jtool) | {"--device"}


def test_defaults_to_the_card(mav0_tree):
    root, calib_path, _, _ = mav0_tree
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ate_table.main(["--dataset-root", root, "--cam-calib", calib_path])


@pytest.mark.parametrize("degraded", [False, True])
def test_hermetic_arc_rows(degraded):
    """The hermetic table's arc rows: StreamingVO on the clean and on the
    EuRoC-like degraded world (tests/test_photometric_robustness.py's
    bar, 0.15 m)."""
    seq = synthetic.generate(num_frames=24, num_points=500, seed=3)
    if degraded:
        seq.images[:] = synthetic.degrade(seq.images, seed=3)
    rmse = ate_table.run_vo(seq, seed=0, device="cpu")
    assert rmse < (0.15 if degraded else 0.08), rmse
