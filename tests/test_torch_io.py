"""The port's files: vocabulary text, datasets, images, maps, checkpoints,
metrics, traces and the command line, on the CPU.

- DBoW2 text: a vocabulary written by the port reads back equal; a file
  written by the JAX package's ``save_dbow2_text`` is read by the port into
  the arrays the JAX package's numpy parser gives, and the two writers
  produce the same bytes;
- map JSON: the ``value0..value4`` layout with ``c.T_w_c`` / ``lm.p``,
  written by either package and read by the other;
- binary PGM decoding (comments, odd whitespace, 16-bit refused) against
  PIL and the JAX loader; a mav0 dataset of ``.pgm`` files written by
  ``synthetic.write_mav0`` loads through both packages' ``load_sequence``;
  the flat sample layout; the prefetcher, which raises a decode error;
- a ``SlamSystem`` checkpoint round trip (the next frame's ``info`` and
  pose bits equal the uninterrupted run's) and a stream checkpoint round
  trip for ``StreamingSLAM``;
- ``cli.main(["--device", "cpu", ...])`` on a 12-frame PGM dataset in
  ``tmp_path`` for both drivers, with a vocabulary file, a config file, a
  metrics file, a trace directory and a tune file; the default device
  raises without a card;
- ``StageTimer`` / ``MetricsLogger`` / ``profiling``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from test_e2e_vo import small_config
from vslam_tpu.io import euroc as jeuroc
from vslam_tpu.io import map_io as jmap_io
from vslam_tpu.loop import vocabulary as jvocab
from vslam_tpu_torch import cli, synthetic
from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.io import calib as tcalib
from vslam_tpu_torch.io import euroc as teuroc
from vslam_tpu_torch.io import map_io as tmap_io
from vslam_tpu_torch.loop import vocabulary as tvocab
from vslam_tpu_torch.pipeline.slam import SlamSystem
from vslam_tpu_torch.pipeline.streaming import StreamingSLAM, StreamingVO
from vslam_tpu_torch.utils import checkpoint, metrics, profiling

VOC_FIELDS = ("node_desc", "children", "is_leaf", "word_of_node",
              "node_of_word", "weights", "parent", "level")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tests run in parallel workers, and small
    tensors gain nothing from more (oversubscribed, they lose much)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(**kw):
    return SlamConfig(**{**dataclasses.asdict(small_config()), **kw})


def trained_vocab():
    rng = np.random.RandomState(4)
    centers = rng.randint(0, 2, (12, 256)).astype(np.uint8)
    flips = rng.rand(600, 256) < 0.1
    descs = np.where(flips, 1 - centers[rng.randint(0, 12, 600)],
                     centers[rng.randint(0, 12, 600)]).astype(np.uint8)
    voc = tvocab.train(descs, k=4, depth=3, seed=0)
    tvocab.set_idf_weights(voc, [descs[i::5] for i in range(5)])
    return voc, descs


def assert_vocab_equal(got, want):
    assert (got.k, got.depth) == (want.k, want.depth)
    for name in VOC_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------------------
# vocabulary text
# ---------------------------------------------------------------------------

def test_dbow2_text_round_trip(tmp_path):
    voc, descs = trained_vocab()
    path = str(tmp_path / "voc.txt")
    tvocab.save_dbow2_text(voc, path)
    with open(path) as f:
        header = f.readline().split()
        first = f.readline().split()
    assert header == ["4", "3", "0", "0"]
    assert len(first) == 35 and first[0] == "0"     # a child of the root
    back = tvocab.load_dbow2_text(path)
    # the text carries float64 reprs of the float32 weights: exact
    assert_vocab_equal(back, voc)
    assert back.num_words == voc.num_words > 16
    for x, y in zip(tvocab.transform_np(back, descs[:50]),
                    tvocab.transform_np(voc, descs[:50])):
        np.testing.assert_array_equal(x, y)
    # and a second write gives the same bytes
    tvocab.save_dbow2_text(back, str(tmp_path / "again.txt"))
    assert (tmp_path / "again.txt").read_bytes() == (
        tmp_path / "voc.txt").read_bytes()


def test_dbow2_text_written_by_jax_reads_in_the_port(tmp_path):
    voc, _ = trained_vocab()
    jvoc = jvocab.Vocabulary(k=voc.k, depth=voc.depth, **{
        f: getattr(voc, f) for f in VOC_FIELDS})
    jpath, tpath = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    jvocab.save_dbow2_text(jvoc, jpath)
    tvocab.save_dbow2_text(voc, tpath)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    got = tvocab.load_dbow2_text(jpath)
    assert_vocab_equal(got, voc)
    # against the JAX package's numpy parser (its native reader is a C++
    # library that may be absent; the parser is the specification)
    want = jvocab._vocab_from_flat(*_flat_fields(jpath))
    assert_vocab_equal(got, want)
    # and a vocabulary loaded by the port goes back across
    assert_vocab_equal(tvocab.from_arrays(want), got)


def _flat_fields(path):
    """The per-node arrays of a DBoW2 text file, parsed line by line as
    ``vslam_tpu/loop/vocabulary.py``'s numpy fallback parses them."""
    with open(path) as f:
        k, depth = (int(x) for x in f.readline().split()[:2])
        rows = [line.split() for line in f if len(line.split()) >= 35]
    return (k, depth, np.asarray([int(r[0]) for r in rows], np.int32),
            np.asarray([int(r[1]) != 0 for r in rows], bool),
            np.asarray([[int(x) for x in r[2:34]] for r in rows], np.uint8),
            np.asarray([float(r[34]) for r in rows], np.float64))


def test_dbow2_text_skips_short_lines(tmp_path):
    voc = tvocab.synthetic_vocab(k=3, depth=2, seed=2)
    path = str(tmp_path / "voc.txt")
    tvocab.save_dbow2_text(voc, path)
    with open(path, "a") as f:
        f.write("\n7 1 2 3\n")              # a truncated trailing line
    assert_vocab_equal(tvocab.load_dbow2_text(path), voc)


# ---------------------------------------------------------------------------
# maps
# ---------------------------------------------------------------------------

def test_map_json_schema_and_cross_package(tmp_path):
    rng = np.random.RandomState(0)
    cams = [((f, 0), rng.normal(size=7)) for f in (0, 4, 9)]
    lms = [(i, rng.normal(size=3)) for i in (2, 5, 11, 12)]
    est, gt = rng.normal(size=(3, 3)), rng.normal(size=(10, 3))
    tpath, jpath = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    tmap_io.save_map(tpath, cams, lms, est, gt, 0.125)
    jmap_io.save_map(jpath, cams, lms, est, gt, 0.125)
    with open(tpath) as a, open(jpath) as b:
        raw = json.load(a)
        assert raw == json.load(b)
    assert sorted(raw) == ["value0", "value1", "value2", "value3", "value4"]
    assert raw["value0"][1]["key"] == {"value0": 4, "value1": 0}
    assert sorted(raw["value0"][0]["value"]["c.T_w_c"]) == [
        "px", "py", "pz", "qw", "qx", "qy", "qz"]
    assert sorted(raw["value1"][0]["value"]["lm.p"]) == [
        "value0", "value1", "value2"]
    assert raw["value4"] == 0.125
    for load, path in ((tmap_io.load_map, jpath), (jmap_io.load_map, tpath)):
        c2, l2, e2, g2, a2 = load(path)
        assert [k for k, _ in c2] == [k for k, _ in cams]
        np.testing.assert_allclose([T for _, T in c2], [T for _, T in cams])
        assert [k for k, _ in l2] == [k for k, _ in lms]
        np.testing.assert_allclose([p for _, p in l2], [p for _, p in lms])
        np.testing.assert_allclose(e2, est)
        np.testing.assert_allclose(g2, gt)
        assert a2 == 0.125


# ---------------------------------------------------------------------------
# images and datasets
# ---------------------------------------------------------------------------

def test_pgm_decode_matches_pil_and_jax_loader(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (37, 53)).astype(np.uint8)
    plain = str(tmp_path / "a.pgm")
    teuroc.save_pgm(plain, img)
    np.testing.assert_array_equal(teuroc.load_image(plain), img)
    np.testing.assert_array_equal(np.asarray(Image.open(plain)), img)
    np.testing.assert_array_equal(jeuroc.load_image(plain), img)
    # header variants: comments, tabs and several newlines
    odd = str(tmp_path / "b.pgm")
    with open(odd, "wb") as f:
        f.write(b"P5\n# made by a test\n53\t37\n# maxval next\n\n255\n")
        f.write(img.tobytes())
    np.testing.assert_array_equal(teuroc.load_image(odd), img)
    np.testing.assert_array_equal(np.asarray(Image.open(odd)), img)
    # a raster that begins with whitespace bytes is not eaten by the header
    img[0, :4] = (32, 10, 9, 13)
    teuroc.save_pgm(plain, img)
    np.testing.assert_array_equal(teuroc.load_image(plain), img)
    out = teuroc.load_image(plain)
    assert out.dtype == np.uint8 and out.flags.writeable
    # 16-bit PGM is refused, never a blank or wrong frame
    with open(odd, "wb") as f:
        f.write(b"P5\n2 2\n65535\n" + bytes(8))
    with pytest.raises(ValueError, match="not 8-bit"):
        teuroc.load_image(odd)
    # a truncated raster raises too
    with open(odd, "wb") as f:
        f.write(b"P5\n53 37\n255\n" + bytes(100))
    with pytest.raises(ValueError):
        teuroc.load_image(odd)


def test_other_formats_go_through_pil(tmp_path):
    from PIL import Image

    img = (np.arange(48 * 64) % 251).astype(np.uint8).reshape(48, 64)
    png = str(tmp_path / "a.png")
    Image.fromarray(img).save(png)
    np.testing.assert_array_equal(teuroc.load_image(png), img)
    rgb = str(tmp_path / "rgb.png")
    Image.fromarray(np.stack([img] * 3, -1)).save(rgb)
    np.testing.assert_array_equal(teuroc.load_image(rgb), img)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 12-frame mav0 dataset of PGM files with calibration, vocabulary
    and configuration files."""
    root = tmp_path_factory.mktemp("data")
    seq = synthetic.generate(num_frames=12, num_points=500, seed=3)
    ts = synthetic.write_mav0(seq, str(root / "mav0"))
    tcalib.save_calibration(seq.calib, str(root / "calib.json"))
    voc = tvocab.synthetic_vocab(k=4, depth=3, seed=1)
    tvocab.save_dbow2_text(voc, str(root / "voc.txt"))
    cfg = port_config(enable_loop_closure=True, enable_relocalization=True)
    cfg.to_json(str(root / "cfg.json"))
    return root, seq, ts, voc, cfg


def test_mav0_dataset_loads_in_both_packages(dataset):
    root, seq, ts, _, _ = dataset
    got = teuroc.load_sequence(str(root / "mav0"))
    want = jeuroc.load_sequence(str(root / "mav0"))
    assert got.num_frames == want.num_frames == 12
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    np.testing.assert_array_equal(got.timestamps, ts)
    assert got.image_paths == want.image_paths
    assert all(l.endswith(".pgm") and "cam0" in l and "cam1" in r
               for l, r in got.image_paths)
    for name in ("gt_timestamps", "gt_positions", "gt_quats"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_allclose(got.gt_positions, seq.poses[:, :3])
    np.testing.assert_allclose(got.gt_quats, seq.poses[:, 3:7])
    for (pl, pr), (img_l, img_r) in zip(got.image_paths[:3], seq.images):
        np.testing.assert_array_equal(teuroc.load_image(pl), img_l)
        np.testing.assert_array_equal(teuroc.load_image(pr), img_r)
        np.testing.assert_array_equal(jeuroc.load_image(pl), img_l)


def test_sample_dir_layout_and_prefetcher(tmp_path, dataset):
    from PIL import Image

    _, seq, _, _, _ = dataset
    for t, (img_l, img_r) in zip((30, 10, 20), seq.images):
        Image.fromarray(img_l).save(str(tmp_path / f"{t}_0.jpg"), quality=95)
        Image.fromarray(img_r).save(str(tmp_path / f"{t}_1.jpg"), quality=95)
    Image.fromarray(seq.images[0][0]).save(str(tmp_path / "40_0.jpg"))
    got = teuroc.load_sequence(str(tmp_path))    # no cam0/data.csv: flat
    want = jeuroc.load_sample_dir(str(tmp_path))
    assert got.timestamps.tolist() == [10, 20, 30]    # 40 has no right image
    assert got.image_paths == want.image_paths and got.gt_positions is None
    pf = teuroc.Prefetcher(got.image_paths, depth=2, workers=2)
    for i in range(3):
        img_l, img_r = pf.get(i)
        assert img_l.shape == img_r.shape == (240, 320)
        np.testing.assert_array_equal(img_l, teuroc.load_image(
            got.image_paths[i][0]))
    # a frame that fails to decode fails the run at get()
    bad = str(tmp_path / "bad.pgm")
    with open(bad, "wb") as f:
        f.write(b"P5\n4 4\n65535\n" + bytes(32))
    pf = teuroc.Prefetcher([(got.image_paths[0][0], bad)], depth=2, workers=1)
    with pytest.raises(ValueError, match="not 8-bit"):
        pf.get(0)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_slam_checkpoint_round_trip(tmp_path, dataset):
    _, seq, _, voc, cfg = dataset
    a = SlamSystem(seq.calib, cfg, device="cpu")
    a.set_vocabulary(voc)
    for pair in seq.images[:8]:
        a.process_frame(*pair)
    path = str(tmp_path / "ckpt")
    checkpoint.save(a, path)
    assert os.path.exists(path + ".npz") and os.path.exists(path + ".json")
    data = np.load(path + ".npz")
    # the reference's layout
    for key in ("lm.pos", "lm.all_kf", "lm.bank_bits", "kf.pose_l", "kf.desc",
                "track.current_pose", "track.vel", "calib.intr0",
                "calib.T_0_1", "voc.meta", "voc.node_desc",
                "torch_generator"):
        assert key in data.files, key
    with open(path + ".json") as f:
        host = json.load(f)
    for key in ("frame", "take_keyframe", "last_kf_slot", "kf_window",
                "slot_of_frame", "covis", "tracking_ok", "trajectory",
                "loop_edges", "pose_graph_done", "db_inverted", "db_bow",
                "consistent_groups", "stats"):
        assert key in host, key
    info_a = a.process_frame(*seq.images[8])

    b = checkpoint.load(SlamSystem(seq.calib, cfg, device="cpu"), path,
                        device="cpu")
    assert b.frame == 8
    assert_vocab_equal(b.voc, voc)
    assert len(b.detector.db.bow_of) == len(b.slot_of_frame) >= 2
    info_b = b.process_frame(*seq.images[8])
    assert info_a == info_b
    assert b.detector.db.bow_of == a.detector.db.bow_of
    assert torch.equal(a.track.current_pose, b.track.current_pose)
    assert torch.equal(a.lm.pos, b.lm.pos)
    assert a.covis == b.covis and a.kf_window == b.kf_window
    for pair in seq.images[9:]:
        assert a.process_frame(*pair) == b.process_frame(*pair)


def test_checkpoint_refuses_another_device(tmp_path, dataset):
    _, seq, _, _, cfg = dataset
    a = SlamSystem(seq.calib, cfg, device="cpu")
    a.process_frame(*seq.images[0])
    path = str(tmp_path / "ckpt")
    checkpoint.save(a, path)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        checkpoint.load(SlamSystem(seq.calib, cfg, device="cpu"), path)
    vo = StreamingVO(seq.calib, cfg, max_frames=8, device="cpu")
    checkpoint.save_stream(vo, path + "_s")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        checkpoint.load_stream(vo, path + "_s")


@pytest.mark.parametrize("kind", ["StreamingSLAM", "StreamingVO"])
def test_stream_checkpoint_round_trip(tmp_path, dataset, kind):
    _, seq, _, voc, cfg = dataset

    def make():
        if kind == "StreamingSLAM":
            return StreamingSLAM(seq.calib, cfg, voc, max_frames=32,
                                 poll_every=4, device="cpu")
        return StreamingVO(seq.calib, cfg, max_frames=32, device="cpu")

    a = make()
    a.run(seq.images[:7])       # a keyframe event may wait for its poll
    a.set_param("match_max_dist", 65)
    path = str(tmp_path / "stream")
    checkpoint.save_stream(a, path)
    with open(path + ".json") as f:
        assert json.load(f)["kind"] == kind
    b = checkpoint.load_stream(make(), path, device="cpu")
    assert b.tune == a.tune and b.tune["match_max_dist"] == 65.0
    assert int(b.state.frame) == 7
    a.run(seq.images[7:])
    b.run(seq.images[7:])
    ra, rb = a.results(), b.results()
    np.testing.assert_array_equal(ra["trajectory"], rb["trajectory"])
    np.testing.assert_array_equal(ra["is_keyframe"], rb["is_keyframe"])
    if kind == "StreamingSLAM":
        assert a.detector.db.bow_of == b.detector.db.bow_of
        assert a.covis_host == b.covis_host
        assert a.frame_of_slot == b.frame_of_slot


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def cli_args(root, tmp_path, name, *extra):
    return ["--device", "cpu", "--dataset-path", str(root / "mav0"),
            "--cam-calib", str(root / "calib.json"),
            "--config", str(root / "cfg.json"),
            "--map-name", str(tmp_path / name),
            "--metrics", str(tmp_path / f"{name}.jsonl"), *extra]


def test_cli_faithful_driver(tmp_path, dataset, capsys):
    root, seq, _, voc, _ = dataset
    tune = tmp_path / "tune.json"
    tune.write_text(json.dumps({"match_max_dist": 65, "num_features": 100,
                                "no_such_field": 1}))
    rc = cli.main(cli_args(root, tmp_path, "map", "--voc-path",
                           str(root / "voc.txt"), "--show-gui", "--trace",
                           str(tmp_path / "trace"), "--tune-file",
                           str(tune)))
    assert rc == 0
    err = capsys.readouterr().err
    assert "Loaded 12 image pairs (with ground truth)" in err
    assert f"Loaded vocabulary: {voc.num_words} words" in err
    assert "[tune] match_max_dist = 65" in err
    assert "[tune] rejected num_features" in err
    assert "[tune] rejected no_such_field" in err
    assert "ATE RMSE" in err and "Saved map as" in err
    slam = cli.LAST_DRIVER
    assert isinstance(slam, SlamSystem) and slam.frame == 12
    assert slam.cfg.match_max_dist == 65
    assert_vocab_equal(slam.voc, voc)
    cams, lms, est, gt, ate_val = tmap_io.load_map(str(tmp_path / "map.json"))
    with open(tmp_path / "map.json") as f:
        assert sorted(json.load(f)) == [f"value{i}" for i in range(5)]
    rows = [json.loads(l) for l in open(tmp_path / "map.jsonl")]
    assert len(rows) == 12 and rows[0]["kind"] == "keyframe"
    assert all("ms" in r and r["frame"] == i for i, r in enumerate(rows))
    n_kf = sum(r["kind"] == "keyframe" for r in rows)
    assert len(cams) == len(est) == n_kf >= 3 and len(gt) == 12
    assert [k for k, _ in cams] == [(r["frame"], 0) for r in rows
                                    if r["kind"] == "keyframe"]
    assert len(lms) == int(slam.lm.valid.sum()) > 100
    assert np.isfinite(ate_val) and ate_val < 0.08
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 1000


def test_cli_control_and_max_frames(tmp_path, dataset):
    root = dataset[0]
    rc = cli.main(cli_args(root, tmp_path, "ctl", "--no-loop", "--no-reloc",
                           "--max-frames", "9"))
    assert rc == 0
    slam = cli.LAST_DRIVER
    assert slam.frame == 9 and slam.voc is None
    assert not slam.cfg.enable_loop_closure
    assert not slam.cfg.enable_relocalization
    assert len(open(tmp_path / "ctl.jsonl").readlines()) == 9
    assert np.isfinite(tmap_io.load_map(str(tmp_path / "ctl.json"))[4])


@pytest.mark.parametrize("with_voc", [True, False])
def test_cli_streaming_driver(tmp_path, dataset, with_voc, capsys):
    root, _, _, voc, _ = dataset
    extra = ["--driver", "streaming"]
    if with_voc:
        extra += ["--voc-path", str(root / "voc.txt")]
    rc = cli.main(cli_args(root, tmp_path, "str", *extra))
    assert rc == 0
    assert "streaming driver" in capsys.readouterr().err
    drv = cli.LAST_DRIVER
    if with_voc:
        assert isinstance(drv, StreamingSLAM)
        assert_vocab_equal(drv.voc, voc)
    else:       # no vocabulary: plain VO, loop closure and reloc off
        assert type(drv) is StreamingVO
        assert not drv.cfg.enable_loop_closure
    cams, lms, est, gt, ate_val = tmap_io.load_map(str(tmp_path / "str.json"))
    rows = [json.loads(l) for l in open(tmp_path / "str.jsonl")]
    assert len(rows) == 12 and set(rows[0]) == {"frame", "kind", "inliers",
                                                "ok"}
    assert len(cams) == sum(r["kind"] == "keyframe" for r in rows) >= 3
    assert len(lms) > 100 and np.isfinite(ate_val) and ate_val < 0.08


def _help_text():
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        cli.main(["--help"])
    return buf.getvalue()


def test_cli_defaults_to_the_card_and_refuses_unported_flags(tmp_path,
                                                              dataset):
    root = dataset[0]
    args = cli_args(root, tmp_path, "x")
    if not torch.cuda.is_available():
        for extra in ([], ["--driver", "streaming"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cli.main(args[2:] + extra)      # without --device cpu
    # the viewer and overlay flags are accepted now (test_torch_reporting
    # runs them); a flag the reference does not have is still refused
    help_text = _help_text()
    for flag in ("--viz-html", "--overlay-every", "--overlay-dir"):
        assert flag in help_text, flag
    with pytest.raises(SystemExit):
        cli.main(args + ["--no-such-flag"])


def test_python_dash_m_runs_the_cli():
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "vslam_tpu_torch.cli",
                          "--help"], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0
    for flag in ("--dataset-path", "--cam-calib", "--voc-path", "--map-name",
                 "--show-gui", "--config", "--max-frames", "--no-loop",
                 "--no-reloc", "--metrics", "--trace", "--driver",
                 "--tune-file", "--device", "--viz-html", "--overlay-every",
                 "--overlay-dir"):
        assert flag in out.stdout, flag


# ---------------------------------------------------------------------------
# metrics and profiling
# ---------------------------------------------------------------------------

def test_stage_timer_and_metrics_logger(tmp_path):
    timer = metrics.StageTimer()
    for _ in range(3):
        with timer.stage("track"):
            pass
    with pytest.raises(KeyError):
        with timer.stage("keyframe"):
            raise KeyError("x")         # still counted
    s = timer.summary()
    assert list(s) == ["keyframe", "track"]
    assert s["track"]["count"] == 3 and s["keyframe"]["count"] == 1
    assert set(s["track"]) == {"total_s", "count", "mean_ms"}
    path = tmp_path / "m.jsonl"
    log = metrics.MetricsLogger(str(path))
    log.log({"frame": 0, "ok": True})
    log.log({"frame": 1, "ok": False})
    log.close()
    log.close()
    assert [json.loads(l)["frame"] for l in open(path)] == [0, 1]
    metrics.MetricsLogger(None).log({"frame": 0})       # a no-op


def test_profiling_trace_and_annotate(tmp_path):
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("stage-under-test"):
            torch.ones(8).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "stage-under-test" for e in events)
    stats = profiling.device_memory_stats()
    assert isinstance(stats, dict)
    assert len(stats) == torch.cuda.device_count()
