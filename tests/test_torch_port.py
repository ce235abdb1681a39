"""The port's package boundary and host copies.

- ``vslam_tpu_torch`` imports neither JAX nor ``vslam_tpu`` (the machine
  with the card has no JAX);
- the host modules it copies (config, calibration I/O, ATE, the BRIEF
  pattern, the synthetic world generators and photometric/texture
  generators, the loop detector, the vocabulary's numpy part with its
  DBoW2 text writer, the map and dataset readers, the stage timers, the
  command line's tuner, the viewers, feature tracks, the native binding
  and the calibration grid) match their originals;
- state constructors, compaction and the tie-stable top-k match the JAX
  package's; device selection refuses a missing card.
"""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from vslam_tpu import cli as jcli
from vslam_tpu import config as jconfig
from vslam_tpu import synthetic as jsyn
from vslam_tpu import synthetic_pano as jpano
from vslam_tpu.core import state as jstate
from vslam_tpu.eval import ate as jate
from vslam_tpu.io import calib as jcalib
from vslam_tpu.io import euroc as jeuroc
from vslam_tpu.io import map_io as jmap_io
from vslam_tpu.io import native as jnative
from vslam_tpu.loop import detector as jdetector
from vslam_tpu.loop import vocabulary as jvocab
from vslam_tpu.ops import compact as jcompact
from vslam_tpu.ops import pattern as jpattern
from vslam_tpu.tools import calibrate as jcalibrate
from vslam_tpu.utils import metrics as jmetrics
from vslam_tpu.utils import tracks as jtracks
from vslam_tpu.viz import html_viewer as jhtml
from vslam_tpu.viz import overlays as joverlays
from vslam_tpu.viz import plot_map as jplot
import vslam_tpu_torch
from vslam_tpu_torch import cli as tcli
from vslam_tpu_torch import config as tconfig
from vslam_tpu_torch import interop
from vslam_tpu_torch import synthetic as tsyn
from vslam_tpu_torch import synthetic_pano as tpano
from vslam_tpu_torch.core import state as tstate
from vslam_tpu_torch.eval import ate as tate
from vslam_tpu_torch.io import calib as tcalib
from vslam_tpu_torch.io import euroc as teuroc
from vslam_tpu_torch.io import map_io as tmap_io
from vslam_tpu_torch.io import native as tnative
from vslam_tpu_torch.loop import detector as tdetector
from vslam_tpu_torch.loop import vocabulary as tvocab
from vslam_tpu_torch.ops import compact as tcompact
from vslam_tpu_torch.ops import pattern as tpattern
from vslam_tpu_torch.tools import calibrate as tcalibrate
from vslam_tpu_torch.utils import metrics as tmetrics
from vslam_tpu_torch.utils import tracks as ttracks
from vslam_tpu_torch.viz import html_viewer as thtml
from vslam_tpu_torch.viz import overlays as toverlays
from vslam_tpu_torch.viz import plot_map as tplot


def test_port_imports_no_jax():
    """Every module of the package, imported in a fresh interpreter, leaves
    neither JAX nor the JAX package loaded."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import vslam_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            vslam_tpu_torch.__path__, "vslam_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert len(names) > 40, names
        for must in ("vslam_tpu_torch.cli", "vslam_tpu_torch.pipeline.slam",
                     "vslam_tpu_torch.utils.checkpoint",
                     "vslam_tpu_torch.solvers.ba_cg",
                     "vslam_tpu_torch.parallel.mesh",
                     "vslam_tpu_torch.parallel.sharded_ba",
                     "vslam_tpu_torch.parallel.multiseq",
                     "vslam_tpu_torch.parallel.multiseq_runner",
                     "vslam_tpu_torch.models.superpoint",
                     "vslam_tpu_torch.models.learned_frontend",
                     "vslam_tpu_torch.pipeline.projections",
                     "vslam_tpu_torch.pipeline.sfm",
                     "vslam_tpu_torch.solvers.relative_pose",
                     "vslam_tpu_torch.tools.calibrate",
                     "vslam_tpu_torch.tools.view_dataset",
                     "vslam_tpu_torch.tools.bench_worlds",
                     "vslam_tpu_torch.tools.profile_stages",
                     "vslam_tpu_torch.tools.profile_kf_branch",
                     "vslam_tpu_torch.tools.bench_gba_scale",
                     "vslam_tpu_torch.tools.bench_vocab",
                     "vslam_tpu_torch.tools.ablation_reloc",
                     "vslam_tpu_torch.bench",
                     "vslam_tpu_torch.viz.overlays",
                     "vslam_tpu_torch.viz.html_viewer",
                     "vslam_tpu_torch.viz.plot_map",
                     "vslam_tpu_torch.io.native",
                     "vslam_tpu_torch.utils.tracks"):
            assert must in names, must
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "vslam_tpu"))
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _imported_roots(path):
    """Top-level names a source file imports, wherever the statement is."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_file_of_the_port_names_jax():
    """The same, read from the sources: imports inside functions count."""
    pkg = os.path.dirname(vslam_tpu_torch.__file__)
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")]
    files += [os.path.join(os.path.dirname(pkg), f)
              for f in ("chip_smoke.py", "tools/learned_vo_sweep.py")]
    assert len(files) > 50
    assert sum(os.sep + "parallel" + os.sep in f for f in files) == 5
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "flax", "vslam_tpu"}
        assert not bad, (path, bad)


def test_precision_pins():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_resolve_device():
    assert vslam_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            vslam_tpu_torch.resolve_device("cuda")


def test_config_copy_matches():
    ja = {f.name: (f.default, f.default_factory)
          for f in dataclasses.fields(jconfig.SlamConfig)}
    tb = {f.name: (f.default, f.default_factory)
          for f in dataclasses.fields(tconfig.SlamConfig)}
    assert ja == tb
    assert tconfig.DEVICE_TUNABLE == jconfig.DEVICE_TUNABLE
    assert tconfig.TUNE_INDEX == jconfig.TUNE_INDEX
    assert tconfig.HOST_TUNABLE == jconfig.HOST_TUNABLE
    assert (tconfig.SlamConfig().tune_vector()
            == jconfig.SlamConfig().tune_vector())
    assert set(tconfig.DEVICE_TUNE_TRANSFORM) == set(
        jconfig.DEVICE_TUNE_TRANSFORM)
    for name, fn in tconfig.DEVICE_TUNE_TRANSFORM.items():
        for v in (0.5, 3.0, 7.25):
            assert fn(v) == jconfig.DEVICE_TUNE_TRANSFORM[name](v)


def test_pattern_copy_matches():
    np.testing.assert_array_equal(tpattern.PATTERN_A, jpattern.PATTERN_A)
    np.testing.assert_array_equal(tpattern.PATTERN_B, jpattern.PATTERN_B)
    assert tpattern.PATTERN_A.dtype == jpattern.PATTERN_A.dtype
    assert tpattern.HALF_PATCH_SIZE == jpattern.HALF_PATCH_SIZE
    assert tpattern.EDGE_THRESHOLD == jpattern.EDGE_THRESHOLD


@pytest.mark.parametrize("kw", [
    dict(num_frames=6, num_points=300, seed=3),
    dict(num_frames=4, num_points=400, width=752, height=480, seed=2,
         speed=3.0)])
def test_synthetic_copy_byte_equal(kw):
    a = jsyn.generate(**kw)
    b = tsyn.generate(**kw)
    assert len(a.images) == len(b.images)
    for (la, ra), (lb, rb) in zip(a.images, b.images):
        assert la.tobytes() == lb.tobytes() and ra.tobytes() == rb.tobytes()
    assert a.poses.tobytes() == b.poses.tobytes()
    assert a.calib.T_i_c.tobytes() == b.calib.T_i_c.tobytes()
    assert a.calib.intrinsics.tobytes() == b.calib.intrinsics.tobytes()
    assert a.calib.cam_types == b.calib.cam_types


def test_synthetic_non_pinhole_projection_matches():
    """The non-pinhole worlds project through the port's cameras."""
    a = jsyn.generate(num_frames=3, num_points=200, seed=4, cam_type="ds")
    b = tsyn.generate(num_frames=3, num_points=200, seed=4, cam_type="ds")
    for (la, _), (lb, _) in zip(a.images, b.images):
        # a splat may land one pixel over when a projected coordinate
        # rounds apart in float32: nearly every pixel is equal
        assert (la == lb).mean() > 0.99


def test_calib_and_ate_copies_match(tmp_path):
    calib = tsyn.make_calib(320, 240)
    path = str(tmp_path / "calib.json")
    tcalib.save_calibration(calib, path)
    ja, tb = jcalib.load_calibration(path), tcalib.load_calibration(path)
    np.testing.assert_array_equal(ja.T_i_c, tb.T_i_c)
    np.testing.assert_array_equal(ja.intrinsics, tb.intrinsics)
    assert ja.cam_types == tb.cam_types
    rng = np.random.RandomState(0)
    gt = rng.normal(size=(50, 3))
    est = gt @ np.diag([1, -1, -1]) + 0.3 + rng.normal(0, 0.01, (50, 3))
    for x, y in zip(jate.align_svd(est, gt), tate.align_svd(est, gt)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_state_init_matches_jax():
    for jfn, tfn, kw in [
            (jstate.init_landmarks, tstate.init_landmarks,
             dict(L=64, M=24, M2=48, B=4)),
            (jstate.init_keyframes, tstate.init_keyframes, dict(K=8, N=40))]:
        want = jfn(**kw)._asdict()
        got = interop.to_arrays(tfn(**kw))
        assert set(got) == set(want)
        for name, value in got.items():
            ref = np.asarray(want[name])
            assert value.shape == ref.shape, name
            assert value.dtype == ref.dtype, name
            np.testing.assert_array_equal(value, ref, err_msg=name)


@pytest.mark.parametrize("newest_first", [False, True])
def test_compact_indices_matches_jax(newest_first):
    valid = np.random.RandomState(1).rand(300) < 0.3
    for k in (10, 90, 400):
        ij, vj = jcompact.compact_indices(jnp.asarray(valid), k,
                                          newest_first=newest_first)
        it, vt = tcompact.compact_indices(torch.as_tensor(valid), k,
                                          newest_first=newest_first)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_top_k_is_tie_stable_like_lax():
    rng = np.random.RandomState(2)
    x = rng.randint(0, 5, (4, 200)).astype(np.float32)   # many ties
    x[0, :50] = -np.inf
    vj, ij = lax.top_k(jnp.asarray(x), 60)
    vt, it = tcompact.top_k(torch.as_tensor(x), 60)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("kw", [
    dict(num_frames=5, revolutions=1.75 * 5 / 256, seed=2),
    dict(num_frames=3, width=752, height=480, revolutions=0.1, seed=2)])
def test_synthetic_pano_copy_byte_equal(kw):
    a = jpano.generate_pano_loop(**kw)
    b = tpano.generate_pano_loop(**kw)
    assert len(a.images) == len(b.images) == kw["num_frames"]
    for (la, ra), (lb, rb) in zip(a.images, b.images):
        assert la.tobytes() == lb.tobytes() and ra.tobytes() == rb.tobytes()
    assert a.poses.tobytes() == b.poses.tobytes()
    assert a.calib.intrinsics.tobytes() == b.calib.intrinsics.tobytes()


def test_detector_copy_is_the_original():
    """The detector's candidate order comes from dict and set iteration,
    so the copy is held to the original's source, line for line."""
    assert inspect.getsource(tdetector) == inspect.getsource(jdetector)


@pytest.mark.parametrize("name", [
    "Vocabulary", "_hamming_np", "_kmajority", "train", "synthetic_vocab",
    "set_idf_weights", "transform_np", "bow_from_words", "l1_score"])
def test_vocabulary_host_copy_is_the_original(name):
    assert inspect.getsource(getattr(tvocab, name)) == \
        inspect.getsource(getattr(jvocab, name))


def test_synthetic_vocab_and_transform_equal():
    vj = jvocab.synthetic_vocab(k=4, depth=3, seed=1)
    vt = tvocab.synthetic_vocab(k=4, depth=3, seed=1)
    for f in dataclasses.fields(vj):
        np.testing.assert_array_equal(getattr(vt, f.name),
                                      getattr(vj, f.name), err_msg=f.name)
    descs = np.random.RandomState(2).randint(0, 2, (50, 256)).astype(np.uint8)
    for x, y in zip(tvocab.transform_np(vt, descs),
                    jvocab.transform_np(vj, descs)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("port,orig,names", [
    (tmap_io, jmap_io, ("_pose_dict", "_vec3_dict", "save_map", "load_map")),
    (teuroc, jeuroc, ("EurocSequence", "_read_timestamp_csv", "_read_gt_csv",
                      "load_sequence", "load_sample_dir")),
    (tmetrics, jmetrics, ("StageTimer", "MetricsLogger")),
    (tvocab, jvocab, ("_vocab_from_flat", "save_dbow2_text")),
    (tcli, jcli, ("_make_tuner",)),
    (toverlays, joverlays, ("_to_rgb", "_draw_cross", "_draw_circle",
                            "_draw_line", "draw_keypoints", "draw_matches",
                            "draw_reprojections", "save_png")),
    (thtml, jhtml, ("_ds", "write_html")),
    (tplot, jplot, ("plot",)),
    (ttracks, jtracks, ("UnionFind", "build_tracks", "tracks_in_images")),
    (tnative, jnative, ("_load", "available", "decode_gray",
                        "parse_vocab_text")),
    (tcalibrate, jcalibrate, ("aprilgrid_points",)),
    (tsyn, jsyn, ("_splat", "degrade", "multiscale_texture",
                  "render_plane_view")),
], ids=["map_io", "euroc", "metrics", "vocabulary_text", "cli_tuner",
        "overlays", "html_viewer", "plot_map", "tracks", "native",
        "calibration_grid", "generators"])
def test_host_copies_of_the_io_slice_are_the_originals(port, orig, names):
    for name in names:
        assert inspect.getsource(getattr(port, name)) == \
            inspect.getsource(getattr(orig, name)), name


def test_cli_flags_are_the_reference_s_minus_the_unported():
    """The port's parser accepts every flag of the reference's, plus
    --device."""
    def flags(mod):
        src = inspect.getsource(mod.main)
        tree = ast.parse(textwrap.dedent(src))
        return {n.args[0].value for n in ast.walk(tree)
                if isinstance(n, ast.Call)
                and getattr(n.func, "attr", "") == "add_argument"}

    assert flags(jcli) - flags(tcli) == set()
    assert flags(tcli) - flags(jcli) == {"--device"}


def test_parallel_host_parts_match_the_reference():
    """What ``parallel/`` keeps on the host: ``pack_frames`` packs as the
    reference's does, and ``make_mesh`` follows its shape rule (one axis:
    (n,); two axes: the second gets 2 when n is even and at least 4)."""
    from vslam_tpu.parallel.multiseq_runner import MultiSeqVO as JaxMultiSeq
    from vslam_tpu_torch.parallel.mesh import make_mesh
    from vslam_tpu_torch.parallel.multiseq_runner import MultiSeqVO

    rng = np.random.RandomState(0)
    frames = [(rng.randint(0, 255, (3, 8, 10)).astype(np.uint8),
               rng.randint(0, 255, (3, 8, 10)).astype(np.uint8))
              for _ in range(4)]
    a, b = MultiSeqVO.pack_frames(frames), JaxMultiSeq.pack_frames(frames)
    assert a.shape == (4, 2, 3, 8, 10) and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes() and a.flags["C_CONTIGUOUS"]
    for n, want in ((1, (1, 1)), (2, (2, 1)), (4, (2, 2)), (6, (3, 2)),
                    (8, (4, 2))):
        mesh = make_mesh(n, axes=("data", "model"), devices=["cpu"] * n)
        assert mesh.devices.shape == want
        assert make_mesh(n, devices=["cpu"] * n).shape == {"data": n}


def test_host_copies_keep_the_originals_values():
    """Module-level values of the copies: the overlay colours, the viewer's
    page and caps, the native library's path (resolved from the repository
    root in both packages)."""
    for name in ("GREEN", "RED", "BLUE", "YELLOW"):
        np.testing.assert_array_equal(getattr(toverlays, name),
                                      getattr(joverlays, name))
    assert thtml._TEMPLATE == jhtml._TEMPLATE
    assert thtml._MAX_LANDMARKS == jhtml._MAX_LANDMARKS
    assert tnative._LIB_PATH == jnative._LIB_PATH
    assert tnative._MAX_BYTES == jnative._MAX_BYTES
