"""The port's package boundary and host copies.

- ``vslam_tpu_torch`` imports neither JAX nor ``vslam_tpu`` (the machine
  with the card has no JAX);
- the host modules it copies (config, calibration I/O, ATE, the BRIEF
  pattern, the synthetic world generator) match their originals;
- state constructors, compaction and the tie-stable top-k match the JAX
  package's; device selection refuses a missing card.
"""

import dataclasses
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from vslam_tpu import config as jconfig
from vslam_tpu import synthetic as jsyn
from vslam_tpu.core import state as jstate
from vslam_tpu.eval import ate as jate
from vslam_tpu.io import calib as jcalib
from vslam_tpu.ops import compact as jcompact
from vslam_tpu.ops import pattern as jpattern
import vslam_tpu_torch
from vslam_tpu_torch import config as tconfig
from vslam_tpu_torch import interop
from vslam_tpu_torch import synthetic as tsyn
from vslam_tpu_torch.core import state as tstate
from vslam_tpu_torch.eval import ate as tate
from vslam_tpu_torch.io import calib as tcalib
from vslam_tpu_torch.ops import compact as tcompact
from vslam_tpu_torch.ops import pattern as tpattern


def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import sys
        import vslam_tpu_torch
        from vslam_tpu_torch import interop, synthetic
        from vslam_tpu_torch.ops import cuda_hamming
        from vslam_tpu_torch.pipeline import streaming
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "vslam_tpu"))
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


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
