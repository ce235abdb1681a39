"""Parity of the port's feature frontend (detect, describe, features) with
the JAX package on synthetic frames.

Tolerances: the same corner set (the Shi-Tomasi response is built from
exact integer sums up to one square root, and the top-k is tie-stable on
both sides); orientations within 1e-4 rad; descriptor bits equal on at
least 99.9% of (corner, bit) pairs: a rotated tap sits on a .5 rounding
boundary rarely, and float32 sin/cos of the two libraries can put it on
either side. Flipped taps are printed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu import synthetic as jsyn
from vslam_tpu.frontend import features as jfeat
from vslam_tpu.ops import describe as jdesc
from vslam_tpu.ops import detect as jdet
from vslam_tpu_torch.frontend import features as tfeat
from vslam_tpu_torch.ops import describe as tdesc
from vslam_tpu_torch.ops import detect as tdet


@pytest.fixture(scope="module")
def frames():
    seq = jsyn.generate(num_frames=3, num_points=400, width=320, height=240,
                        seed=5)
    return [img for pair in seq.images for img in pair]


def check_bits(bits_t, bits_j, valid):
    agree = (bits_t == bits_j)[valid]
    flips = np.argwhere(~agree)
    if len(flips):
        print(f"flipped (corner, bit) taps: {flips.tolist()}")
    assert agree.mean() >= 0.999, agree.mean()


def test_shi_tomasi_response_matches_jax(frames):
    img = frames[0].astype(np.float32)
    rj = np.asarray(jdet.shi_tomasi_response(jnp.asarray(img)))
    rt = tdet.shi_tomasi_response(torch.as_tensor(img)).numpy()
    # the structure-tensor sums are exact integers, but d*d + sxy*sxy
    # passes float32's exact integers, so the two libraries' square roots
    # and fused multiply-adds differ by an ulp, and the final subtraction
    # cancels: one part in 1e6 of the largest response
    np.testing.assert_allclose(rt, rj, rtol=0,
                               atol=1e-6 * np.abs(rj).max())


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_detect_matches_jax(frames, k):
    img = frames[k]
    cj, rj, vj = (np.asarray(x) for x in jdet.detect_corners(
        jnp.asarray(img), num_features=400))
    ct, rt, vt = (x.numpy() for x in tdet.detect_corners(
        torch.as_tensor(img), num_features=400))
    assert vt.sum() > 100
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_allclose(rt, rj, rtol=1e-5)


@pytest.mark.parametrize("rotate", [True, False])
def test_describe_matches_jax(frames, rotate):
    img = frames[1]
    corners, _, valid = jdet.detect_corners(jnp.asarray(img),
                                            num_features=400)
    aj, bj = (np.asarray(x) for x in jdesc.describe(
        jnp.asarray(img), corners, rotate_features=rotate))
    at, bt = (x.numpy() for x in tdesc.describe(
        torch.as_tensor(img), torch.as_tensor(np.asarray(corners)),
        rotate_features=rotate))
    v = np.asarray(valid)
    np.testing.assert_allclose(at[v], aj[v], atol=1e-4, rtol=0)
    check_bits(bt, bj, v)


@pytest.mark.parametrize("octaves", [1, 2])
def test_extract_features_matches_jax(frames, octaves):
    for img in frames[2:4]:
        fj = jfeat.extract_features(jnp.asarray(img), num_features=400,
                                    num_octaves=octaves)
        ft = tfeat.extract_features(torch.as_tensor(img), num_features=400,
                                    num_octaves=octaves)
        v = np.asarray(fj.valid)
        np.testing.assert_array_equal(ft.valid.numpy(), v)
        np.testing.assert_array_equal(ft.corners.numpy(),
                                      np.asarray(fj.corners))
        np.testing.assert_array_equal(ft.octave.numpy(),
                                      np.asarray(fj.octave))
        np.testing.assert_allclose(ft.angles.numpy()[v],
                                   np.asarray(fj.angles)[v], atol=1e-4,
                                   rtol=0)
        check_bits(ft.bits.numpy(), np.asarray(fj.bits), v)
        # invalid slots carry zero bits on both sides
        assert not ft.bits.numpy()[~v].any()


def test_gather_patches_clamps_out_of_range(frames):
    img = torch.as_tensor(frames[0])
    corners = torch.tensor([[-1.0, -1.0], [1000.0, 1000.0], [50.0, 60.0]])
    p = tdesc.gather_patches(img, corners)
    pj = np.asarray(jdesc.gather_patches(jnp.asarray(frames[0]),
                                         jnp.asarray(corners.numpy()),
                                         use_mxu=False))
    np.testing.assert_array_equal(p.numpy(), pj)
