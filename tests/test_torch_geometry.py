"""Parity of the port's geometry (lie, cameras, triangulation) with the JAX
package on random inputs made with numpy: atol 1e-5 (float32 throughout;
the two frameworks may order a few float operations differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.geometry import cameras as jcam
from vslam_tpu.geometry import lie as jlie
from vslam_tpu.geometry import triangulate as jtri
from vslam_tpu_torch.geometry import cameras as tcam
from vslam_tpu_torch.geometry import lie as tlie
from vslam_tpu_torch.geometry import triangulate as ttri

ATOL = 1e-5


def random_poses(rng, n, t_scale=2.0):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(scale=t_scale, size=(n, 3)).astype(np.float32)
    return np.concatenate([t, q], axis=1)


def both(fn_jax, fn_torch, *arrays):
    """Run the JAX and the torch function on the same float32 arrays."""
    a = np.asarray(fn_jax(*[jnp.asarray(x) for x in arrays]))
    b = fn_torch(*[torch.as_tensor(x) for x in arrays]).numpy()
    return a, b


@pytest.mark.parametrize("name", [
    "se3_mul", "se3_inv", "se3_apply", "se3_log", "se3_exp", "se3_retract",
    "quat_to_matrix", "matrix_to_quat", "so3_exp_quat", "so3_log", "hat",
    "se3_matrix"])
def test_lie_matches_jax(name):
    rng = np.random.RandomState(0)
    T1 = random_poses(rng, 64)
    T2 = random_poses(rng, 64)
    pts = rng.normal(scale=3.0, size=(64, 3)).astype(np.float32)
    # twists include the small-angle Taylor branch and exact zeros
    xi = rng.normal(scale=0.5, size=(64, 6)).astype(np.float32)
    xi[:8, 3:] *= 1e-5
    xi[8:12] = 0.0
    args = {
        "se3_mul": (T1, T2), "se3_inv": (T1,), "se3_apply": (T1, pts),
        "se3_log": (T1,), "se3_exp": (xi,), "se3_retract": (T1, xi),
        "quat_to_matrix": (T1[:, 3:],),
        "matrix_to_quat": (np.asarray(jlie.quat_to_matrix(
            jnp.asarray(T1[:, 3:]))),),
        "so3_exp_quat": (xi[:, 3:],), "so3_log": (T1[:, 3:],),
        "hat": (xi[:, :3],), "se3_matrix": (T1,),
    }[name]
    a, b = both(getattr(jlie, name), getattr(tlie, name), *args)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)


INTR = {
    "pinhole": [458.0, 457.0, 367.0, 248.0, 0, 0, 0, 0],
    "eucm": [460.0, 459.0, 365.0, 249.0, 0.6, 1.1, 0, 0],
    "ds": [349.0, 348.0, 365.0, 249.0, -0.2, 0.56, 0, 0],
    "kb4": [460.0, 459.0, 365.0, 249.0, -0.01, 0.003, -0.002, 0.0005],
}


@pytest.mark.parametrize("model", sorted(INTR))
def test_cameras_match_jax(model):
    rng = np.random.RandomState(1)
    intr = np.asarray(INTR[model], np.float32)
    pts = np.concatenate([rng.uniform(-2, 2, (256, 2)),
                          rng.uniform(0.5, 6.0, (256, 1))], 1).astype(
                              np.float32)
    uv = (rng.uniform(0, 1, (256, 2)) * [752, 480]).astype(np.float32)
    a, b = both(lambda i, p: jcam.project(model, i, p),
                lambda i, p: tcam.project(model, i, p), intr, pts)
    # pixel coordinates in the hundreds: 1e-5 relative
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=ATOL)
    a, b = both(lambda i, p: jcam.unproject(model, i, p),
                lambda i, p: tcam.unproject(model, i, p), intr, uv)
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)


def test_triangulate_matches_jax():
    rng = np.random.RandomState(2)
    T_0_1 = np.asarray([0.11, 0.002, -0.001, 0.001, 0.002, 0.0005, 1.0],
                       np.float32)
    T_0_1[3:] /= np.linalg.norm(T_0_1[3:])
    X = np.concatenate([rng.uniform(-2, 2, (300, 2)),
                        rng.uniform(1.0, 8.0, (300, 1))], 1).astype(
                            np.float32)
    X[:5] = X[5:10] * [1, 1, -1]          # behind the cameras: invalid
    f0 = X / np.linalg.norm(X, axis=1, keepdims=True)
    X1 = np.asarray(jlie.se3_apply(jlie.se3_inv(jnp.asarray(T_0_1)),
                                   jnp.asarray(X)))
    f1 = X1 / np.linalg.norm(X1, axis=1, keepdims=True)
    pj, vj = jtri.triangulate_midpoint(jnp.asarray(f0), jnp.asarray(f1),
                                       jnp.asarray(T_0_1))
    pt, vt = ttri.triangulate_midpoint(torch.as_tensor(f0),
                                       torch.as_tensor(f1),
                                       torch.as_tensor(T_0_1))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    ok = np.asarray(vj)
    # depths up to 8 m: 1e-5 relative
    np.testing.assert_allclose(pt.numpy()[ok], np.asarray(pj)[ok],
                               rtol=1e-5, atol=ATOL)
