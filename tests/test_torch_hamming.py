"""Parity of the port's Hamming matching with the JAX package.

The plain PyTorch versions of the two kernels (``landmark_top2_plain``,
``hamming_top2_plain``) are held against the Pallas kernels run with
``interpret=True`` (as tests/test_pallas_hamming.py runs them) and against
the JAX CPU matchers. Distances are exact integers, so every comparison is
exact; the argmin must agree wherever the best distance is strict.

The one documented split: ``any_candidate``. The JAX CPU path (which the
JAX tests pin) reports "some valid landmark inside the 2D gate"; the
Pallas path also requires a valid bank slot. The port follows the CPU
path, so its flag is compared with the Pallas one only on landmarks whose
banks are all valid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.ops import hamming as jham
from vslam_tpu.ops import pallas_hamming as jpal
from vslam_tpu_torch.ops import describe as tdesc
from vslam_tpu_torch.ops import hamming as tham


def t(x):
    return torch.as_tensor(np.asarray(x))


def top2_inputs(n, m, seed, valid_a=0.9, valid_b=0.9):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 2, (n, 256)).astype(np.uint8)
    b = rng.randint(0, 2, (m, 256)).astype(np.uint8)
    if n and m:
        # half of B are noisy copies of rows of A: small distances and ties
        src = rng.randint(0, n, m // 2)
        flip = rng.rand(m // 2, 256) < 0.05
        b[: m // 2] = np.where(flip, 1 - a[src], a[src])
    return a, b, rng.rand(n) < valid_a, rng.rand(m) < valid_b


def landmark_inputs(n, p, bank, seed, bank_valid=0.8, lm_valid=0.9):
    rng = np.random.RandomState(seed)
    kp = rng.randint(0, 2, (n, 256)).astype(np.uint8)
    src = rng.randint(0, n, (p, bank))
    flip = rng.rand(p, bank, 256) < 0.08
    banks = np.where(flip, 1 - kp[src], kp[src]).astype(np.uint8)
    kxy = (rng.rand(n, 2) * 300).astype(np.float32)
    lxy = (kxy[src[:, 0]] + rng.normal(0, 25, (p, 2))).astype(np.float32)
    return (kp, rng.rand(n) > 0.1, kxy, banks, rng.rand(p, bank) < bank_valid,
            lxy, rng.rand(p) < lm_valid)


def strict_rows(best, second, valid):
    return (best < second) & valid & (best < 256)


# the ragged shapes of tests/test_pallas_hamming.py, plus tile edges
@pytest.mark.parametrize("n,m", [(100, 300), (128, 512), (130, 600),
                                 (1, 1), (257, 129)])
def test_hamming_top2_matches_pallas(n, m):
    a, b, va, vb = top2_inputs(n, m, n + m)
    pb1, pb2, parg = (np.asarray(x) for x in jpal.hamming_top2(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb),
        interpret=True))
    b1, b2, arg = (x.numpy() for x in tham.hamming_top2_plain(
        t(a), t(b), t(va), t(vb)))
    np.testing.assert_array_equal(b1, pb1)
    np.testing.assert_array_equal(b2, pb2)
    s = strict_rows(b1, b2, va)
    np.testing.assert_array_equal(arg[s], parg[s])
    assert b1.dtype == np.int32 and arg.dtype == np.int32


def test_hamming_top2_all_invalid_columns():
    a, b, va, _ = top2_inputs(32, 64, 0)
    vb = np.zeros(64, bool)
    pb1, pb2, _ = jpal.hamming_top2(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(va), jnp.asarray(vb),
                                    interpret=True)
    b1, b2, arg = tham.hamming_top2_plain(t(a), t(b), t(va), t(vb))
    assert int(b1.min()) == 256 and int(b2.min()) == 256
    np.testing.assert_array_equal(b1.numpy(), np.asarray(pb1))
    np.testing.assert_array_equal(b2.numpy(), np.asarray(pb2))


@pytest.mark.parametrize("n,p,bank", [(100, 300, 4), (128, 512, 4),
                                      (130, 600, 3), (7, 1, 4)])
def test_landmark_top2_matches_pallas(n, p, bank):
    kp, kv, kxy, banks, bv, lxy, lv = landmark_inputs(n, p, bank, n + p)
    r = 40.0
    jb1, jb2, jarg, jany = (np.asarray(x) for x in jpal.landmark_top2(
        *(jnp.asarray(x) for x in (kp, kv, kxy, banks, bv, lxy, lv)), r,
        interpret=True))
    b1, b2, arg, any_c = (x.numpy() for x in tham.landmark_top2_plain(
        *(t(x) for x in (kp, kv, kxy, banks, bv, lxy, lv)), r))
    np.testing.assert_array_equal(b1, jb1)
    np.testing.assert_array_equal(b2, jb2)
    s = strict_rows(b1, b2, kv)
    np.testing.assert_array_equal(arg[s], jarg[s])
    # any_candidate: the port (CPU-path semantics) may only ADD rows whose
    # gated landmarks all have empty banks
    assert not (jany & ~any_c).any()
    full = landmark_inputs(n, p, bank, n + p, bank_valid=1.0)
    fj = np.asarray(jpal.landmark_top2(
        *(jnp.asarray(x) for x in full), r, interpret=True)[3])
    ft = tham.landmark_top2_plain(*(t(x) for x in full), r)[3].numpy()
    np.testing.assert_array_equal(ft, fj)


def test_landmark_top2_all_invalid():
    kp, kv, kxy, banks, bv, lxy, lv = landmark_inputs(64, 256, 4, 3)
    for bv_, lv_ in [(bv, np.zeros_like(lv)), (np.zeros_like(bv), lv)]:
        b1, b2, _, any_c = tham.landmark_top2_plain(
            *(t(x) for x in (kp, kv, kxy, banks, bv_, lxy, lv_)), 40.0)
        jb1, jb2, _, _ = jpal.landmark_top2(
            *(jnp.asarray(x) for x in (kp, kv, kxy, banks, bv_, lxy, lv_)),
            40.0, interpret=True)
        assert int(b1.min()) == 256 and int(b2.min()) == 256
        np.testing.assert_array_equal(b1.numpy(), np.asarray(jb1))
        np.testing.assert_array_equal(b2.numpy(), np.asarray(jb2))
    # no valid landmark: no candidate; valid landmarks with empty banks
    # still count as candidates (the JAX CPU path)
    assert not tham.landmark_top2_plain(
        *(t(x) for x in (kp, kv, kxy, banks, bv, lxy, np.zeros_like(lv))),
        40.0)[3].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_match_descriptors_matches_jax_cpu(seed):
    a, b, va, vb = top2_inputs(300, 280, seed)
    jm, jacc = jham.match_descriptors(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(va), jnp.asarray(vb))
    tm, tacc = tham.match_descriptors(t(a), t(b), t(va), t(vb))
    assert int(tacc.sum()) > 50
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # the kernel route (top-2 both ways, then the mutual/ratio tests) on
    # the plain top-2 gives the same matches
    row = tham.hamming_top2_plain(t(a), t(b), t(va), t(vb))
    col = tham.hamming_top2_plain(t(b), t(a), t(vb), t(va))
    km, kacc = tham._mutual(*row, *col, 70, 1.2)
    np.testing.assert_array_equal(km.numpy(), tm.numpy())
    np.testing.assert_array_equal(kacc.numpy(), tacc.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_match_landmarks_matches_jax_cpu(seed):
    kp, kv, kxy, banks, bv, lxy, lv = landmark_inputs(400, 512, 4, seed)
    jm, jok, jany = jham.match_landmarks(
        jnp.asarray(kp), jnp.asarray(kv), jnp.asarray(banks),
        jnp.asarray(bv), jnp.asarray(kxy), jnp.asarray(lxy), jnp.asarray(lv),
        max_dist_2d=20.0)
    tm, tok, tany = tham.match_landmarks(
        t(kp), t(kv), t(banks), t(bv), t(kxy), t(lxy), t(lv),
        max_dist_2d=20.0)
    assert int(tok.sum()) > 50
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tany.numpy(), np.asarray(jany))


def test_distance_matrix_and_packing_match_jax():
    a, b, va, vb = top2_inputs(50, 70, 9)
    dj = np.asarray(jham.distance_matrix(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(va), jnp.asarray(vb)))
    dt = tham.distance_matrix(t(a), t(b), t(va), t(vb)).numpy()
    np.testing.assert_array_equal(dt, dj)
    from vslam_tpu.ops import describe as jdesc

    packed = tdesc.pack_bits(t(a))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jdesc.pack_bits(jnp.asarray(a))))
    np.testing.assert_array_equal(tdesc.unpack_bits(packed).numpy(), a)


def test_cuda_wrapper_refuses_cpu_tensors():
    from vslam_tpu_torch.ops import cuda_hamming

    a, b, va, vb = top2_inputs(8, 8, 0)
    with pytest.raises(ValueError):
        cuda_hamming.hamming_top2(t(a), t(b), t(va), t(vb))
    with pytest.raises(ValueError):
        cuda_hamming.landmark_top2(
            *(t(x) for x in landmark_inputs(8, 8, 4, 0)), 20.0)
    assert cuda_hamming.LAUNCHES == {"landmark_top2": 0, "hamming_top2": 0}
