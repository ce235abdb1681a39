"""Parity of the port's Hamming matching with the JAX package.

The plain PyTorch versions of the two kernels (``landmark_top2_plain``,
``hamming_top2_plain``) are held against the Pallas kernels run with
``interpret=True`` (as tests/test_pallas_hamming.py runs them) and against
the JAX CPU matchers. Distances are exact integers, so every comparison is
exact. Both argmins are held on tied rows too (the lowest-index rule),
against the JAX CPU argmin on every row and against Pallas on every valid
row with a best distance under 256, and on tie-heavy inputs shared with
the card tests (``synthetic.descriptor_ties``, ``synthetic.landmark_ties``).

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
from vslam_tpu_torch import synthetic
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


def jax_cpu_landmark_top2(kp, kv, kxy, banks, bv, lxy, lv, r):
    """The JAX CPU path's guided landmark stats, as
    vslam_tpu/ops/hamming.py:148-162 computes them inside
    ``match_landmarks``: (best, second, argmin, any_candidate)."""
    p, b, _ = banks.shape
    flat_valid = bv.reshape(p * b) & np.repeat(lv, b)
    d = jham.distance_matrix(jnp.asarray(kp),
                             jnp.asarray(banks.reshape(p * b, 256)),
                             jnp.asarray(kv), jnp.asarray(flat_valid))
    d = d.reshape(d.shape[0], p, b).min(axis=-1)
    diff = jnp.asarray(kxy)[:, None, :] - jnp.asarray(lxy)[None, :, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    gate = (d2 < r * r) & jnp.asarray(lv)[None, :] & jnp.asarray(kv)[:, None]
    d = jnp.where(gate, d, jham.PAD_DIST)
    b1, b2 = jham._top2_min(d, axis=1)
    return tuple(np.asarray(x) for x in (b1, b2, jnp.argmin(d, axis=1),
                                         jnp.any(gate, axis=1)))


def assert_landmark_top2_matches_jax(kp, kv, kxy, banks, bv, lxy, lv, r):
    """landmark_top2_plain against the JAX CPU path on every row (best,
    second, arg, any_candidate) and against the Pallas kernel; returns
    the port's (best, second, arg, any_candidate)."""
    b1, b2, arg, any_c = (x.numpy() for x in tham.landmark_top2_plain(
        *(t(x) for x in (kp, kv, kxy, banks, bv, lxy, lv)), r))
    assert b1.dtype == np.int32 and arg.dtype == np.int32
    cb1, cb2, carg, cany = jax_cpu_landmark_top2(kp, kv, kxy, banks, bv,
                                                 lxy, lv, r)
    np.testing.assert_array_equal(b1, cb1)
    np.testing.assert_array_equal(b2, cb2)
    np.testing.assert_array_equal(arg, carg)
    np.testing.assert_array_equal(any_c, cany)
    pb1, pb2, parg, pany = (np.asarray(x) for x in jpal.landmark_top2(
        *(jnp.asarray(x) for x in (kp, kv, kxy, banks, bv, lxy, lv)), r,
        interpret=True))
    np.testing.assert_array_equal(b1, pb1)
    np.testing.assert_array_equal(b2, pb2)
    # The Pallas path pads out-of-gate and empty-bank landmarks far above
    # 256, so where best is 256 its arg is a gated landmark's index where
    # the CPU path (and the port) give 0; on invalid rows its arg is not
    # reset. Those rows are held to the CPU path only.
    rows = kv & (b1 < 256)
    np.testing.assert_array_equal(arg[rows], parg[rows])
    # any_candidate: the port (CPU-path semantics) may only ADD rows whose
    # gated landmarks all have empty banks
    assert not (pany & ~any_c).any()
    return b1, b2, arg, any_c


def assert_top2_matches_jax(a, b, va, vb):
    """hamming_top2_plain against the JAX CPU path (argmin over the padded
    distance matrix) on every row and the Pallas kernel; returns the
    port's (best, second, arg)."""
    b1, b2, arg = (x.numpy() for x in tham.hamming_top2_plain(
        t(a), t(b), t(va), t(vb)))
    assert b1.dtype == np.int32 and arg.dtype == np.int32
    d = jham.distance_matrix(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va),
                             jnp.asarray(vb))
    cb1, cb2 = (np.asarray(x) for x in jham._top2_min(d, 1))
    np.testing.assert_array_equal(b1, cb1)
    np.testing.assert_array_equal(b2, cb2)
    np.testing.assert_array_equal(arg, np.asarray(jnp.argmin(d, axis=1)))
    pb1, pb2, parg = (np.asarray(x) for x in jpal.hamming_top2(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb),
        interpret=True))
    np.testing.assert_array_equal(b1, pb1)
    np.testing.assert_array_equal(b2, pb2)
    # The Pallas path biases invalid columns far above 256 instead of
    # padding with 256, so on an invalid A row, or a row whose candidates
    # all lie at 256, its arg is that row's real argmin where the CPU path
    # (and the port) give 0. Those rows are held to the CPU path only.
    rows = va & (b1 < 256)
    np.testing.assert_array_equal(arg[rows], parg[rows])
    return b1, b2, arg


# the ragged shapes of tests/test_pallas_hamming.py, plus tile edges
@pytest.mark.parametrize("n,m", [(100, 300), (128, 512), (130, 600),
                                 (1, 1), (257, 129)])
def test_hamming_top2_matches_pallas(n, m):
    assert_top2_matches_jax(*top2_inputs(n, m, n + m))


@pytest.mark.parametrize("case", synthetic.DESCRIPTOR_TIE_CASES)
def test_hamming_top2_ties_match_jax(case):
    a, b, va, vb = synthetic.descriptor_ties(case)
    b1, b2, arg = assert_top2_matches_jax(a, b, va, vb)
    # the rows that ties decide are really there
    tied = va & (b1 == b2) & (b1 < 256)
    assert tied.any()
    if case == "dup_tiles":
        assert (tied & (arg < 100)).any()  # the copies lie further on
    if case == "complement":
        assert np.array_equal(b1[:4][va[:4]], np.full(va[:4].sum(), 256))
        assert (arg[:4] == 0).all()


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
    args = landmark_inputs(n, p, bank, n + p)
    r = 40.0
    assert_landmark_top2_matches_jax(*args, r)
    full = landmark_inputs(n, p, bank, n + p, bank_valid=1.0)
    fj = np.asarray(jpal.landmark_top2(
        *(jnp.asarray(x) for x in full), r, interpret=True)[3])
    ft = tham.landmark_top2_plain(*(t(x) for x in full), r)[3].numpy()
    np.testing.assert_array_equal(ft, fj)


@pytest.mark.parametrize("case", synthetic.LANDMARK_TIE_CASES)
def test_landmark_top2_ties_match_jax(case):
    kp, kv, kxy, banks, bv, lxy, lv, r = synthetic.landmark_ties(case)
    b1, b2, arg, any_c = assert_landmark_top2_matches_jax(
        kp, kv, kxy, banks, bv, lxy, lv, r)
    # the rows that ties and the 256 rule decide are really there
    tied = kv & (b1 == b2) & (b1 < 256)
    if case == "at_256":
        rows = kv & any_c
        assert rows.sum() > 10
        assert (b1[rows] == 256).all() and (arg[rows] == 0).all()
    else:
        assert tied.any()
    if case == "far_copies":
        first = np.arange(24)
        first = np.where(first % 3 == 0, first + 37, first)
        rows = kv[:24]
        np.testing.assert_array_equal(arg[:24][rows], first[rows])
    if case == "slot_ties":
        rows = kv & (np.arange(len(kv)) % 4 != 1)
        np.testing.assert_array_equal(arg[rows], np.arange(len(kv))[rows])
    # the whole matcher: distance-0 ties pass the ratio test and reach the
    # map, so the accepted index is the lowest one
    jm, jok, jany = (np.asarray(x) for x in jham.match_landmarks(
        *(jnp.asarray(x) for x in (kp, kv, banks, bv, kxy, lxy, lv)),
        max_dist_2d=r))
    tm, tok, tany = (x.numpy() for x in tham.match_landmarks(
        *(t(x) for x in (kp, kv, banks, bv, kxy, lxy, lv)), max_dist_2d=r))
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tany, jany)
    if case == "far_copies":
        assert (tok & (b1 == 0) & (b2 == 0)).any()


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


@pytest.mark.parametrize("layout",
                         ["aligned", "strided", "misaligned", "empty"])
def test_cuda_wrapper_input_checks(layout):
    """The kernels read descriptors with 16-byte loads: contiguous and
    aligned inputs pass as they are, strided ones are copied, contiguous
    misaligned ones raise, and an empty one passes wherever it starts
    (nothing is read). Checked on CPU tensors; the launch itself needs the
    card."""
    from vslam_tpu_torch.ops import cuda_hamming

    base = torch.zeros(64 * 256 + 16, dtype=torch.uint8)
    offset = (-base.data_ptr()) % 16
    x = base[offset:offset + 64 * 256].view(64, 256)
    if layout == "strided":
        x = x.t().contiguous().t()
    elif layout == "misaligned":
        x = base[offset + 1:offset + 1 + 64 * 256].view(64, 256)
    elif layout == "empty":
        x = base[offset + 1:offset + 1].view(0, 256)
    args = (x, "bits", torch.uint8, tuple(x.shape), torch.device("cpu"))
    if layout in ("aligned", "empty"):
        assert cuda_hamming._check(*args, align=16) is x
    elif layout == "strided":
        got = cuda_hamming._check(*args, align=16)
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
        assert torch.equal(got, x)
    else:
        with pytest.raises(ValueError, match="aligned"):
            cuda_hamming._check(*args, align=16)


@pytest.mark.parametrize("offset", [0, 1, 2])
def test_cuda_wrapper_xy_alignment(offset):
    """The landmark top-2 kernel reads (x, y) pairs with 8-byte loads: a
    contiguous float32 [N, 2] tensor passes on an 8-byte boundary and
    raises off it (checked on CPU tensors; the launch needs the card)."""
    from vslam_tpu_torch.ops import cuda_hamming

    base = torch.zeros(2 * 64 + 8, dtype=torch.float32)
    start = (-base.data_ptr()) % 16 // 4 + offset
    x = base[start:start + 2 * 64].view(64, 2)
    args = (x, "xy", torch.float32, (64, 2), torch.device("cpu"))
    if offset % 2 == 0:
        assert cuda_hamming._check(*args, align=8) is x
    else:
        with pytest.raises(ValueError, match="aligned"):
            cuda_hamming._check(*args, align=8)


def test_cuda_wrapper_refuses_cpu_tensors():
    from vslam_tpu_torch.ops import cuda_hamming

    a, b, va, vb = top2_inputs(8, 8, 0)
    with pytest.raises(ValueError):
        cuda_hamming.hamming_top2(t(a), t(b), t(va), t(vb))
    with pytest.raises(ValueError):
        cuda_hamming.landmark_top2(
            *(t(x) for x in landmark_inputs(8, 8, 4, 0)), 20.0)
    assert cuda_hamming.LAUNCHES == {"landmark_top2": 0, "hamming_top2": 0}


# ---- the sequence axis of the guided landmark matching ------------------

def _jax_lm_top2(kp, kv, kxy, banks, bv, lxy, lv, r):
    """``jax_cpu_landmark_top2`` in jnp only, so that ``jax.vmap`` takes it
    over a sequence axis."""
    p, b, _ = banks.shape
    flat_valid = bv.reshape(p * b) & jnp.repeat(lv, b)
    d = jham.distance_matrix(kp, banks.reshape(p * b, 256), kv, flat_valid)
    d = d.reshape(d.shape[0], p, b).min(axis=-1)
    diff = kxy[:, None, :] - lxy[None, :, :]
    gate = ((jnp.sum(diff * diff, axis=-1) < r * r) & lv[None, :]
            & kv[:, None])
    d = jnp.where(gate, d, jham.PAD_DIST)
    b1, b2 = jham._top2_min(d, axis=1)
    return b1, b2, jnp.argmin(d, axis=1), jnp.any(gate, axis=1)


def _stacked_inputs(num_seq):
    """S = 1, 2, 3 stacked problems: random ones of one shape, the last
    sequence without a valid keypoint when there are three."""
    parts = [landmark_inputs(120, 300, 4, 40 + s) for s in range(num_seq)]
    out = [np.stack(x) for x in zip(*parts)]
    if num_seq == 3:
        out[1][2] = False
    return out


@pytest.mark.parametrize("num_seq", [1, 2, 3])
def test_landmark_top2_sequence_axis(num_seq):
    """The batched plain version and ``match_landmarks`` equal the
    per-sequence call on every row, bit for bit, and ``jax.vmap`` of the
    JAX CPU path (argmin included)."""
    import jax

    arrs = _stacked_inputs(num_seq)
    got = tham.landmark_top2_plain(*(t(x) for x in arrs), 20.0)
    want_j = jax.vmap(lambda *a: _jax_lm_top2(*a, 20.0))(
        *(jnp.asarray(x) for x in arrs))
    gm = tham.match_landmarks(*(t(arrs[i]) for i in (0, 1, 3, 4, 2, 5, 6)),
                              max_dist_2d=20.0)
    jm = jax.vmap(lambda kp, kv, kxy, bk, bv, lxy, lv: jham.match_landmarks(
        kp, kv, bk, bv, kxy, lxy, lv, max_dist_2d=20.0))(
        *(jnp.asarray(x) for x in arrs))
    for g, w in zip(got + gm, tuple(want_j) + tuple(jm)):
        assert g.shape[0] == num_seq
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for s in range(num_seq):
        one = tham.landmark_top2_plain(*(t(x[s]) for x in arrs), 20.0)
        one_m = tham.match_landmarks(
            *(t(arrs[i][s]) for i in (0, 1, 3, 4, 2, 5, 6)), max_dist_2d=20.0)
        for g, w in zip(got + gm, one + one_m):
            assert torch.equal(g[s], w)
    assert int(gm[1].sum()) > 20 * num_seq - 20 * (num_seq == 3)


def test_landmark_top2_sequence_axis_ties():
    """The tie cases in different sequences of one stack: every row equals
    the case run alone and ``jax.vmap`` of the JAX CPU path."""
    import jax

    *arrs, r = synthetic.landmark_ties_stacked()
    got = tham.landmark_top2_plain(*(t(x) for x in arrs), r)
    want = jax.vmap(lambda *a: _jax_lm_top2(*a, np.float32(r)))(
        *(jnp.asarray(x) for x in arrs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for s, case in enumerate(synthetic.LANDMARK_TIE_CASES):
        alone = synthetic.landmark_ties(case, 11 + s)
        one = tham.landmark_top2_plain(*(t(x) for x in alone[:7]), alone[7])
        for g, w in zip(got, one):
            assert torch.equal(g[s], w), case
    # the cases do what they are for: ties decided, 256 with a candidate
    assert (got[0] == got[1]).any() and ((got[0] == 256) & got[3]).any()


def test_cuda_wrapper_sequence_axis_checks():
    """The launcher takes every tensor with the leading sequence axis or
    none with it; mixed ranks raise before anything else is looked at, and
    the per-slab alignment follows from the base's (checked on CPU
    tensors: the launch needs the card)."""
    from vslam_tpu_torch.ops import cuda_hamming

    arrs = [t(x) for x in _stacked_inputs(2)]
    for drop in range(7):
        mixed = [a[0] if i == drop else a for i, a in enumerate(arrs)]
        with pytest.raises(ValueError, match="sequence axis"):
            cuda_hamming.landmark_top2(*mixed, 20.0)
    with pytest.raises(ValueError, match="needs CUDA"):
        cuda_hamming.landmark_top2(*arrs, 20.0)
    # a stacked descriptor tensor off the 16-byte boundary raises as the
    # unstacked one does; an aligned stack passes whole
    base = torch.zeros(2 * 8 * 256 + 16, dtype=torch.uint8)
    off = (-base.data_ptr()) % 16
    good = base[off:off + 2 * 8 * 256].view(2, 8, 256)
    bad = base[off + 1:off + 1 + 2 * 8 * 256].view(2, 8, 256)
    args = ("kp_bits", torch.uint8, (2, 8, 256), torch.device("cpu"))
    assert cuda_hamming._check(good, *args, align=16) is good
    assert all(good[s].data_ptr() % 16 == 0 for s in range(2))
    with pytest.raises(ValueError, match="aligned"):
        cuda_hamming._check(bad, *args, align=16)
    assert cuda_hamming.LAUNCHES["landmark_top2"] == 0
