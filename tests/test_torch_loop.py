"""The port's place recognition, loop closure and relocalization against
the JAX package's, on the same seeded inputs on the CPU.

- ``_descend``: word ids equal to the JAX descent, on a tree with tied
  children (the lowest child index wins on both sides);
- the vocabulary: ``train``, ``set_idf_weights`` and ``from_arrays`` give
  arrays equal to the JAX package's;
- ``match_vs_keyframes`` and ``harvest_correspondences``: equal, exactly,
  to the JAX CPU path and to the Pallas descriptor top-2 in interpret
  mode, on the map of a short JAX ``StreamingVO`` run carried across with
  ``interop``;
- ``_guided_refine_device`` and ``verify_loop`` (the landmark top-2 at
  P = 1024): match counts equal, refined poses within 1e-4;
- ``compute_sim3`` and ``relocalize`` with the JAX package's own RANSAC
  draws injected: the same decisions, poses within 1e-4;
- ``corr_apply`` and ``loop_closure`` with an injected loop offset: poses
  within 1e-4, landmarks within 1e-4 (relative 1e-4).

The closure scenario is tests/test_loop_closure.py's drifted circle of
keyframes, with each landmark's descriptor bank filled from the keyframe
that created it (so the guided matching has something to match).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_loop_closure import INTR, N_KF, drifted_map  # noqa: F401
from test_streaming import small_config
from vslam_tpu.geometry import lie as jlie
from vslam_tpu.loop import closure as jclosure
from vslam_tpu.loop import detector as jdetector
from vslam_tpu.loop import matching as jmatching
from vslam_tpu.loop import relocalize as jreloc
from vslam_tpu.loop import vocabulary as jvocab
from vslam_tpu.ops import describe as jdescribe
from vslam_tpu.ops import pallas_hamming
from vslam_tpu.pipeline.streaming import StreamingVO as JaxStreamingVO
from vslam_tpu.solvers import pnp as jpnp
from vslam_tpu_torch import interop, synthetic
from vslam_tpu_torch.core.state import KeyframeState, LandmarkState
from vslam_tpu_torch.loop import closure as tclosure
from vslam_tpu_torch.loop import detector as tdetector
from vslam_tpu_torch.loop import matching as tmatching
from vslam_tpu_torch.loop import relocalize as treloc
from vslam_tpu_torch.loop import vocabulary as tvocab
from vslam_tpu_torch.ops import describe as tdescribe


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tests run in parallel workers, and small
    tensors gain nothing from more (oversubscribed, they lose much)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


POSE_ATOL = 1e-4


def tt(x):
    return torch.as_tensor(np.array(x))


def to_port(kf, lm):
    return (interop.from_arrays(KeyframeState, kf._asdict(), "cpu"),
            interop.from_arrays(LandmarkState, lm._asdict(), "cpu"))


# ---------------------------------------------------------------------------
# vocabulary
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vocab_data():
    rng = np.random.RandomState(4)
    centers = rng.randint(0, 2, (12, 256)).astype(np.uint8)
    flips = rng.rand(600, 256) < 0.1
    descs = np.where(flips, 1 - centers[rng.randint(0, 12, 600)],
                     centers[rng.randint(0, 12, 600)]).astype(np.uint8)
    return descs, [descs[i::5] for i in range(5)]


def test_train_and_idf_equal_jax(vocab_data):
    descs, pool = vocab_data
    vj = jvocab.train(descs, k=4, depth=3, seed=0)
    jvocab.set_idf_weights(vj, pool)
    vt = tvocab.train(descs, k=4, depth=3, seed=0)
    tvocab.set_idf_weights(vt, pool)
    carried = tvocab.from_arrays(vj)
    for name in ("node_desc", "children", "is_leaf", "word_of_node",
                 "node_of_word", "weights", "parent", "level"):
        want = getattr(vj, name)
        for got in (getattr(vt, name), getattr(carried, name)):
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert (vt.k, vt.depth) == (vj.k, vj.depth) == (carried.k,
                                                     carried.depth)
    assert vt.num_words == vj.num_words > 16


def tied_vocab(vocab_data):
    """The trained tree with every internal node's second child a copy of
    its first: each descent step that reaches those children is a tie."""
    voc = tvocab.train(vocab_data[0], k=4, depth=3, seed=0)
    for node in range(len(voc.children)):
        ch = voc.children[node]
        if ch[0] >= 0 and ch[1] >= 0:
            voc.node_desc[ch[1]] = voc.node_desc[ch[0]]
    return voc


def test_descend_equals_jax_with_ties(vocab_data):
    voc = tied_vocab(vocab_data)
    rng = np.random.RandomState(5)
    bits = np.concatenate([vocab_data[0][:200],
                           rng.randint(0, 2, (56, 256)).astype(np.uint8)])
    valid = rng.rand(len(bits)) < 0.9
    want = np.asarray(jvocab._descend(
        jnp.asarray(voc.node_desc), jnp.asarray(voc.children),
        jnp.asarray(voc.word_of_node), jnp.asarray(bits),
        jnp.asarray(valid), voc.depth))
    dv = tvocab.DeviceVocabulary(voc, "cpu")
    got = dv.words(tt(bits), tt(valid)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the ties were taken: no descriptor ends under a second child copy
    np.testing.assert_array_equal(got[valid],
                                  tvocab.transform_np(voc, bits[valid])[0])
    tied_words = {int(voc.word_of_node[voc.children[n][1]])
                  for n in range(len(voc.children))
                  if voc.children[n][1] >= 0 and voc.is_leaf[
                      voc.children[n][1]]}
    assert not tied_words & set(got[valid].tolist())
    assert (got[~valid] == -1).all()


def test_bow_and_detector_copies_match(vocab_data):
    descs, pool = vocab_data
    voc = jvocab.train(descs, k=4, depth=3, seed=0)
    jvocab.set_idf_weights(voc, pool)
    dj, dt = jdetector.LoopDetector(3), tdetector.LoopDetector(3)
    words = [jvocab.transform_np(voc, p)[0] for p in pool]
    for slot, w in enumerate(words[:4]):
        bj = jvocab.bow_from_words(voc, w)
        bt = tvocab.bow_from_words(tvocab.from_arrays(voc), w)
        assert bj == bt
        dj.db.insert(slot, bj)
        dt.db.insert(slot, bt)
    q = jvocab.bow_from_words(voc, words[4])
    assert dj.relocalization_candidates(q) == \
        dt.relocalization_candidates(q)
    assert tvocab.l1_score(q, dt.db.bow_of[0]) == \
        jvocab.l1_score(q, dj.db.bow_of[0])


# ---------------------------------------------------------------------------
# keyframe matching on a StreamingVO map
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vo_map():
    seq = synthetic.generate(num_frames=12, num_points=500, seed=3)
    vo = JaxStreamingVO(seq.calib, small_config(), max_frames=16)
    vo.run(seq.images, sync_every=0)
    jax.block_until_ready(vo.state.frame)
    return vo.state.kf, vo.state.lm


def pallas_match(bits_a, bits_b, valid_a, valid_b, threshold=70, ratio=1.2):
    """The JAX package's TPU branch of match_descriptors, its Pallas
    descriptor top-2 in interpret mode."""
    n = bits_a.shape[0]
    rb1, rb2, j = pallas_hamming.hamming_top2(bits_a, bits_b, valid_a,
                                              valid_b, interpret=True)
    cb1, cb2, col = pallas_hamming.hamming_top2(bits_b, bits_a, valid_b,
                                                valid_a, interpret=True)
    row_ok = (rb1 < threshold) & ~(rb2.astype(jnp.float32) < rb1 * ratio)
    col_ok = (cb1[j] < threshold) & ~(cb2[j].astype(jnp.float32)
                                      < cb1[j] * ratio)
    acc = row_ok & col_ok & (col[j] == jnp.arange(n))
    return np.asarray(jnp.where(acc, j, -1))


def test_match_vs_keyframes_equals_jax(vo_map):
    kf_j, lm_j = vo_map
    kf_t, lm_t = to_port(kf_j, lm_j)
    n_kf = int(kf_j.next_slot)
    assert n_kf >= 3
    cur = n_kf - 1
    slots = list(range(cur))
    cur_bits_j = jdescribe.unpack_bits(kf_j.desc[cur, 0])
    cur_valid_j = kf_j.kp_valid[cur, 0]
    want = np.asarray(jmatching.match_vs_keyframes(
        cur_bits_j, cur_valid_j, kf_j, jnp.asarray(slots, jnp.int32), 0))
    cur_bits_t = tdescribe.unpack_bits(kf_t.desc[cur, 0])
    got = tmatching.match_vs_keyframes(cur_bits_t, kf_t.kp_valid[cur, 0],
                                       kf_t, slots, 0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 30
    for i, s in enumerate(slots):
        np.testing.assert_array_equal(got[i].numpy(), pallas_match(
            jdescribe.unpack_bits(kf_j.desc[s, 0]), cur_bits_j,
            kf_j.kp_valid[s, 0], cur_valid_j))
    lms_j, feats_j = jclosure.harvest_correspondences(
        kf_j, lm_j, cur_bits_j, cur_valid_j, slots, cur_slot=cur)
    lms_t, feats_t = tclosure.harvest_correspondences(
        kf_t, lm_t, cur_bits_t, kf_t.kp_valid[cur, 0], slots, cur_slot=cur)
    np.testing.assert_array_equal(lms_t, lms_j)
    np.testing.assert_array_equal(feats_t, feats_j)
    assert len(lms_t) > 20


# ---------------------------------------------------------------------------
# closure and relocalization on the drifted circle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def banked(drifted_map):  # noqa: F811
    """drifted_map with every landmark's bank slot 0 holding the
    descriptor of the keyframe feature that created it."""
    kf, lm, true_poses, stored, covis = drifted_map
    bank_bits = np.array(lm.bank_bits)
    bank_valid = np.array(lm.bank_valid)
    for i in range(N_KF - 1):
        mp = np.asarray(kf.map_points[i])
        bank_bits[mp, 0] = np.asarray(jdescribe.unpack_bits(kf.desc[i, 0]))
        bank_valid[mp, 0] = True
    lm = lm._replace(bank_bits=jnp.asarray(bank_bits),
                     bank_valid=jnp.asarray(bank_valid))
    return kf, lm, true_poses, stored, covis


CUR, CAND = N_KF - 1, 0


def true_sim3(stored, true_poses):
    """The loop correction that puts the current keyframe at its true
    pose: T_w_cand^-1 * T_w_cur_true."""
    return np.asarray(jlie.se3_mul(jlie.se3_inv(jnp.asarray(stored[CAND])),
                                   jnp.asarray(true_poses[CUR])))


class JaxDraws:
    """A port sampler that hands out the JAX package's own RANSAC draws:
    each call splits the key as the reference's retry loops do and draws
    with its Gumbel top-k on the same validity mask."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.calls = 0

    def __call__(self, valid, num_hypotheses):
        self.key, k = jax.random.split(self.key)
        self.calls += 1
        return torch.as_tensor(np.array(jpnp._sample_minimal(
            k, jnp.asarray(valid.numpy()), num_hypotheses, 6)))


@pytest.mark.parametrize("gn_iters", [8, 0])
def test_guided_refine_equals_jax(banked, gn_iters):
    kf, lm, true_poses, stored, _ = banked
    kt, ltt = to_port(kf, lm)
    kmask = np.zeros(kf.frame_id.shape[0], bool)
    kmask[[CAND, 1]] = True
    # a start 2 cm / 10 mrad off the true pose
    T0 = np.asarray(jlie.se3_mul(jnp.asarray(true_poses[CUR]), jlie.se3_exp(
        jnp.asarray([0.02, -0.01, 0.01, 0.004, -0.006, 0.002]))))
    Tj, nj = jclosure._guided_refine_device(
        kf, lm, jnp.asarray(CUR, jnp.int32), jnp.asarray(kmask),
        jnp.asarray(T0), INTR, cam_name="pinhole", gn_iters=gn_iters)
    Tt, nt = tclosure._guided_refine_device(
        kt, ltt, CUR, tt(kmask), tt(T0), tt(INTR), cam_name="pinhole",
        gn_iters=gn_iters)
    assert int(nt) == int(nj) >= 40
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=POSE_ATOL)
    if gn_iters:
        err = jlie.se3_log(jlie.se3_mul(jlie.se3_inv(
            jnp.asarray(true_poses[CUR])), jnp.asarray(Tt.numpy())))
        assert float(jnp.abs(err).max()) < 5e-3


@pytest.mark.parametrize("offset", [0.0, 0.3])
def test_verify_loop_equals_jax(banked, offset):
    """Counts through the true correction (every candidate-side landmark
    in view matches; the ring leaves 10 in the current keyframe's image)
    and through one 0.3 m off (few do)."""
    kf, lm, true_poses, stored, _ = banked
    kt, ltt = to_port(kf, lm)
    sim3 = np.asarray(jlie.se3_mul(jnp.asarray(true_sim3(stored, true_poses)),
                                   jlie.se3_exp(jnp.asarray(
                                       [offset, 0, 0, 0, 0, 0.0]))))
    kw = dict(px_gate=15.0, threshold=70, ratio=1.2)
    nj = jclosure.verify_loop(kf, lm, CUR, CAND, [1], jnp.asarray(sim3),
                              INTR, "pinhole", 320, 240, **kw)
    nt = tclosure.verify_loop(kt, ltt, CUR, CAND, [1], tt(sim3), tt(INTR),
                              "pinhole", 320, 240, **kw)
    assert nt == nj
    if offset == 0.0:
        assert nt[0] == nt[1] >= 8
    else:
        assert nt[0] < 5


def test_compute_sim3_equals_jax_with_injected_draws(banked):
    kf, lm, true_poses, stored, _ = banked
    kt, ltt = to_port(kf, lm)
    okj, sim3_j = jclosure.compute_sim3(
        kf, lm, CUR, CAND, [1], INTR, "pinhole", pnp_threshold=1.8e-5,
        key=jax.random.PRNGKey(3), num_hypotheses=64)
    draws = JaxDraws(3)
    okt, sim3_t = tclosure.compute_sim3(
        kt, ltt, CUR, CAND, [1], tt(INTR), "pinhole", pnp_threshold=1.8e-5,
        num_hypotheses=64, sampler=draws)
    assert okt and okj and draws.calls >= 1
    np.testing.assert_allclose(sim3_t.numpy(), np.asarray(sim3_j),
                               atol=POSE_ATOL)
    # and the correction is the injected drift's
    np.testing.assert_allclose(sim3_t.numpy()[:3],
                               true_sim3(stored, true_poses)[:3], atol=2e-2)


def test_compute_sim3_refuses_thin_harvest(banked):
    kf, lm, _, _, _ = banked
    kt, ltt = to_port(kf, lm)
    # keyframe 4 shares no landmark with keyframe 0's side
    ok, sim3 = tclosure.compute_sim3(kt, ltt, 4, CAND, [], tt(INTR),
                                     "pinhole", 1.8e-5, num_hypotheses=16,
                                     generator=torch.Generator())
    assert not ok and sim3 is None


def detectors(kf):
    """A JAX and a port detector over keyframes 0..N_KF-2 of the drifted
    circle, from one vocabulary trained on its keyframes."""
    pool = [np.asarray(jdescribe.unpack_bits(kf.desc[i, 0]))
            for i in range(N_KF)]
    voc = jvocab.train(np.concatenate(pool), k=4, depth=3, seed=0)
    jvocab.set_idf_weights(voc, pool)
    dj, dt = jdetector.LoopDetector(3), tdetector.LoopDetector(3)
    for i in range(N_KF - 1):
        b = jvocab.bow_from_words(voc, jvocab.transform_np(voc, pool[i])[0])
        dj.db.insert(i, b)
        dt.db.insert(i, b)
    query = jvocab.bow_from_words(voc, jvocab.transform_np(voc, pool[-1])[0])
    return dj, dt, query


@pytest.mark.parametrize("frames_lost,ok_want", [(12, True), (1, False)])
def test_relocalize_equals_jax_with_injected_draws(banked, frames_lost,
                                                   ok_want):
    """From the current keyframe's features with the tracker coasted 0.3 m
    off: a loss of 12 frames widens the motion gate enough to accept the
    recovery, a fresh loss does not."""
    kf, lm, true_poses, stored, covis = banked
    kt, ltt = to_port(kf, lm)
    dj, dt, bow = detectors(kf)
    graph = {s: set(d) for s, d in covis.items()}
    coasted = np.asarray(jlie.se3_mul(jnp.asarray(true_poses[CUR]),
                                      jlie.se3_exp(jnp.asarray(
                                          [0.3, 0, 0, 0, 0, 0.0]))))
    ident = np.asarray(jlie.identity_pose())
    bits_j = jdescribe.unpack_bits(kf.desc[CUR, 0])
    kw = dict(num_hypotheses=64, max_retries=2, max_candidates=3,
              frames_lost=frames_lost, gate_cap_mult=12)
    okj, Tj, pairs_j, diag_j = jreloc.relocalize(
        kf, lm, dj, bits_j, kf.kp_valid[CUR, 0], kf.corners[CUR, 0], bow,
        graph, jnp.asarray(coasted), jnp.asarray(ident), INTR, "pinhole",
        0.05, 1.8e-5, jax.random.PRNGKey(7), **kw)
    draws = JaxDraws(7)
    okt, Tt, pairs_t, diag_t = treloc.relocalize(
        kt, ltt, dt, tdescribe.unpack_bits(kt.desc[CUR, 0]),
        kt.kp_valid[CUR, 0], kt.corners[CUR, 0], bow, graph, tt(coasted),
        tt(ident), tt(INTR), "pinhole", 0.05, 1.8e-5, sampler=draws, **kw)
    assert okt == okj == ok_want
    assert diag_t["candidates"] == diag_j["candidates"] > 0
    assert diag_t["best_n"] == diag_j["best_n"] >= 10
    assert diag_t["gate"] == diag_j["gate"]
    assert abs(diag_t["best_gate_err"] - diag_j["best_gate_err"]) <= 2e-3
    if ok_want:
        assert pairs_t == pairs_j
        np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj),
                                   atol=POSE_ATOL)


def test_corr_apply_and_loop_closure_equal_jax(banked):
    """The essential-graph closure with the injected drift's correction and
    a live slot: poses within 1e-4, landmarks within 1e-4."""
    kf, lm, true_poses, stored, covis = banked
    kt, ltt = to_port(kf, lm)
    sim3 = true_sim3(stored, true_poses)
    T_0_1 = np.asarray(jlie.se3_exp(jnp.asarray([0.11, 0, 0, 0, 0, 0.0])))
    cur_pose = np.asarray(jlie.se3_mul(jnp.asarray(stored[CUR]), jlie.se3_exp(
        jnp.asarray([0.05, 0, 0.02, 0, 0.01, 0.0]))))
    cj = jclosure.corr_apply(kf.pose_l[CAND], jnp.asarray(sim3),
                             kf.pose_l[CUR], jnp.asarray(cur_pose),
                             jnp.asarray(stored[CUR]))
    ct = tclosure.corr_apply(kt.pose_l[CAND], tt(sim3), kt.pose_l[CUR],
                             tt(cur_pose), tt(stored[CUR]))
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)

    kw = dict(essential_threshold=30, huber=1.0, max_iters=20,
              live_slots=[CUR - 1, CUR])
    kj2, lj2, sj = jclosure.loop_closure(kf, lm, CUR, CAND,
                                         jnp.asarray(sim3), covis,
                                         jnp.asarray(T_0_1), **kw)
    kt2, lt2, st = tclosure.loop_closure(kt, ltt, CUR, CAND, tt(sim3),
                                         covis, tt(T_0_1), **kw)
    assert st["iterations"] == int(sj["iterations"])
    np.testing.assert_allclose(kt2.pose_l.numpy(), np.asarray(kj2.pose_l),
                               atol=POSE_ATOL)
    np.testing.assert_allclose(kt2.pose_r.numpy(), np.asarray(kj2.pose_r),
                               atol=POSE_ATOL)
    valid = np.asarray(lm.valid)
    np.testing.assert_allclose(lt2.pos.numpy()[valid],
                               np.asarray(lj2.pos)[valid], atol=1e-4,
                               rtol=1e-4)
    # the current keyframe lands on its corrected pose, the loop closes
    np.testing.assert_allclose(kt2.pose_l.numpy()[CUR],
                               np.asarray(true_poses[CUR]), atol=1e-3)


def test_unported_closure_branches_raise(banked):
    kf, lm, _, stored, covis = banked
    kt, ltt = to_port(kf, lm)
    big = kt.replace(next_slot=torch.tensor(1025, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tclosure.loop_closure(big, ltt, CUR, CAND, tt(stored[0]), covis,
                              tt(stored[0]))
