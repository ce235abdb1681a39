"""The port's CUDA kernels on the card (marked ``cuda``; skipped without a
CUDA device). The file imports no JAX, so it also runs on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each hand-written kernel must equal its plain PyTorch version exactly (the
outputs are integers), at the main path's shapes, at ragged, chunk-edge
and all-invalid shapes and on tie-heavy inputs
(``synthetic.descriptor_ties`` and ``synthetic.landmark_ties``, which the
CPU parity tests share), take strided inputs and refuse misaligned ones,
and the dispatchers must route CUDA tensors through the kernels, the
full-SLAM slice's call sites included (loop matching, the closure's
guided matching at P = 1024) and the faithful driver's (``SlamSystem``'s
tracking and stereo matching, the closed-form closure's harvest). The
landmark top-2 with a leading sequence axis equals its plain version and,
bit for bit, one launch per sequence; ``MultiSeqVO`` tracks every sequence
of a lockstep frame in one launch of it. The matrix-free bundle
adjustment on the card equals its CPU run (costs within 1e-3 relative,
poses within 1e-3). ``StreamingVO`` replaying its step as CUDA graphs
makes the eager step's keyframes, tracked flags and trajectory (within
1e-4 m, deterministic mode), and counts the kernels' launches across
replays; its stage stamps change no pose and no launch count, stamp in
order inside each replay, and add no graph launch.
"""

import os

# cuBLAS reduces reproducibly in deterministic mode only with a fixed
# workspace, set before the first CUDA call (one test runs in that mode)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vslam_tpu_torch import synthetic  # noqa: E402
from vslam_tpu_torch.ops import cuda_hamming, hamming  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda_hamming.build()
    return torch.device("cuda")


def top2_inputs(rng, n, m, dev, valid=0.9, valid_b=None):
    a = rng.randint(0, 2, (n, 256)).astype(np.uint8)
    b = rng.randint(0, 2, (m, 256)).astype(np.uint8)
    if n and m:
        src = rng.randint(0, n, m // 2)
        flip = rng.rand(m // 2, 256) < 0.05
        b[: m // 2] = np.where(flip, 1 - a[src], a[src])
    valid_b = valid if valid_b is None else valid_b
    return tuple(torch.as_tensor(x, device=dev) for x in
                 (a, b, rng.rand(n) < valid, rng.rand(m) < valid_b))


def landmark_inputs(rng, n, p, nb, dev, lm_valid=0.9, bank_valid=0.7):
    kp = rng.randint(0, 2, (n, 256)).astype(np.uint8)
    src = rng.randint(0, max(n, 1), (p, max(nb, 1)))
    flip = rng.rand(p, nb, 256) < 0.08
    near = kp[src[:, :nb]]
    bank = np.where(flip, 1 - near, near).astype(np.uint8)
    kxy = (rng.rand(n, 2) * [752, 480]).astype(np.float32)
    lxy = (kxy[src[:, 0]] + rng.normal(0, 15, (p, 2))).astype(np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in
                 (kp, rng.rand(n) < 0.95, kxy, bank,
                  rng.rand(p, nb) < bank_valid, lxy,
                  rng.rand(p) < lm_valid)) + (20.0,)


def assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g.cpu(), w.cpu())


# main path; ragged; M=0; all-invalid A, all-invalid B; the kernel's edges:
# N=1, N not a multiple of its 16-row tile, M under one 16-candidate
# chunk, M not a multiple of a chunk or of the 16 warps' 256-candidate step
@pytest.mark.parametrize("n,m,valid,valid_b", [
    (1500, 1500, 0.95, 0.95), (130, 600, 0.9, 0.9), (1, 129, 0.5, 0.5),
    (257, 0, 0.9, 0.9), (64, 64, 0.0, 0.9), (64, 64, 0.9, 0.0),
    (1, 1, 1.0, 1.0), (5, 7, 0.9, 0.9), (17, 31, 0.9, 0.9),
    (16, 32, 1.0, 1.0), (33, 257, 0.9, 0.9), (100, 2049, 0.9, 0.9)])
def test_hamming_top2_kernel_equals_plain(dev, n, m, valid, valid_b):
    args = top2_inputs(np.random.RandomState(n + m), n, m, dev, valid,
                       valid_b)
    assert_equal(cuda_hamming.hamming_top2(*args),
                 hamming.hamming_top2_plain(*args))


@pytest.mark.parametrize("case", synthetic.DESCRIPTOR_TIE_CASES)
def test_hamming_top2_kernel_ties(dev, case):
    args = tuple(torch.as_tensor(x, device=dev)
                 for x in synthetic.descriptor_ties(case))
    want = hamming.hamming_top2_plain(*args)
    assert_equal(cuda_hamming.hamming_top2(*args), want)
    # the cases do decide rows by ties and by the 256 rule
    best, second, _ = want
    assert bool((best == second).any())
    if case == "complement":
        assert bool((best == 256).any())


def test_hamming_top2_strided_and_misaligned_input(dev):
    """Strided inputs are copied and give the plain version's result; a
    contiguous descriptor tensor off 16-byte alignment raises."""
    a, b, va, vb = top2_inputs(np.random.RandomState(0), 32, 48, dev)
    want = hamming.hamming_top2_plain(a, b, va, vb)
    assert_equal(cuda_hamming.hamming_top2(
        a, torch.stack([b, b], 2)[:, :, 0], va,
        torch.stack([vb, vb], 1)[:, 0]), want)
    shifted = torch.empty(32 * 256 + 1, dtype=torch.uint8, device=dev)
    shifted = shifted[1:].view(32, 256)
    shifted.copy_(a)
    with pytest.raises(ValueError, match="aligned"):
        cuda_hamming.hamming_top2(shifted, b, va, vb)


# main path; ragged; P=0; all-invalid landmarks, all-invalid banks; the
# kernel's edges: N=1, P of 1, under and over one 32-landmark gate step,
# P past one and two 2048-landmark staged chunks; B=1, 3 and 8 (two passes
# of four slots), and B=0 (an empty bank tensor: every hit at 256)
@pytest.mark.parametrize("n,p,nb,lm_valid,bank_valid", [
    (1500, 2048, 4, 0.9, 0.7), (100, 300, 4, 0.9, 0.8),
    (129, 513, 3, 0.5, 0.5), (7, 0, 4, 0.9, 0.7), (64, 256, 4, 0.0, 0.7),
    (64, 256, 4, 0.9, 0.0), (1, 300, 4, 0.9, 0.7), (50, 1, 4, 1.0, 1.0),
    (50, 31, 4, 0.9, 0.7), (50, 33, 4, 0.9, 0.7), (300, 2049, 4, 0.9, 0.7),
    (200, 4100, 4, 0.9, 0.7), (80, 300, 1, 0.9, 0.7),
    (80, 300, 8, 0.9, 0.7), (80, 300, 0, 0.9, 0.7)])
def test_landmark_top2_kernel_equals_plain(dev, n, p, nb, lm_valid,
                                           bank_valid):
    args = landmark_inputs(np.random.RandomState(n + p + nb), n, p, nb, dev,
                           lm_valid, bank_valid)
    assert_equal(cuda_hamming.landmark_top2(*args),
                 hamming.landmark_top2_plain(*args))


@pytest.mark.parametrize("gate", ["all", "none"])
def test_landmark_top2_kernel_gate_extremes(dev, gate):
    """Every landmark inside every keypoint's gate (each warp takes every
    landmark as a hit), and none inside any."""
    rng = np.random.RandomState(5)
    args = list(landmark_inputs(rng, 64, 700, 4, dev))
    if gate == "all":
        args[2] = torch.as_tensor(100 + rng.rand(64, 2) * 5, device=dev,
                                  dtype=torch.float32)
        args[5] = torch.as_tensor(100 + rng.rand(700, 2) * 5, device=dev,
                                  dtype=torch.float32)
    else:
        args[5] = args[5] + 1000.0
    want = hamming.landmark_top2_plain(*args)
    assert_equal(cuda_hamming.landmark_top2(*args), want)
    assert bool(want[3].any()) == (gate == "all")


@pytest.mark.parametrize("case", synthetic.LANDMARK_TIE_CASES)
def test_landmark_top2_kernel_ties(dev, case):
    data = synthetic.landmark_ties(case)
    args = tuple(torch.as_tensor(x, device=dev) for x in data[:7]) + \
        (data[7],)
    want = hamming.landmark_top2_plain(*args)
    assert_equal(cuda_hamming.landmark_top2(*args), want)
    best, second, _, any_c = want
    if case == "at_256":
        assert bool((any_c & (best == 256)).any())
    else:
        assert bool(((best == second) & (best < 256)).any())


def test_landmark_top2_strided_and_misaligned_input(dev):
    """Strided inputs are copied and give the plain version's result; a
    contiguous descriptor tensor off 16-byte alignment, or an xy tensor
    off 8-byte alignment, raises."""
    args = landmark_inputs(np.random.RandomState(1), 48, 300, 4, dev)
    kp, kv, kxy, bank, bv, lxy, lv, r = args
    want = hamming.landmark_top2_plain(*args)
    strided = (kp.t().contiguous().t(), kv, torch.stack([kxy, kxy], 1)[:, 0],
               torch.stack([bank, bank], 2)[:, :, 0], bv,
               torch.stack([lxy, lxy], 1)[:, 0], lv, r)
    assert not any(strided[i].is_contiguous() for i in (0, 2, 3, 5))
    assert_equal(cuda_hamming.landmark_top2(*strided), want)
    shifted = torch.empty(kp.numel() + 1, dtype=torch.uint8, device=dev)
    shifted = shifted[1:].view(kp.shape)
    shifted.copy_(kp)
    with pytest.raises(ValueError, match="aligned"):
        cuda_hamming.landmark_top2(shifted, *args[1:])
    shifted_xy = torch.empty(lxy.numel() + 1, dtype=torch.float32,
                             device=dev)[1:].view(lxy.shape)
    shifted_xy.copy_(lxy)
    with pytest.raises(ValueError, match="aligned"):
        cuda_hamming.landmark_top2(kp, kv, kxy, bank, bv, shifted_xy, lv, r)


def test_dispatch_launches_kernels(dev):
    rng = np.random.RandomState(0)
    a, b, va, vb = top2_inputs(rng, 300, 280, dev)
    before = dict(cuda_hamming.LAUNCHES)
    got = hamming.match_descriptors(a, b, va, vb)
    want = hamming.match_descriptors(a.cpu(), b.cpu(), va.cpu(), vb.cpu())
    assert cuda_hamming.LAUNCHES["hamming_top2"] == \
        before["hamming_top2"] + 2
    assert_equal(got, want)
    args = landmark_inputs(rng, 400, 512, 4, dev)
    got = hamming.match_landmarks(args[0], args[1], args[3], args[4],
                                  args[2], args[5], args[6])
    cpu = [x.cpu() for x in args[:7]]
    want = hamming.match_landmarks(cpu[0], cpu[1], cpu[3], cpu[4], cpu[2],
                                   cpu[5], cpu[6])
    assert cuda_hamming.LAUNCHES["landmark_top2"] == \
        before["landmark_top2"] + 1
    assert_equal(got, want)


@pytest.fixture(scope="module")
def vo_map(dev):
    """A short run of the port's StreamingVO on the CPU (at
    tests/test_streaming.py's small_config), its map copied to the card:
    the same inputs on both devices."""
    from vslam_tpu_torch import interop
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.core.state import KeyframeState, LandmarkState
    from vslam_tpu_torch.pipeline.streaming import StreamingVO

    seq = synthetic.generate(num_frames=12, num_points=500, seed=3)
    cfg = SlamConfig(
        num_features=400, ransac_hypotheses=128, max_landmarks=8192,
        max_keyframes=64, max_inview_landmarks=512, window_cams=24,
        window_points=2048, window_obs=6144, ba_max_iters=10,
        enable_relocalization=False, enable_loop_closure=False,
        new_kf_min_inliers=60)
    vo = StreamingVO(seq.calib, cfg, max_frames=16, device="cpu")
    vo.run(seq.images)
    st = vo.state
    on_card = (interop.from_arrays(KeyframeState, interop.to_arrays(st.kf),
                                   dev),
               interop.from_arrays(LandmarkState, interop.to_arrays(st.lm),
                                   dev))
    return (st.kf, st.lm, st.intr0), on_card + (st.intr0.to(dev),)


def test_match_vs_keyframes_launches_kernel(vo_map):
    """Loop matching on the card: the descriptor top-2 twice per source
    keyframe, the same table as the plain version."""
    from vslam_tpu_torch.loop import matching
    from vslam_tpu_torch.ops import describe

    (kf, _, _), (kf_d, _, _) = vo_map
    cur = int(kf.next_slot) - 1
    slots = list(range(cur))
    before = cuda_hamming.LAUNCHES["hamming_top2"]
    got = matching.match_vs_keyframes(
        describe.unpack_bits(kf_d.desc[cur, 0]), kf_d.kp_valid[cur, 0],
        kf_d, slots, 0)
    assert cuda_hamming.LAUNCHES["hamming_top2"] == before + 2 * len(slots)
    want = matching.match_vs_keyframes(
        describe.unpack_bits(kf.desc[cur, 0]), kf.kp_valid[cur, 0], kf,
        slots, 0)
    assert torch.equal(got.cpu(), want)
    assert int((want >= 0).sum()) > 30


@pytest.mark.parametrize("step", ["guided_refine", "verify_loop"])
def test_closure_landmark_matching_launches_kernel(vo_map, step):
    """The closure's guided matching at P = 1024 on the card: one landmark
    top-2 launch per call, the plain version's match counts, the refined
    pose within 1e-3."""
    from vslam_tpu_torch.loop import closure

    (kf, lm, intr), (kf_d, lm_d, intr_d) = vo_map
    cur = int(kf.next_slot) - 1
    mask = torch.zeros(kf.frame_id.shape[0], dtype=torch.bool)
    mask[:cur] = True
    T = kf.pose_l[cur]
    before = cuda_hamming.LAUNCHES["landmark_top2"]
    if step == "guided_refine":
        got = closure._guided_refine_device(
            kf_d, lm_d, cur, mask.to(kf_d.pose_l.device),
            T.to(kf_d.pose_l.device), intr_d, "pinhole")
        want = closure._guided_refine_device(kf, lm, cur, mask, T, intr,
                                             "pinhole")
        assert int(got[1]) == int(want[1]) > 30
        assert torch.allclose(got[0].cpu(), want[0], atol=1e-3)
    else:
        got = closure._verify_loop_device(
            kf_d, lm_d, cur, mask.to(kf_d.pose_l.device),
            T.to(kf_d.pose_l.device), intr_d, "pinhole", 320, 240)
        want = closure._verify_loop_device(kf, lm, cur, mask, T, intr,
                                           "pinhole", 320, 240)
        assert [int(x) for x in got] == [int(x) for x in want]
        assert int(want[0]) > 30
    assert cuda_hamming.LAUNCHES["landmark_top2"] == before + 1


def test_horn_closure_harvest_launches_kernel(vo_map):
    """``compute_sim3_horn`` on the card: the descriptor top-2 twice per
    source keyframe in its harvest, and with the same draws the CPU run's
    decision and correction (1e-4)."""
    from vslam_tpu_torch.loop import closure

    (kf, lm, _), (kf_d, lm_d, _) = vo_map
    cur = int(kf.next_slot) - 1
    cand, nbrs = 0, list(range(1, cur))
    gen = torch.Generator().manual_seed(3)
    idx = torch.stack([torch.randperm(16, generator=gen)[:3]
                       for _ in range(64)])
    want = closure.compute_sim3_horn(kf, lm, cur, cand, nbrs,
                                     sample_idx=idx)
    before = dict(cuda_hamming.LAUNCHES)
    got = closure.compute_sim3_horn(kf_d, lm_d, cur, cand, nbrs,
                                    sample_idx=idx.to(kf_d.pose_l.device))
    assert cuda_hamming.LAUNCHES["hamming_top2"] == (
        before["hamming_top2"] + 2 * (1 + len(nbrs)))
    assert cuda_hamming.LAUNCHES["landmark_top2"] == before["landmark_top2"]
    assert got[0] == want[0]
    assert abs(got[2] - want[2]) < 1e-4
    if want[0]:
        assert torch.allclose(got[1].cpu(), want[1], atol=1e-4)


def test_faithful_driver_launches_kernels(dev):
    """``SlamSystem`` on the card: the landmark top-2 once per frame, the
    descriptor top-2 twice per keyframe, and the CPU run's outcome (the
    bootstrap keyframe's counts exactly: no random draw precedes them)."""
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.eval import ate
    from vslam_tpu_torch.pipeline.slam import SlamSystem

    seq = synthetic.generate(num_frames=24, num_points=500, seed=3)

    def run(device):
        cfg = SlamConfig(
            num_features=400, ransac_hypotheses=128, max_landmarks=8192,
            max_keyframes=64, max_inview_landmarks=512, window_cams=24,
            window_points=2048, window_obs=6144, ba_max_iters=10,
            enable_relocalization=False, enable_loop_closure=False,
            new_kf_min_inliers=60)
        slam = SlamSystem(seq.calib, cfg, device=device)
        infos = [slam.process_frame(*pair) for pair in seq.images]
        fids, pos, _ = slam.keyframe_trajectory()
        return infos, float(ate.align_svd(pos, seq.poses[fids, :3])[2])

    before = dict(cuda_hamming.LAUNCHES)
    infos_d, ate_d = run(dev)
    n_kf = sum(i["kind"] == "keyframe" for i in infos_d)
    assert cuda_hamming.LAUNCHES["landmark_top2"] == (
        before["landmark_top2"] + 24)
    assert cuda_hamming.LAUNCHES["hamming_top2"] == (
        before["hamming_top2"] + 2 * n_kf)
    infos_c, ate_c = run("cpu")
    for key in ("kind", "stereo_inliers", "new_landmarks", "matches"):
        assert infos_d[0][key] == infos_c[0][key], key
    assert all(i["ok"] for i in infos_d[1:])
    assert ate_d < 0.08 and ate_c < 0.08


def test_solve_ba_cg_on_the_card_equals_cpu(dev):
    from vslam_tpu_torch import interop
    from vslam_tpu_torch.solvers import ba, ba_cg

    arrays, _, _ = synthetic.make_big_problem(n_pairs=64, pts_per_kf=8,
                                              obs_per_pt=8)
    kw = dict(cam_name="pinhole", huber=2.0, max_iters=3, cg_iters=8)
    out = {}
    for where in ("cpu", dev):
        prob = interop.from_arrays(ba.BAProblem, arrays, where)
        poses, points, stats = ba_cg.solve_ba_cg(prob, **kw)
        assert poses.device.type == torch.device(where).type
        out[str(where)] = (poses.cpu(), points.cpu(),
                           float(stats["initial_cost"]),
                           float(stats["final_cost"]), stats["iterations"])
    c, d = out["cpu"], out[str(dev)]
    assert c[4] == d[4] >= 1
    assert abs(c[2] - d[2]) <= 1e-3 * c[2]
    assert abs(c[3] - d[3]) <= 1e-3 * c[3]
    assert d[3] < 0.5 * d[2]
    assert torch.allclose(c[0], d[0], atol=1e-3)
    assert torch.allclose(c[1], d[1], atol=2e-3)


# ---- the sequence axis of the landmark top-2 ----------------------------

def stacked_landmark_inputs(rng, num_seq, n, p, nb, dev):
    parts = [landmark_inputs(rng, n, p, nb, dev) for _ in range(num_seq)]
    return tuple(torch.stack(x) for x in list(zip(*parts))[:7]) + (20.0,)


@pytest.mark.parametrize("num_seq,n,p,nb", [
    (1, 300, 700, 4), (2, 129, 513, 3), (8, 1500, 2048, 4), (3, 50, 2049, 8)])
def test_landmark_top2_sequence_axis_equals_plain_and_unbatched(
        dev, num_seq, n, p, nb):
    """One launch over S sequences: exact against the batched plain version
    and bit-equal to S launches of the same kernel, one per sequence; one
    count whatever S is. A sequence without a valid keypoint and one whose
    landmarks all fall outside every gate ride along."""
    args = list(stacked_landmark_inputs(
        np.random.RandomState(num_seq + n), num_seq, n, p, nb, dev))
    if num_seq > 1:
        args[1][0] = False                  # no valid keypoint
        args[5][-1] += 5000.0               # every landmark gated out
    before = cuda_hamming.LAUNCHES["landmark_top2"]
    got = cuda_hamming.landmark_top2(*args)
    assert cuda_hamming.LAUNCHES["landmark_top2"] == before + 1
    assert all(g.shape == (num_seq, n) for g in got)
    assert_equal(got, hamming.landmark_top2_plain(*args))
    for s in range(num_seq):
        one = cuda_hamming.landmark_top2(*(a[s] for a in args[:7]), args[7])
        assert_equal([g[s] for g in got], one)
    if num_seq > 1:
        assert not bool(got[3][0].any()) and not bool(got[3][-1].any())
        assert int(got[0][0].min()) == 256 and int(got[2][-1].max()) == 0


def test_landmark_top2_sequence_axis_ties(dev):
    """The tie cases in different sequences of one launch."""
    *arrs, r = synthetic.landmark_ties_stacked()
    args = tuple(torch.as_tensor(x, device=dev) for x in arrs) + (r,)
    want = hamming.landmark_top2_plain(*args)
    assert_equal(cuda_hamming.landmark_top2(*args), want)
    assert bool((want[0] == want[1]).any())
    assert bool(((want[0] == 256) & want[3]).any())


def test_landmark_top2_sequence_axis_rank_and_alignment(dev):
    args = stacked_landmark_inputs(np.random.RandomState(2), 2, 48, 300, 4,
                                   dev)
    with pytest.raises(ValueError, match="sequence axis"):
        cuda_hamming.landmark_top2(args[0][0], *args[1:])
    kp = args[0]
    shifted = torch.empty(kp.numel() + 1, dtype=torch.uint8,
                          device=dev)[1:].view(kp.shape)
    shifted.copy_(kp)
    with pytest.raises(ValueError, match="aligned"):
        cuda_hamming.landmark_top2(shifted, *args[1:])
    # a strided stack (every second sequence of a larger one) is copied
    four = stacked_landmark_inputs(np.random.RandomState(3), 4, 48, 300, 4,
                                   dev)
    every_other = tuple(a[::2] for a in four[:7]) + (20.0,)
    assert not every_other[0].is_contiguous()
    assert_equal(cuda_hamming.landmark_top2(*every_other),
                 hamming.landmark_top2_plain(*every_other))


def test_multiseq_vo_step_launches_one_kernel_per_lockstep_frame(dev):
    """``MultiSeqVO`` on the card, three sequences: the landmark top-2 once
    per lockstep frame whatever S is, the descriptor top-2 twice per
    inserted keyframe, and the CPU run's outcome (the bootstrap keyframes'
    landmark counts exactly: no random draw precedes them)."""
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.eval import ate
    from vslam_tpu_torch.parallel.multiseq_runner import MultiSeqVO

    S, frames = 3, 12
    worlds = [synthetic.generate(num_frames=24, num_points=500,
                                 seed=3 + 8 * s) for s in range(S)]
    lock = [(np.stack([w.images[f][0] for w in worlds]),
             np.stack([w.images[f][1] for w in worlds]))
            for f in range(frames)]

    def run(device):
        cfg = SlamConfig(
            num_features=300, ransac_hypotheses=64, max_landmarks=2048,
            max_keyframes=16, max_inview_landmarks=512, window_cams=8,
            window_points=512, window_obs=2048, ba_max_iters=6,
            enable_relocalization=False, enable_loop_closure=False,
            new_kf_min_inliers=60)
        vo = MultiSeqVO(worlds[0].calib, S, cfg, max_frames=16, device=device)
        vo.process_frames(*lock[0])
        first = vo.lm.valid.sum(dim=1).cpu()
        vo.run(lock[1:])
        return vo, first

    before = dict(cuda_hamming.LAUNCHES)
    vo, first = run(dev)
    res = vo.results()
    assert cuda_hamming.LAUNCHES["landmark_top2"] == (
        before["landmark_top2"] + frames)
    assert cuda_hamming.LAUNCHES["hamming_top2"] == (
        before["hamming_top2"] + 2 * int(res["is_keyframe"].sum()))
    assert vo.state.pose.device.type == "cuda"
    vo_c, first_c = run("cpu")
    assert torch.equal(first, first_c) and int(first[0]) > 40
    for s, w in enumerate(worlds):
        for r in (vo, vo_c):
            est = r.trajectories[s][:, :3]
            assert np.isfinite(est).all()
            assert ate.align_svd(est, w.poses[:frames, :3])[2] < 0.15
        assert int(vo.lm.valid[s].sum()) > 50


def test_entry_points_on_the_card_launch_the_landmark_kernel(dev):
    """``entry()``'s step on the card equals the CPU's on the same inputs
    and draws (one landmark top-2 launch per call), and the dryrun runs on
    a mesh that lists the card twice (its batched tracking one launch)."""
    from vslam_tpu_torch import entry
    from vslam_tpu_torch.solvers import pnp

    fn, args = entry.entry(dev)
    fn_c, args_c = entry.entry("cpu")
    res_c = fn_c(*args_c)
    idx = pnp.sample_minimal(res_c.match_lm >= 0, 64, 6,
                             torch.Generator().manual_seed(0))
    res_c = fn_c(*args_c, sample_idx=idx)
    before = cuda_hamming.LAUNCHES["landmark_top2"]
    res = fn(*args, sample_idx=idx.to(dev))
    assert cuda_hamming.LAUNCHES["landmark_top2"] == before + 1
    for name in ("match_lm", "had_candidate", "num_matches"):
        assert torch.equal(getattr(res, name).cpu(), getattr(res_c, name))
    assert torch.equal(res.feats.bits.cpu(), res_c.feats.bits)
    torch.testing.assert_close(res.T_w_c.cpu(), res_c.T_w_c, rtol=0,
                               atol=1e-4)
    before = cuda_hamming.LAUNCHES["landmark_top2"]
    r = entry.dryrun_multichip(2, dev)
    assert cuda_hamming.LAUNCHES["landmark_top2"] == before + 1
    assert bool(torch.isfinite(r["poses"]).all())
    assert float(r["ba"]["final_cost"]) <= float(r["ba"]["initial_cost"])


def _small_vo_config():
    from vslam_tpu_torch.config import SlamConfig

    return SlamConfig(
        num_features=400, ransac_hypotheses=128, max_landmarks=8192,
        max_keyframes=64, max_inview_landmarks=512, window_cams=24,
        window_points=2048, window_obs=6144, ba_max_iters=10,
        enable_relocalization=False, enable_loop_closure=False,
        new_kf_min_inliers=60)


def _vo_run(dev, cuda_graphs, frames=24, **kwargs):
    """A driver on the small world's first ``frames`` frames; returns it,
    its logs, the kernels' launches in the run, and the world."""
    from vslam_tpu_torch.pipeline.streaming import StreamingVO

    seq = synthetic.generate(num_frames=24, num_points=500, seed=3)
    vo = StreamingVO(seq.calib, _small_vo_config(), max_frames=32,
                     device=dev, cuda_graphs=cuda_graphs, **kwargs)
    before = dict(cuda_hamming.LAUNCHES)
    vo.run(seq.images[:frames])
    torch.cuda.synchronize()
    launches = {k: cuda_hamming.LAUNCHES[k] - before[k] for k in before}
    return vo, vo.results(), launches, seq


def test_graphed_streaming_vo_matches_eager(dev):
    """``StreamingVO`` replaying its step as CUDA graphs (the default on
    the card) against ``cuda_graphs=False`` on the small world, in
    deterministic mode (the window BA's sums in order): the same keyframes
    and tracked flags, the trajectories within 1e-4 m. The three graphs
    are captured at the first two frames."""
    torch.use_deterministic_algorithms(True)
    try:
        g_vo, g, _, _ = _vo_run(dev, None)
        _, e, _, _ = _vo_run(dev, False)
    finally:
        torch.use_deterministic_algorithms(False)
    assert g_vo.cuda_graphs and set(g_vo._graphs) == {
        "track", "advance", "keyframe"}
    assert (g["is_keyframe"] == e["is_keyframe"]).all()
    assert (g["tracked_ok"] == e["tracked_ok"]).all()
    assert g["tracked_ok"][2:].all() and g["is_keyframe"].sum() >= 3
    assert np.abs(g["trajectory"] - e["trajectory"]).max() <= 1e-4


def test_graph_replays_count_kernel_launches(dev):
    """The kernels run inside the replays, where their wrappers are not
    called: each replay adds the launches its graph made at capture, so
    a graphed run counts the landmark top-2 once per frame and the
    descriptor top-2 twice per keyframe, as the eager run does."""
    vo, res, launches, seq = _vo_run(dev, True, frames=20)
    n_kf = int(res["is_keyframe"].sum())
    assert launches == {"landmark_top2": 20, "hamming_top2": 2 * n_kf}
    assert vo._graphs["track"].launches == {"landmark_top2": 1,
                                            "hamming_top2": 0}
    assert vo._graphs["keyframe"].launches == {"landmark_top2": 0,
                                               "hamming_top2": 2}
    # a dropped graph is captured again at the next frame
    vo.set_param("match_max_dist", 70)
    assert vo._graphs == {}
    vo.run(seq.images[20:23])
    assert "track" in vo._graphs and vo.results()["tracked_ok"][-3:].all()
    # a state buffer replaced instead of written in place: the replay raises
    vo.state = vo.state.replace(cur_pose=vo.state.cur_pose.clone())
    with pytest.raises(RuntimeError, match="cur_pose"):
        vo.process_frame(*seq.images[23])


def test_graphed_stage_stamps_change_nothing_and_stamp_in_order(dev):
    """Graphs with the stage stamps (``spans=True``, the default) against
    graphs without, in deterministic mode: the logs and poses bit for bit
    and the kernels' launch counts equal. Inside every replayed body the
    stamps do not decrease and its last comes after its first, on the
    host clock too; a body's span holds its stages; a replayed frame is
    two graph launches, with a body's stamps inside them."""
    from vslam_tpu_torch.utils import profiling

    torch.use_deterministic_algorithms(True)
    try:
        on, r_on, l_on, seq = _vo_run(dev, None)
        off, r_off, l_off, _ = _vo_run(dev, None, spans=False)
    finally:
        torch.use_deterministic_algorithms(False)
    assert not off.spans and profiling.latest_spans() is on.spans
    for name in r_on:
        assert np.array_equal(r_on[name], r_off[name]), name
    assert torch.equal(on.state.kf.pose_l, off.state.kf.pose_l)
    assert l_on == l_off
    rec = on.spans
    got = rec.read()
    assert got["frames"] == 24 and got["clock"]["points"] >= 2
    kf = r_on["is_keyframe"]
    for body, stages in profiling.BODY_STAGES.items():
        cols = [rec._col[body, s] for s in stages]
        st = rec._stamps[2:24][:, cols]
        ran = (st > 0).all(1)
        assert ran.sum() == {"track": 22, "keyframe": kf[2:].sum(),
                             "advance": (~kf[2:]).sum()}[body]
        assert (np.diff(st[ran], axis=1) >= 0).all()
        assert (st[ran, -1] > st[ran, 0]).all()
        total = rec.durations_ms("device." + body, 2, 24)
        assert (total[np.isfinite(total)] > 0).all()
        if len(stages) > 2:
            parts = sum(rec.durations_ms(f"{body}.{s}", 2, 24)
                        for s in stages[1:])
            ok = np.isfinite(total)
            np.testing.assert_allclose(parts[ok], total[ok], rtol=1e-9)
    live = rec.counter("lm_live", 0, 24)
    run = rec.counter("lm_run", 0, 24)
    assert np.isfinite(live).sum() == kf.sum()
    assert (live[kf] >= 1).all() and (live[kf] <= run[kf]).all()
    # a replayed frame: two graph launches, and the same host calls as
    # without stamps; the stamps run inside the graphs
    calls = {}
    for name, vo in (("on", on), ("off", off)):
        names = _profiled_frames(vo, seq)
        calls[name] = sorted(n for n in names if n.startswith("cuda"))
        assert names.count("cudaGraphLaunch") == 8, name
    assert calls["on"] == calls["off"]
    assert len([n for n in names if "stamp_kernel" in n]) == 0  # "off"


def _profiled_frames(vo, seq):
    """Host and device event names of frames 2-5 after a ``reset`` (the
    graphs captured anew at frames 0 and 1)."""
    from torch.profiler import ProfilerActivity, profile

    vo.reset()
    vo.run(seq.images[:2])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        vo.run(seq.images[2:6])
        torch.cuda.synchronize()
    return [e.name for e in prof.events()]
