"""The multi-sequence driver's lockstep bodies on the CPU: the form a CUDA
graph can hold, the service against the plain reference, and the spans.

``MultiSeqVO`` runs a lockstep frame as bodies that read nothing back to
the host (batched tracking, the picked sequence's insert, its window BA,
the advance); on the card it replays them as CUDA graphs
(``tests/test_torch_cuda.py`` holds the graphs against the eager bodies
there). Here:

- each body run by the driver under ``no_host_read``
  (tests/test_torch_graph_step.py's checker);
- the ``cuda_graphs`` argument;
- the driver against ``benchmark/reference/lockstep.py`` (a Python loop
  of the port's single-sequence eager step over the rigs, plain
  matching, the service rules written out) on three rigs of their own
  worlds at three speeds over 26 lockstep frames, with the same draws:
  the keyframe frames, the served sequences and the window-BA order
  exactly, the tracked flags and inlier counts exactly, the poses within
  1 cm and 1e-3 per quaternion component (the batched RANSAC PnP
  refines with batched products, ``torch.func.vmap``, where the single
  problem takes matrix products: the sums run in another order and the
  poses agree to rounding, ~1e-5 a frame; every later window BA and
  frame starts from inputs that differ by that much, and 24 frames of
  it have moved a pose by up to 2.6 mm);
- the stage stamps and counters of the lockstep bodies.
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_graph_step import no_host_read
from test_torch_multiseq import CFG
from vslam_tpu_torch import synthetic
from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.parallel.mesh import make_mesh
from vslam_tpu_torch.parallel.multiseq_runner import MultiSeqVO

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark"))
from reference.lockstep import LockstepReference, compare  # noqa: E402

S, FRAMES = 3, 26
SPEEDS = (0.7, 1.0, 1.3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds():
    # each rig its own world, at its own speed
    return [synthetic.generate(num_frames=48, num_points=500, seed=3 + 8 * s,
                               speed=v) for s, v in enumerate(SPEEDS)]


def lockstep(worlds, f):
    return (np.stack([w.images[f][0] for w in worlds]),
            np.stack([w.images[f][1] for w in worlds]))


@pytest.fixture(scope="module")
def both(worlds):
    """The driver and the reference over the same FRAMES lockstep
    frames."""
    cfg = SlamConfig(**CFG)
    vo = MultiSeqVO(worlds[0].calib, S, cfg, max_frames=32, device="cpu")
    ref = LockstepReference(worlds[0].calib, S, cfg, "cpu")
    for f in range(FRAMES):
        vo.process_frames(*lockstep(worlds, f))
        ref.step(*lockstep(worlds, f))
    return vo, ref


def test_driver_matches_the_lockstep_reference(both):
    vo, ref = both
    res = vo.results()
    got = compare(vo.infos, res, ref, FRAMES)
    assert got["keyframes_equal"] and got["service_equal"], got
    assert got["tracked_equal"], got
    assert max(got["pos_diff_m"]) <= 0.01, got
    assert max(got["quat_diff"]) <= 1e-3, got
    np.testing.assert_array_equal(res["inliers"], np.asarray(ref.inliers).T)
    # the run exercises the service: every rig keyframes more than once,
    # and each frame serves at most one insert and one BA
    assert (res["is_keyframe"].sum(1) >= 3).all()
    assert (res["is_keyframe"].sum(0) <= 1).all()
    assert [i.ba_seq for i in vo.infos[:S]] == list(range(S))


def test_lockstep_counters_and_stamps(both):
    """``kf_pending_n`` is the count of keyframe requests waiting at each
    frame's start (the requests latched by the logs of the frames before),
    ``inserted_n`` the frame's inserts; ``lm_live`` / ``lm_run`` are read
    on the frames that ran a window BA; each body's stamps hold its stages
    in order."""
    from vslam_tpu_torch.utils import profiling

    vo, _ = both
    rec = vo.spans
    assert profiling.latest_spans() is rec or profiling.latest_spans()
    res = vo.results()
    take, want = np.ones(vo.S, bool), []
    for f in range(FRAMES):
        want.append(int(take.sum()))
        take = ((take | (res["inliers"][:, f] < CFG["new_kf_min_inliers"]))
                & ~res["is_keyframe"][:, f])
    np.testing.assert_array_equal(rec.counter("kf_pending_n", 0, FRAMES),
                                  want)
    assert max(want) >= 2, "no frame had a request waiting behind another"
    np.testing.assert_array_equal(
        rec.counter("inserted_n", 0, FRAMES),
        [int(i.inserted.sum()) for i in vo.infos])
    ba = np.array([i.ba_seq is not None for i in vo.infos])
    live = rec.counter("lm_live", 0, FRAMES)
    np.testing.assert_array_equal(np.isfinite(live), ba)
    assert (live[ba] >= 1).all()
    assert (rec.counter("lm_run", 0, FRAMES)[ba] == CFG["ba_max_iters"]).all()
    fire = np.array([i.fire for i in vo.infos])
    for body, ran in (("lockstep_track", np.ones(FRAMES, bool)),
                      ("lockstep_insert", fire), ("lockstep_ba", ba),
                      ("lockstep_advance", np.ones(FRAMES, bool))):
        cols = [rec._col[body, s] for s in profiling.BODY_STAGES[body]]
        st = rec._stamps[:FRAMES][:, cols]
        np.testing.assert_array_equal((st > 0).all(1), ran, err_msg=body)
        assert (np.diff(st[ran], axis=1) >= 0).all(), body
    got = rec.read(0, FRAMES)
    assert got["spans"]["frame"]["count"] == FRAMES
    assert got["spans"]["launch.lockstep_insert"]["count"] == fire.sum()
    assert got["idle"]["frames"] == FRAMES


def test_lockstep_bodies_hold_no_host_read(worlds, monkeypatch):
    """Every lockstep body, run under ``no_host_read`` by the driver itself
    over frames 1-5 (inserts of sequences 1 and 2 and their window BAs),
    with the spans on. Frame 0 runs first without the check: the first
    call of each body runs eagerly on the card before its capture, and
    makes the per-device constant tables from host data once."""
    vo = MultiSeqVO(worlds[0].calib, S, SlamConfig(**CFG), max_frames=8,
                    device="cpu")
    vo.process_frames(*lockstep(worlds, 0))
    ran = []
    for name in ("_track_body", "_insert_body", "_ba_body", "_advance_body"):
        def guarded(*a, _f=getattr(vo, name), _n=name, **k):
            ran.append(_n)
            with no_host_read():
                return _f(*a, **k)
        monkeypatch.setattr(vo, name, guarded)
    for f in range(1, 6):
        vo.process_frames(*lockstep(worlds, f))
    assert ran.count("_track_body") == ran.count("_advance_body") == 5
    assert ran.count("_insert_body") >= 2 and ran.count("_ba_body") >= 2
    assert [i.ba_seq for i in vo.infos[1:3]] == [1, 2]


def test_cuda_graphs_argument(worlds):
    calib, cfg = worlds[0].calib, SlamConfig(**CFG)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        MultiSeqVO(calib, S, cfg, device="cpu", cuda_graphs=True)
    for flag in (None, False):
        vo = MultiSeqVO(calib, S, cfg, device="cpu", cuda_graphs=flag)
        assert vo.cuda_graphs is False and vo.spans
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="mesh"):
        MultiSeqVO(calib, S, cfg, mesh=mesh, device="cpu", cuda_graphs=True)
    vo = MultiSeqVO(calib, S, cfg, mesh=mesh, device="cpu")
    assert vo.cuda_graphs is False and not vo.spans


def test_results_log_the_tracked_flag(both):
    """``results()["tracked_ok"]`` is each rig's ``pnp_ok`` per frame: the
    bootstrap frames of the rigs not yet served track nothing, and every
    frame with inliers tracked."""
    vo, _ = both
    res = vo.results()
    ok, inl = res["tracked_ok"], res["inliers"]
    assert ok.shape == (S, FRAMES) and ok.dtype == bool
    np.testing.assert_array_equal(ok, inl > 0)
    assert not ok[:, 0].any() and ok[:, S:].all()
