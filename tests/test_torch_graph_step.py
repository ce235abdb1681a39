"""The streaming drivers' step in the form a CUDA graph can hold, on the
CPU, beside the JAX package's compiled step.

The port's ``StreamingVO`` runs each frame as bodies T (tracking), A (a
tracking frame's advance) and K (the keyframe branch, then the advance)
that read nothing back to the host; on the card it replays them as CUDA
graphs (``tests/test_torch_cuda.py`` holds the graphs against the eager
step there). Here:

- the window BA's masked LM loop (``max_iters`` bodies, the updates gated
  on a device ``done`` flag) against JAX's ``lax.while_loop`` solvers on
  tests/test_torch_ba.py's problems: poses within 1e-4, points within
  1e-4 relative, final cost within rtol 1e-4 (that file's tolerances:
  float32 sums taken in another order), the iteration count within one
  (the exit tests compare float32 reductions with the tolerances); and
  against the port's own host early exit, bit for bit and to the same
  count (the masked bodies change nothing once ``done`` is set); its one
  body writes the carried state in place, buffers at fixed addresses
  (the card's IF bodies rely on it: ``tests/test_torch_cuda.py``), and a
  CPU problem runs the masked loop whatever is being captured;
- the masked keyframe insert against JAX below the keyframe capacity and
  past it (``slot >= Kcap``), and the on-device culling choice against
  JAX's ``lax.cond`` above and below the pressure: integers equal, floats
  within 1e-5 (new landmarks' positions within 5e-3 relative plus 1e-3 m,
  tests/test_torch_map_pressure.py's bound for float32 triangulation);
- each body run with every host read patched to raise (``no_host_read``),
  on a tracking frame and on a keyframe;
- the whole driver against the JAX driver on tests/test_torch_streaming.py's
  world (that file's bounds) and against the eager driver of the commit
  before the graph form (its logs, recorded below from one generator);
- the logs drop writes past ``max_frames``; ``cuda_graphs=True`` raises on
  the CPU; ``set_param`` drops captured graphs; a replay raises on a moved
  state buffer and adds the graph's kernel launches to the counts.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import test_lm_recycling as jrec
from test_streaming import small_config
from test_torch_ba import CASES, TOL, golden_problem
from test_torch_map_pressure import POS_RTOL, _insert_both, port
from test_torch_streaming import assert_same, tt
from vslam_tpu.core import state as jstate
from vslam_tpu.geometry import lie as jlie
from vslam_tpu.pipeline import keyframe as jkf
from vslam_tpu.pipeline.streaming import StreamingVO as JaxStreamingVO
from vslam_tpu.solvers import ba as jba
from vslam_tpu_torch import interop, synthetic
from vslam_tpu_torch.eval import ate
from vslam_tpu_torch.ops import cuda_hamming
from vslam_tpu_torch.pipeline import keyframe as tkf
from vslam_tpu_torch.pipeline import streaming
from vslam_tpu_torch.pipeline.streaming import StreamingVO
from vslam_tpu_torch.solvers import ba as tba


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the eager driver's CPU sums follow the thread
    count (the record below is the one-thread run), and the tests run in
    parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# no host read
# ---------------------------------------------------------------------------

aten = torch.ops.aten
# operations that read a device tensor back to the host (or size their
# output by its values, which is the same thing)
_HOST_READ_OPS = {aten._local_scalar_dense.default, aten.nonzero.default,
                  aten.masked_select.default, aten.equal.default,
                  aten.is_nonzero.default, aten.repeat_interleave.Tensor,
                  aten._unique2.default, aten.unique_dim.default,
                  aten.unique_consecutive.default}
_INDEX_OPS = {aten.index.Tensor, aten.index_put.default,
              aten.index_put_.default, aten._index_put_impl_.default}


class _NoHostRead(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        bad = func in _HOST_READ_OPS or (
            func in _INDEX_OPS and any(
                i is not None and i.dtype in (torch.bool, torch.uint8)
                for i in args[1]))
        if bad:
            raise AssertionError(f"host read in a step body: {func}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def no_host_read():
    """Every way a body could read a tensor back to the host raises: the
    Python conversions, a boolean-mask index (sized by its values), and a
    tensor made from host data (a copy from host memory, which a CUDA
    graph cannot capture)."""
    def refuse(what):
        def f(*a, **k):
            raise AssertionError(f"host read in a step body: {what}")
        return f

    def from_host(real, what):
        def f(data, *a, **k):
            if not torch.is_tensor(data):
                raise AssertionError(f"tensor from host data: {what}")
            return real(data, *a, **k)
        return f

    patches = [(torch.Tensor, name, refuse(name)) for name in (
        "__bool__", "__int__", "__float__", "__index__", "item", "tolist",
        "numpy", "cpu")]
    patches += [(torch, "tensor", from_host(torch.tensor, "torch.tensor")),
                (torch, "as_tensor",
                 from_host(torch.as_tensor, "torch.as_tensor")),
                (torch.Tensor, "new_tensor",
                 lambda self, data, *a, **k: from_host(
                     torch.Tensor.new_tensor, "new_tensor")(data)
                 if not torch.is_tensor(data) else data)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        with _NoHostRead():
            yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def test_no_host_read_catches_host_reads():
    """The checker itself: each kind of host read raises inside it."""
    x = torch.arange(4)
    for read in (lambda: bool(x[0]), lambda: x[x > 1],
                 lambda: torch.nonzero(x), lambda: x[torch.tensor(1)],
                 lambda: torch.tensor([1.0]), lambda: x.sum().item()):
        with pytest.raises(AssertionError), no_host_read():
            read()
    with no_host_read():
        torch.where(x > 1, x, 0).index_fill_(0, x[:1], 7)


# ---------------------------------------------------------------------------
# the masked LM loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,cam,pad", CASES)
def test_masked_lm_loop_matches_jax_while_loop(seed, cam, pad):
    arrays = golden_problem(seed, cam, pad=pad)
    pj, xj, sj = jba.solve_ba_schur(
        jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        cam_name=cam, huber=1.0, max_iters=30)
    prob = interop.from_arrays(tba.BAProblem, arrays, "cpu")
    with no_host_read():
        pt, xt, st = tba.solve_ba_schur(prob, cam_name=cam, huber=1.0,
                                        max_iters=30)
    # the function-tolerance exit compares a float32 cost reduction with
    # 1e-6 of the cost: on problem 0 the last step's reduction sits at
    # that edge, and JAX takes one more (rejected) body than the port, as
    # the port's eager loop did; the other three stop on the same body
    assert abs(int(st["iterations"]) - int(sj["iterations"])) <= 1
    assert int(st["iterations"]) < 30
    np.testing.assert_allclose(float(st["final_cost"]),
                               float(sj["final_cost"]), rtol=TOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=TOL, rtol=0)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=TOL, atol=0)
    # the host early exit: the same bits
    pe, xe, se = tba.solve_ba_schur(prob, cam_name=cam, huber=1.0,
                                    max_iters=30, early_exit=True)
    assert se["iterations"] == int(st["iterations"])
    for a, b in ((pe, pt), (xe, xt), (se["final_cost"], st["final_cost"]),
                 (se["lambda"], st["lambda"])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_masked_lm_loop_intrinsics_matches_jax():
    """``synthetic.make_intrinsics_problem`` (tests/test_torch_ba.py's
    well-determined free-intrinsics problem) at that file's bars for it:
    final cost rtol 1e-3, intrinsics within 0.05 px."""
    arrays = synthetic.make_intrinsics_problem()
    pj, xj, ij, sj = jba.solve_ba_schur_intrinsics(
        jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        cam_name="pinhole", huber=2.0, max_iters=30)
    tp = interop.from_arrays(tba.BAProblem, arrays, "cpu")
    with no_host_read():
        pt, xt, it, st = tba.solve_ba_schur_intrinsics(
            tp, cam_name="pinhole", huber=2.0, max_iters=30)
    # (the iteration counts differ in the flat tail, 17 against 5: the
    # cost there changes by less than float32 resolves)
    np.testing.assert_allclose(float(st["final_cost"]),
                               float(sj["final_cost"]), rtol=1e-3)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), atol=5e-2)
    pe, xe, ie, se = tba.solve_ba_schur_intrinsics(
        tp, cam_name="pinhole", huber=2.0, max_iters=30, early_exit=True)
    assert se["iterations"] == int(st["iterations"])
    for a, b in ((pe, pt), (xe, xt), (ie, it),
                 (se["final_cost"], st["final_cost"])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("seed,cam,pad", CASES)
def test_lm_body_writes_the_carried_state_in_place(seed, cam, pad):
    """``lm_body``, the one LM body both of ``solve_ba_schur``'s loops run,
    writes the carried state in place: every buffer stays at its address
    from body to body and the problem is left as it was. Thirty bodies of
    it give the solver's bits and count, and a body after the exit changes
    nothing."""
    arrays = golden_problem(seed, cam, pad=pad)
    prob = interop.from_arrays(tba.BAProblem, arrays, "cpu")
    carry = tba.lm_carry(prob, cam, 1.0, 1e-4)
    fields = [f.name for f in dataclasses.fields(carry)]
    ptrs = {n: getattr(carry, n).data_ptr() for n in fields}
    with no_host_read():
        for _ in range(30):
            tba.lm_body(prob, carry, cam, 1.0, 10.0)
            assert {n: getattr(carry, n).data_ptr() for n in fields} == ptrs
    assert bool(carry.done)
    np.testing.assert_array_equal(prob.poses.numpy(), arrays["poses"])
    np.testing.assert_array_equal(prob.points.numpy(), arrays["points"])
    pt, xt, st = tba.solve_ba_schur(prob, cam_name=cam, huber=1.0,
                                    max_iters=30)
    for a, b in ((carry.poses, pt), (carry.points, xt),
                 (carry.cost, st["final_cost"]), (carry.lam, st["lambda"]),
                 (carry.iters, st["iterations"])):
        assert torch.equal(a, b)
    before = {n: getattr(carry, n).clone() for n in fields}
    tba.lm_body(prob, carry, cam, 1.0, 10.0)
    for n in fields:
        assert torch.equal(getattr(carry, n), before[n]), n


def test_lm_loop_on_the_cpu_is_masked_whatever_is_captured(monkeypatch):
    """The IF bodies are chosen only for a problem on the card whose stream
    is being captured: a CPU problem runs the masked loop even while some
    capture is underway, and an IF node refuses a predicate that is not a
    0-dim bool on the card."""
    from vslam_tpu_torch.ops import cuda_graphs

    arrays = golden_problem(1, "pinhole")
    prob = interop.from_arrays(tba.BAProblem, arrays, "cpu")
    want = tba.solve_ba_schur(prob, cam_name="pinhole", max_iters=30)

    def no_if_node(pred):
        raise AssertionError("an IF node for a CPU problem")

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(cuda_graphs, "if_node", no_if_node)
    got = tba.solve_ba_schur(prob, cam_name="pinhole", max_iters=30)
    for a, b in ((got[0], want[0]), (got[1], want[1]),
                 (got[2]["iterations"], want[2]["iterations"])):
        assert torch.equal(a, b)
    monkeypatch.undo()
    for pred in (torch.ones((), dtype=torch.bool),
                 torch.ones(1, dtype=torch.bool)):
        with pytest.raises(ValueError, match="0-dim bool CUDA"):
            with cuda_graphs.if_node(pred):
                pass


# ---------------------------------------------------------------------------
# the masked keyframe insert and the on-device culling choice
# ---------------------------------------------------------------------------

K_SMALL = 3   # keyframe capacity of the insert cases


@pytest.mark.parametrize("inserts", [K_SMALL, K_SMALL + 2],
                         ids=["below_capacity", "past_capacity"])
def test_masked_insert_matches_jax(inserts):
    """Inserts into a table of K_SMALL keyframes: the first one triangulates
    every feature, the later ones track those landmarks. Past the capacity
    the keyframe record is dropped (slot >= Kcap) while the observations
    and covisibility are written as JAX writes them."""
    kj = jstate.init_keyframes(K_SMALL, jrec.N)
    lj = jstate.init_landmarks(jrec.L_CAP, M=8, M2=8, B=2)
    kt, lt = port(kj, lj)
    key = jax.random.PRNGKey(3)
    for step in range(inserts):
        key, k = jax.random.split(key)
        pose = jlie.identity_pose().at[0].set(0.05 * step)
        f_l, f_r = jrec._fake_features(k, pose, jrec.T_0_1)
        track = step > 0
        out_j, out_t = _insert_both(
            kj, lj, kt, lt, step, pose, f_l, f_r,
            np.arange(jrec.N, dtype=np.int32) if track else None,
            np.ones(jrec.N, bool) if track else None)
        kj, lj, kt, lt = out_j.kf, out_j.lm, out_t.kf, out_t.lm
        assert_same(kt, kj)
        assert_same(lt, lj, atol=1e-3, rtol=POS_RTOL)
        np.testing.assert_array_equal(out_t.covis_weight.numpy(),
                                      np.asarray(out_j.covis_weight))
    assert int(out_t.slot) == inserts - 1
    assert int(kt.valid.sum()) == min(inserts, K_SMALL)


@pytest.mark.parametrize("above", [True, False], ids=["above", "below"])
def test_cull_selected_on_device_matches_jax_cond(above):
    """Four keyframes of new landmarks, the two oldest evicted: their
    landmarks are out of the window with one left observation, so the
    cull frees them. Above the pressure both packages cull; below it both
    leave the state as it is."""
    kj = jstate.init_keyframes(8, jrec.N)
    lj = jstate.init_landmarks(jrec.L_CAP, M=8, M2=8, B=2)
    kt, lt = port(kj, lj)
    key = jax.random.PRNGKey(0)
    for step in range(4):
        key, k = jax.random.split(key)
        pose = jlie.identity_pose().at[0].set(0.3 * step)
        f_l, f_r = jrec._fake_features(k, pose, jrec.T_0_1)
        out_j, out_t = _insert_both(kj, lj, kt, lt, step, pose, f_l, f_r)
        kj, lj, kt, lt = out_j.kf, out_j.lm, out_t.kf, out_t.lm
    evict = np.arange(8) < 2
    kj, lj = jkf.deactivate_keyframes(kj, lj, jnp.asarray(evict))
    kt, lt = tkf.deactivate_keyframes(kt, lt, tt(evict))
    filled = int(lt.valid.sum()) / jrec.L_CAP
    pressure = filled - 0.01 if above else filled + 0.01
    thresh = int(pressure * jrec.L_CAP)

    def cull(a):
        k3, l3, _ = jkf.cull_landmarks(a[0], a[1], min_lifetime_obs=3)
        return k3, l3

    kj2, lj2 = jax.lax.cond(jnp.sum(lj.valid) >= thresh, cull, lambda a: a,
                            (kj, lj))
    before = interop.to_arrays(lt)
    with no_host_read():
        kt2, lt2 = tkf.cull_under_pressure(kt, lt, pressure, 3)
    assert_same(kt2, kj2)
    assert_same(lt2, lj2, atol=1e-3, rtol=POS_RTOL)
    freed = int(lt.valid.sum()) - int(lt2.valid.sum())
    assert (freed > 0) == above
    if not above:
        for name, value in interop.to_arrays(lt2).items():
            np.testing.assert_array_equal(value, before[name], err_msg=name)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seq():
    return synthetic.generate(num_frames=24, num_points=500, seed=3)


@pytest.fixture(scope="module")
def port_run(seq):
    vo = StreamingVO(seq.calib, small_config(), max_frames=64, device="cpu")
    vo.run(seq.images)
    return vo


def test_bodies_hold_no_host_read(seq, monkeypatch):
    """Bodies T, A and K, each run under ``no_host_read`` by the driver
    itself over frames 1-5 (a keyframe at frame 4), with the spans on:
    their stage stamps and counters read nothing back either. Frame 0 runs
    first without the check, as the first call of each body runs eagerly
    on the card before its capture: it makes the per-device constant
    tables (``ops.describe``) from host data once."""
    vo = StreamingVO(seq.calib, small_config(), max_frames=16, device="cpu",
                     spans=True)
    vo.run(seq.images[:1])
    ran = []
    for name in ("_track", "_advance_body", "_keyframe_body"):
        def guarded(*a, _f=getattr(vo, name), _n=name):
            ran.append(_n)
            with no_host_read():
                return _f(*a)
        monkeypatch.setattr(vo, name, guarded)
    vo.run(seq.images[1:6])
    assert ran.count("_track") == 5
    assert ran.count("_keyframe_body") == 1
    assert ran.count("_advance_body") == 4
    spans = vo.spans.read(1, 6)["spans"]
    assert spans["device.track"]["count"] == 5
    assert spans["device.keyframe"]["count"] == 1
    assert spans["device.advance"]["count"] == 4


def test_driver_matches_jax_driver(port_run, seq):
    """tests/test_torch_streaming.py's bounds against the JAX driver."""
    jvo = JaxStreamingVO(seq.calib, small_config(), max_frames=64)
    jvo.run(seq.images, sync_every=0)
    res = port_run.results()
    assert res["tracked_ok"][2:].all()
    assert np.median(res["inliers"][2:]) > 30

    def kf_ate(vo):
        fids, pos, _ = vo.keyframe_trajectory()
        return ate.align_svd(pos, seq.poses[fids, :3])[2], fids

    (r_port, f_port), (r_jax, f_jax) = kf_ate(port_run), kf_ate(jvo)
    assert r_port < 0.08 and r_port < max(2.0 * r_jax, 0.05)
    assert len(f_port) == len(f_jax) >= 3
    assert np.abs(f_port - f_jax).max() <= 1


# the eager driver's logs before the step took its graph form (the same
# world and configuration, generator seeded from config.seed), on the CPU
# with one thread
PARENT_KEYFRAMES = [0, 4, 11, 14, 19]
PARENT_INLIERS = [0, 75, 64, 45, 40, 92, 80, 82, 71, 60, 43, 31, 79, 59, 44,
                  82, 72, 62, 58, 52, 103, 90, 70, 55]
PARENT_SLOTS = [0, -1, -1, -1, 1, -1, -1, -1, -1, -1, -1, 2, -1, -1, 3, -1,
                -1, -1, -1, 4, -1, -1, -1, -1]
PARENT_POSITIONS = [
    [0.000000, 0.000000, 0.000000], [0.031660, 0.032660, 0.052720],
    [0.066061, 0.057251, 0.092461], [0.089190, 0.085951, 0.145323],
    [0.139987, 0.125409, 0.197109], [0.172746, 0.129569, 0.242937],
    [0.204725, 0.126840, 0.294878], [0.230843, 0.126609, 0.339662],
    [0.262811, 0.106805, 0.401085], [0.304556, 0.079468, 0.432048],
    [0.337832, 0.040642, 0.490618], [0.371338, 0.008844, 0.530826],
    [0.399266, -0.021860, 0.578860], [0.430324, -0.047625, 0.623929],
    [0.472624, -0.129093, 0.678402], [0.508658, -0.136818, 0.730020],
    [0.552036, -0.151523, 0.773818], [0.573280, -0.158915, 0.812151],
    [0.611999, -0.156022, 0.861158], [0.645327, -0.151579, 0.915385],
    [0.678094, -0.130576, 0.963025], [0.718702, -0.104031, 1.006782],
    [0.741308, -0.085219, 1.058010], [0.775327, -0.041688, 1.108334]]


def test_driver_matches_eager_driver_logs(port_run):
    """The keyframe decisions, slots, inliers and tracked flags equal the
    eager driver's; positions within 1e-5 m (the record's six decimals and
    float32 rounding)."""
    res = port_run.results()
    assert np.flatnonzero(res["is_keyframe"]).tolist() == PARENT_KEYFRAMES
    assert res["inliers"].tolist() == PARENT_INLIERS
    assert port_run.state.log_slot[:24].tolist() == PARENT_SLOTS
    assert res["tracked_ok"][1:].all() and not res["tracked_ok"][0]
    assert not res["window_obs_dropped"].any()
    np.testing.assert_allclose(res["trajectory"][:, :3], PARENT_POSITIONS,
                               atol=1e-5, rtol=0)


def test_logs_drop_writes_past_max_frames(seq, port_run):
    """A 4-frame log run over 8 frames holds the first 4 frames as the
    64-frame log does: the later writes are dropped, not clamped onto the
    last row."""
    vo = StreamingVO(seq.calib, small_config(), max_frames=4, device="cpu")
    vo.run(seq.images[:8])
    short, full = vo.results(), port_run.results()
    assert short["frames"] == 8 and len(short["trajectory"]) == 4
    for name in ("trajectory", "inliers", "is_keyframe", "tracked_ok"):
        np.testing.assert_array_equal(short[name], full[name][:4],
                                      err_msg=name)
    assert vo.state.log_slot.tolist() == PARENT_SLOTS[:4]


# ---------------------------------------------------------------------------
# the argument, the graphs' bookkeeping and the replay guard
# ---------------------------------------------------------------------------

def test_cuda_graphs_argument(seq):
    with pytest.raises(ValueError, match="needs a CUDA device"):
        StreamingVO(seq.calib, small_config(), max_frames=8, device="cpu",
                    cuda_graphs=True)
    for flag in (None, False):
        vo = StreamingVO(seq.calib, small_config(), max_frames=8,
                         device="cpu", cuda_graphs=flag)
        assert vo.cuda_graphs is False
    # a learned frontend's driver stays eager
    vo = StreamingVO(seq.calib, small_config(), max_frames=8, device="cpu",
                     feature_fn=lambda img: None)
    assert vo.cuda_graphs is False


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _fake_capture(vo, launches):
    ptrs = {p: t.data_ptr()
            for p, t in streaming._tensor_fields(vo.state).items()}
    return streaming._Graph(_FakeGraph(), "out", launches, ptrs)


def test_set_param_drops_graphs(seq):
    vo = StreamingVO(seq.calib, small_config(), max_frames=8, device="cpu")
    vo._graphs = {"track": _fake_capture(vo, {})}
    vo.set_param("loop_verify_px", 5.0)          # host-side: kept
    assert "track" in vo._graphs
    vo.set_param("match_max_dist", 60)           # held by the graphs
    assert vo._graphs == {} and vo.tune["match_max_dist"] == 60.0


def test_replay_adds_launches_and_guards_buffers(seq):
    vo = StreamingVO(seq.calib, small_config(), max_frames=8, device="cpu")
    g = _fake_capture(vo, {"landmark_top2": 1, "hamming_top2": 2})
    before = dict(cuda_hamming.LAUNCHES)
    try:
        assert vo._replay("keyframe", g) == "out"
        assert g.graph.replays == 1
        assert cuda_hamming.LAUNCHES["landmark_top2"] == \
            before["landmark_top2"] + 1
        assert cuda_hamming.LAUNCHES["hamming_top2"] == \
            before["hamming_top2"] + 2
    finally:
        cuda_hamming.LAUNCHES.update(before)
    # host code writing in place keeps the buffers where they were
    pose = torch.tensor([0.1, 0, 0, 0, 0, 0, 1.0])
    vo.write_state(cur_pose=pose, kf=vo.state.kf.replace(
        pose_l=vo.state.kf.pose_l + 1.0))
    assert torch.equal(vo.state.cur_pose, pose)
    assert (vo.state.kf.pose_l[:, 0] == 1.0).all()
    vo._replay("keyframe", g)
    # replacing a tensor moves its buffer: the replay raises
    vo.state = vo.state.replace(lm=vo.state.lm.replace(
        pos=vo.state.lm.pos.clone()))
    with pytest.raises(RuntimeError, match="lm.pos"):
        vo._replay("keyframe", g)
    assert g.graph.replays == 2
