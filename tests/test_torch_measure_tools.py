"""The port's measurement tools (``vslam_tpu_torch/tools/``) on the CPU,
held against the repository's JAX tools (``tools/*.py``) where the two
compute the same thing.

- ``bench_vocab`` at depth 3 beside the JAX tool: the DBoW2 text files
  byte for byte, the word and node counts, every descriptor's word and
  the recall.
- ``bench_gba_scale`` at 32 pairs (64 cameras, 512 landmarks, 8192
  observations) beside the JAX tool: the problem's sizes, the initial
  cost within 1e-5 relative, the final cost within 1e-3, the LM
  iterations that ran; ``iter_ms`` is taken over those iterations.
- ``bench_worlds.full_slam_world`` at 24 frames beside
  ``bench.full_slam_world``: the images bit for bit, every ``make_cfg``
  variant field by field, the vocabulary trained from the same pool.
- ``profile_stages`` and ``profile_kf_branch`` on a small world: every
  name the JAX tool records (read from its source), finite values, the
  frame and keyframe counts against the driver's own.
- ``ablation_reloc`` on the bench world's first 24 frames: the JAX row's
  fields, no relocalization event without relocalization, the
  gauge-segment split on a constructed case.
"""

import ast
import dataclasses
import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.tools import (ablation_reloc, bench_gba_scale,
                                   bench_vocab, bench_worlds,
                                   profile_kf_branch, profile_stages)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tests run in parallel workers, and small
    tensors gain nothing from more (oversubscribed, they lose much)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tool(name):
    """The repository's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_main(monkeypatch, name, args):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    jax_tool(name).main()


def recorded_names(name):
    """The record names the JAX tool writes, read from its source: the
    first argument of every ``rec(...)`` and ``stage(...)`` call (a stage
    also records ``<name>_device``) and every ``out["..."] = ...``."""
    with open(os.path.join(REPO, "tools", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in ("rec", "stage") and node.args
                and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value)
            if node.func.id == "stage":
                names.add(node.args[0].value + "_device")
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "out"
                        and isinstance(t.slice, ast.Constant)):
                    names.add(t.slice.value)
    return names


def all_finite(value):
    """Every number in a (nested) record is finite."""
    if isinstance(value, dict):
        return all(all_finite(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return all(all_finite(v) for v in value)
    if isinstance(value, bool) or value is None or isinstance(value, str):
        return True
    return math.isfinite(value)


def small_config(**kw):
    """tests/test_e2e_vo.py's small_config (320x240 worlds)."""
    return dict(num_features=400, ransac_hypotheses=128, max_landmarks=8192,
                max_keyframes=64, max_inview_landmarks=512, window_cams=24,
                window_points=2048, window_obs=6144, ba_max_iters=10,
                enable_relocalization=False, enable_loop_closure=False, **kw)


# ---------------------------------------------------------------------------
# bench_vocab
# ---------------------------------------------------------------------------

def test_bench_vocab_matches_the_jax_tool(tmp_path, monkeypatch):
    from vslam_tpu.loop import vocabulary as jvocab

    jpath, jjson = str(tmp_path / "jax_voc.txt"), str(tmp_path / "jax.json")
    run_jax_main(monkeypatch, "bench_vocab",
                 ["--depth", "3", "--keep", jpath, "--json", jjson])
    with open(jjson) as f:
        want = json.load(f)
    tpath = str(tmp_path / "port_voc.txt")
    out, voc, words = bench_vocab.bench(3, tpath, "cpu")
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    jv = jvocab.synthetic_vocab(k=10, depth=3, seed=0)
    assert out["words"] == want["words"] == jv.num_words == voc.num_words
    assert out["nodes"] == len(jv.parent) == 1111
    descs, word_gt = bench_vocab.queries(voc)
    jwords = np.asarray(jvocab.DeviceVocabulary(jv).words(
        descs, np.ones(len(descs), bool)))
    np.testing.assert_array_equal(words, jwords)
    assert out["recall_3bit_noise"] == pytest.approx(
        want["recall_3bit_noise"], abs=5e-5)   # the JAX tool rounds to 4
    assert out["recall_3bit_noise"] == float(np.mean(jwords == word_gt))
    assert out["parser"] == ("native" if "parse_native_s" in want
                             else "numpy")
    for key in want:
        assert key in out, key
    assert all_finite(out)


def test_bench_vocab_command_line_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        bench_vocab.main(["--depth", "2"])


# ---------------------------------------------------------------------------
# bench_gba_scale
# ---------------------------------------------------------------------------

def test_bench_gba_scale_matches_the_jax_tool(tmp_path, monkeypatch):
    """The JAX tool solves the port's problem: its own generator
    (tests/test_ba_scale.make_big_problem) also keeps the observations
    behind a camera that the pinhole flips into the image box, half of
    the valid ones at 32 pairs (5120 against 2560), which the port's
    ``synthetic.make_big_problem`` drops."""
    import jax.numpy as jnp
    import test_ba_scale
    from vslam_tpu.solvers import ba as jba
    from vslam_tpu.solvers import ba_cg as jba_cg
    from vslam_tpu_torch import synthetic

    def port_problem(n_pairs):
        arrays, poses_gt, points_gt = synthetic.make_big_problem(
            n_pairs=n_pairs)
        return (jba.BAProblem(**{k: jnp.asarray(v)
                                 for k, v in arrays.items()}),
                poses_gt, points_gt)

    monkeypatch.setattr(test_ba_scale, "make_big_problem", port_problem)
    jout = str(tmp_path / "jax.json")
    run_jax_main(monkeypatch, "bench_gba_scale",
                 ["--pairs", "32", "--out", jout])
    with open(jout) as f:
        (want,) = json.load(f)
    _, _, sj = jba_cg.solve_ba_cg(port_problem(32)[0], cam_name="pinhole",
                                  huber=2.0, max_iters=3, cg_iters=8)

    tout = str(tmp_path / "port.json")
    (row,) = bench_gba_scale.main(["--pairs", "32", "--out", tout,
                                   "--device", "cpu"])
    with open(tout) as f:
        assert json.load(f) == [row]
    assert (row["cams"], row["landmarks"], row["observations"]) == (
        want["cams"], want["landmarks"], want["observations"]) == (
        64, 512, 8192)
    assert row["initial_cost"] == pytest.approx(want["initial_cost"],
                                                rel=1e-5)
    assert row["final_cost"] == pytest.approx(want["final_cost"], rel=1e-3)
    assert row["iterations"] == int(sj["iterations"]) >= 1
    assert row["iter_ms"] == pytest.approx(
        1e3 * row["total_s"] / row["iterations"])
    assert row["final_cost"] < 0.5 * row["initial_cost"]
    assert row["peak_hbm_mb"] is None and row["backend"] == "cpu"
    for key in want:
        assert key in row, key


# ---------------------------------------------------------------------------
# bench_worlds.full_slam_world, and the ablation on it
# ---------------------------------------------------------------------------

FRAMES = 24


@pytest.fixture(scope="module")
def worlds():
    """(the JAX bench's world and the pool its vocabulary was trained on,
    the port's world)."""
    import bench
    from vslam_tpu.loop import vocabulary as jvocab

    pools = []
    set_idf = jvocab.set_idf_weights

    def keeping(voc, pool):
        pools.append(pool)
        return set_idf(voc, pool)

    jvocab.set_idf_weights = keeping
    try:
        jseq, _, jvoc, jmake = bench.full_slam_world(FRAMES, 300)
    finally:
        jvocab.set_idf_weights = set_idf
    return (jseq, jvoc, jmake, pools[0]), bench_worlds.full_slam_world(
        FRAMES, 300, device="cpu")


def test_full_slam_world_is_the_bench_s(worlds):
    (jseq, jvoc, jmake, jpool), (seq, voc, make_cfg) = worlds
    assert len(seq.images) == len(jseq.images) == FRAMES
    for (la, ra), (lb, rb) in zip(jseq.images, seq.images):
        assert la.tobytes() == lb.tobytes() and ra.tobytes() == rb.tobytes()
    assert jseq.poses.tobytes() == seq.poses.tobytes()
    for kw in ablation_reloc.VARIANTS.values():
        assert dataclasses.asdict(make_cfg(**kw)) == dataclasses.asdict(
            jmake(**kw)), kw
    # the vocabulary from the JAX features' pool
    got = bench_worlds.train_vocabulary(jpool)
    for f in dataclasses.fields(jvoc):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(jvoc, f.name), err_msg=f.name)
    # the port's own pool: one array per 24th frame, 300 features at most
    assert len(voc.weights) == voc.num_words > 100
    assert np.isfinite(voc.weights).all()


def test_full_slam_world_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        bench_worlds.full_slam_world(2, 300)


JAX_ABLATION_FIELDS = {"variant", "ate_m", "keyframes", "tracked_frames",
                       "loss_frame", "loops_closed", "gba_merges",
                       "reloc_events", "loop_stats", "run", "drift_pct"}


def test_ablation_rows(worlds, tmp_path):
    """On the bench world's first 24 frames (its motion per frame; the
    24-frame world of ``full_slam_world`` turns 26 degrees a frame and
    loses track at once), with a vocabulary of every 4th frame."""
    from vslam_tpu_torch.synthetic_pano import generate_pano_loop

    make_cfg = worlds[1][2]
    seq = generate_pano_loop(num_frames=FRAMES, width=752, height=480,
                             revolutions=1.75 * FRAMES / 288, seed=2)
    voc = bench_worlds.train_vocabulary(bench_worlds.vocabulary_pool(
        seq.images, range(0, FRAMES, 4), 300, "cpu"))
    out = ablation_reloc.main(
        ["--frames", str(FRAMES), "--variants", "vo,lc,reloc",
         "--out", str(tmp_path / "ablation.json"), "--device", "cpu"],
        world=(seq, voc, make_cfg))
    with open(tmp_path / "ablation.json") as f:
        assert json.load(f) == json.loads(json.dumps(out))
    assert out["traj_len_m"] == pytest.approx(float(np.linalg.norm(
        np.diff(seq.poses[:, :3], axis=0), axis=1).sum()))
    rows = {r["variant"]: r for r in out["rows"]}
    assert set(rows) == {"vo", "lc", "reloc"}
    for name, r in rows.items():
        assert JAX_ABLATION_FIELDS - {"loop_stats"} <= set(r), name
        assert np.isfinite(r["ate_m"]) and r["keyframes"] >= 3
        assert r["tracked_frames"] == FRAMES - 1   # all after the bootstrap
        assert r["loss_frame"] is None
        assert r["drift_pct"] == pytest.approx(
            100 * r["ate_m"] / out["traj_len_m"])
    # a run without relocalization has no relocalization event; the
    # variants with loop closure or relocalization run StreamingSLAM
    assert rows["vo"]["reloc_events"] == rows["lc"]["reloc_events"] == []
    assert "loop_stats" not in rows["vo"]
    assert "loop_stats" in rows["lc"] and "loop_stats" in rows["reloc"]
    assert rows["vo"]["loops_closed"] == rows["vo"]["gba_merges"] == 0
    lines = ablation_reloc.table(out["rows"]).splitlines()
    assert len(lines) == 4 and lines[0].split()[0] == "variant"


def test_ablation_segment_split():
    """Keyframes before the first lost frame against the rest, each
    segment aligned on its own: two rigidly moved copies of one path
    align exactly each, and not together."""
    rng = np.random.RandomState(0)
    fids = np.arange(0, 40, 2)
    gt = np.cumsum(rng.normal(0, 0.3, (len(fids), 3)), axis=0)
    c, s = np.cos(0.4), np.sin(0.4)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    pos = gt.copy()
    late = fids >= 17
    pos[late] = gt[late] @ R.T + [3.0, -1.0, 0.5]
    out = ablation_reloc.segment_ate(fids, pos, gt, 17)
    assert out["kf_pre_loss"] == 9 and out["kf_post_loss"] == 11
    assert out["ate_pre_loss_m"] < 1e-6 and out["ate_post_loss_m"] < 1e-6
    from vslam_tpu_torch.eval import ate
    assert ate.align_svd(pos, gt)[2] > 0.1
    # a segment of fewer than 3 keyframes has no ATE
    out = ablation_reloc.segment_ate(fids, pos, gt, 4)
    assert out["kf_pre_loss"] == 2 and "ate_pre_loss_m" not in out
    assert out["kf_post_loss"] == 18 and "ate_post_loss_m" in out


# ---------------------------------------------------------------------------
# profile_stages and profile_kf_branch
# ---------------------------------------------------------------------------

def test_profile_stages_records_every_stage():
    out, slam = profile_stages.profile(
        frames=6, reps=3, device="cpu", width=320, height=240,
        config=SlamConfig(**small_config()))
    missing = recorded_names("profile_stages") - set(out)
    assert not missing, missing
    assert all_finite(out)
    assert out["frames"] == 6 == len(slam.stats) - 6
    assert out["keyframes"] == sum(
        s["kind"] == "keyframe" for s in slam.stats[-6:])
    assert out["e2e_fps"] == pytest.approx(1e3 / out["e2e_ms_per_frame"])
    for stage in ("extract_features", "match_landmarks", "ransac_pnp",
                  "track_frame_fused", "stereo_match", "window_ba_solve"):
        assert out[stage] > 0 and out[stage + "_device"] > 0, stage
        assert out[stage + "_device_ops"] >= 1, stage
    assert out["timer"] == slam.timer.summary()
    assert out["backend"] == "cpu"


def test_profile_kf_branch_records_every_piece():
    out, forced, never = profile_kf_branch.profile(
        device="cpu", num_frames=44, num_points=500, width=320, height=240,
        base=small_config())
    missing = recorded_names("profile_kf_branch") - set(out)
    assert not missing, missing
    assert all_finite(out)
    # forced: a keyframe on every frame the previous one did not take
    # (a keyframe step resets the request); never: the bootstrap only
    kf_forced = forced.results()["is_keyframe"]
    kf_never = never.results()["is_keyframe"]
    assert kf_forced[::2].all() and not kf_forced[1::2].any()
    assert kf_never[0] and not kf_never[1:].any()
    assert out["keyframe branch (delta)"] == pytest.approx(
        out["per-frame, KF every frame"] - out["per-frame, KF never"])
    assert out["keyframe branch (delta)"] > 0
    assert 0 < out["window_obs_actual"] <= 6144
    assert 0 < out["window_points_actual"] <= 2048
    assert 1 <= out["ba_iterations"] <= 10


@pytest.mark.parametrize("tool", [profile_stages, profile_kf_branch,
                                  bench_gba_scale, ablation_reloc])
def test_tools_default_to_the_card(tool):
    """Without --device the tools take the card, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        tool.main(["--pairs", "1"] if tool is bench_gba_scale else [])


@pytest.mark.parametrize("name", ["profile_stages", "profile_kf_branch",
                                  "bench_gba_scale", "bench_vocab",
                                  "ablation_reloc"])
def test_flags_are_the_jax_tool_s(name):
    """Each port keeps the JAX tool's flags and defaults and adds
    --device (``ablation_reloc``'s ``--chunk`` included: the port's
    ``StreamingSLAM`` reads its logs on the same chunk boundaries)."""
    def flags(path):
        with open(path) as f:
            tree = ast.parse(f.read())
        got = {}
        for n in ast.walk(tree):
            if (isinstance(n, ast.Call)
                    and getattr(n.func, "attr", "") == "add_argument"):
                kw = {k.arg: k.value for k in n.keywords}
                default = kw.get("default")
                got[n.args[0].value] = (
                    default.value if isinstance(default, ast.Constant)
                    else ast.dump(default) if default is not None else None)
        return got

    want = flags(os.path.join(REPO, "tools", f"{name}.py"))
    got = flags(os.path.join(REPO, "vslam_tpu_torch", "tools",
                             f"{name}.py"))
    assert set(got) == set(want) | {"--device"}
    assert got["--device"] == "cuda"
    for flag, default in want.items():
        if flag == "--out":
            continue
        assert got[flag] == default, flag


@pytest.mark.parametrize("name", ["bench_worlds", "profile_stages",
                                  "profile_kf_branch", "bench_gba_scale",
                                  "bench_vocab", "ablation_reloc"])
def test_tools_import_neither_jax_nor_the_benchmark_nor_tests(name):
    path = os.path.join(REPO, "vslam_tpu_torch", "tools", f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "flax", "vslam_tpu", "bench",
                        "tests", "conftest"}, roots
    assert not any(r.startswith("test_") for r in roots), roots
