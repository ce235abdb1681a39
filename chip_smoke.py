"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Every phase fails the run with a nonzero exit; nothing is caught and
skipped.

1. Prints the torch / CUDA versions and the card's name and power limit;
   exits nonzero when no CUDA device is present.
2. Builds the Hamming top-2 kernels (``vslam_tpu_torch/csrc``) with nvcc
   into ``build/vslam_tpu_torch`` and prints the build time.
3. Holds each kernel against its plain PyTorch version on the card:
   exact integer equality at the main path's shapes (landmark top-2:
   N=1500 keypoints, P=2048 landmarks, B=4 bank slots; descriptor top-2:
   N=M=1500), at ragged and all-invalid shapes, at each kernel's edges
   (tiles, chunks, gate steps, bank widths 0, 1, 3 and 8, every landmark
   inside the gate and none), on tie-heavy inputs and on strided input;
   both must refuse misaligned input. At the main-path shapes, prints
   from one ``torch.profiler`` window the device time per call of
   everything the call launches ("as the main path calls it"), of the
   kernel alone and the device operations per call, the plain version's
   device time, the time per call with the host's share (CUDA events
   around each call), the least time the card could take (``bound_ms``:
   the bytes the function must move at 3.35 TB/s, or its operations at
   the card's peak rate for their type, whichever is larger), and, for
   the landmark top-2, the mean number of gated landmarks per keypoint.
   The landmark top-2 over a sequence axis (S = 1, 2 and 8 stacked
   problems at the main path's shape; a sequence without a valid keypoint,
   one with every landmark inside every gate and one with none; the tie
   cases in different sequences): exact against the plain version and
   bit-equal to S launches of the same kernel, one device operation and
   one count per call; timed at S=8 like the rest.
4. Runs the port's ``StreamingVO`` at the benchmark's configuration
   (752x480 stereo, 1500 features, 65536 landmarks, 1024 keyframes, 2048
   in-view landmarks, window BA at 24 cameras / 4096 points / 12288
   observations, 256 RANSAC hypotheses) on the benchmark's synthetic VO
   world for 128 frames (8 warm-up), with the launch counters reset just
   before the timed frames, three times: its step eager
   (``cuda_graphs=False``), as CUDA graphs (the default on the card), and
   eager again. Each run: tracking, keyframe ATE, the landmark top-2 once
   per frame and the descriptor top-2 twice per keyframe; ms per tracking
   frame and per keyframe, fps, peak memory, and the graphed run's
   capture seconds and graph pool memory. The graphed run must make the
   eager run's keyframe decisions and tracked flags with trajectories
   within 1e-4 m, or, where the two eager runs already part (the window
   BA's atomic sums), be held as they are held to each other (keyframe
   count within 1, every frame tracked, the ATE bound); the launches of
   the three runs are equal. An eager / graphed pair over the first 48
   frames in deterministic mode must agree within 1e-4 m (bit for bit
   where the draws match; printed). A ``torch.profiler`` window over 8
   graphed frames: K1's kernel events with no Python call of its wrapper
   (the kernel runs inside the replays), the host's CUDA runtime calls
   and blocking reads per frame (at most one), the device's idle share;
   and the device ms of the keyframe's landmark cull below its pressure,
   which the graphed step computes and discards.
5. Runs the port on the card and on the CPU on a small world and checks
   both against the accuracy bounds of the JAX package's streaming tests.
6. Injected drift: the scenario of tests/test_streaming_slam.py on the
   card (pano world, 256 frames, drift crept into the live gauge over
   frames 110-150) with that test's bars: a loop closes across the break,
   SLAM ATE under the injected VO run's and under 5 m, more than 90% of
   frames tracked, a GBA merge, and both kernels launched from the closure
   path. The share of the break's energy removed over the clean-VO floor
   (the test's 20% bar) is printed, not gated: see the phase's docstring.
   RANSAC seed 1 (``INJECTED_SEED``: the run is chaotic, see there).
7. Full SLAM: ``bench.full_slam_world``'s port,
   ``vslam_tpu_torch.tools.bench_worlds.full_slam_world`` (752x480 pano
   revisit world, 288 frames, 300 features, a vocabulary trained with the
   port's ``train`` on its own features), ``poll_every=32`` and ``chunk=8``
   (the logs read at every 8-frame boundary, the JAX package's schedule),
   through the benchmark program's ``bench_full_slam``: one timed run of the
   full-SLAM arm and of the VO control, 32 untimed frames and 256 timed
   each (the sub-bench's untimed warm-up run is left out: phases 4-6 have
   warmed the kernels and solvers up), its lines on the emitter phase 14
   goes on with. Prints each relocalization attempt (frame, frames lost,
   gate, candidates, best inliers, best gate error, accepted, the coasted
   pose's error against ground truth at the attempt and at the last
   tracked frame), acceptance by frames lost and the loss episodes
   (onset, length, how each ended) on a line of their own; then frames
   per second, loops, GBA merges,
   relocalizations, dropped window observations, the loop counters and
   timings, keyframe ATE of both arms, peak memory and each arm's
   launches in its timed frames, beside the JAX package's TPU figures
   (not gated on); checks that all 288 frames ran, the trajectory is
   finite, SLAM keyframe ATE is at most 1.15x the VO control's, and in
   the timed frames the control launched the landmark top-2 once per
   frame and the descriptor top-2 twice per keyframe, the SLAM arm at
   least as often. The bench's drivers replay their step as CUDA graphs;
   the SLAM arm then runs once more with ``cuda_graphs=False``, timed the
   same way, and both fps are printed with whether the two runs ended
   alike.

8. The command line at full width: phase 7's world written to a temporary
   directory as a mav0-layout dataset of binary PGM images with its
   calibration, the vocabulary as a DBoW2 text file and phase 7's
   configuration as JSON; ``cli.main`` three times (the faithful
   ``SlamSystem`` driver, the same with ``--no-loop --no-reloc`` as its
   control, ``--driver streaming``, whose ``StreamingSLAM`` reads its
   logs at ``chunk=4`` as the JAX command line's), at RANSAC seed 1
   (``CLI_SEED``: the world is chaotic, see there). Checks the return
   codes, that each
   map JSON loads and keeps the ``value0..value4`` layout, a finite ATE
   within the orbit's diameter (the faithful run against its control is
   printed: on this world the seed decides which of the two breaks), the
   same entry point on the small world of the end-to-end tests (keyframe
   ATE under 0.08 m; with ``--viz-html``, whose page must hold the run's
   trajectory), the kernels' launches (landmark top-2 at least once per
   frame, descriptor
   top-2 at least twice per keyframe) and the vocabulary read back; prints
   frames per second, loops, GBA merges, relocalizations and peak memory.
   (The streaming run's driver replays its step as CUDA graphs.)
   Then a ``checkpoint.save`` / ``load`` round trip in the middle of a
   ``SlamSystem`` run: frame 64 after a restore into a fresh system gives
   the uninterrupted run's ``info`` and pose.
9. The large-map solvers at the size they exist for: ``solve_ba_cg`` on
   the orbit problem of 8192 cameras, 65,536 landmarks and 1,048,576
   observations (3 LM iterations of 8 CG iterations; the cost must halve
   and the mean camera error fall), ``solve_pose_graph_cg`` on a ring of
   2048 keyframes with one loop edge (the cost must fall below a fifth),
   and ``run_global_ba`` on a 160-keyframe orbit state, which must take
   the matrix-free branch and lower the cost. Prints ms per LM iteration,
   CG iterations and peak memory. The orbit problem once more with its
   observations in two shards (``parallel/sharded_ba`` over a mesh that
   names the card twice): the unsharded solve's iteration count and its
   cost within 1e-3 relative, ms per LM iteration beside it. And
   ``solve_ba_schur_intrinsics`` on the problem of
   tests/test_ba.py::test_ba_joint_intrinsics_recovery (numpy draws) with
   that test's bars: cost below a tenth, fx and cx of both blocks back
   within 1.5 px.
10. The multi-sequence path at the width of ``bench.bench_multiseq``: 8
   worlds of 40 frames at 752x480 through ``MultiSeqVO`` in lockstep (8
   warm-up, 32 timed frames, host clock around ``run`` + synchronize;
   the bench's 116 frames, which phase 14 runs, cut to fit the script's
   time),
   and the single-sequence ``StreamingVO`` on the first world at the same
   configuration. Prints sequence-frames per second beside the
   single-sequence frames per second of that world and of phase 4, ms per
   lockstep frame (median, max, by kind of frame), per sequence the
   trajectory ATE, frames tracked, keyframes and window BAs, peak memory,
   the kernels' launches and, from a ``torch.profiler`` window over 4
   lockstep frames, device operations and device-to-host copies per
   lockstep frame and the device's idle share. Checks: finite poses; the
   landmark top-2 launched once per lockstep frame and the descriptor
   top-2 twice per inserted keyframe; every sequence tracked on at least
   the single-sequence driver's share of the timed frames less 0.05, with
   a trajectory ATE of at most max(2 x the single-sequence driver's,
   0.15 m), at least two keyframes and two window BAs.

11. The learned frontend and the rest of the port. SuperPoint at its
   default width (dim 256, width 64) on one 752x480 frame, fixed-seed
   weights: the card's logits and descriptors against the CPU's (1e-3
   relative), the share of equal descriptor bits where |d| > 1e-4 (gated
   at 0.999), device ms per forward and per ``extract_features_learned``
   of 512 features. In deterministic mode, the JAX tests' model (dim 64,
   width 8) trained 300 Adam steps at 2e-3 on the card and swapped into
   ``StreamingVO(feature_fn=...)``: on the JAX test's small world with
   its bars (loss under 0.8 of the first, tracked share after frame 3
   above 0.7, at least 3 keyframes, keyframe ATE under 1.3 m), then at
   full width (48 frames at 752x480, 512 learned features, a model trained
   on that world): all frames run, a finite trajectory, tracked share
   above 0.7, frames per second, ATE and peak memory printed beside the
   JAX package's TPU figures (not comparable). Both runs: the landmark
   top-2 launched once per frame and the descriptor top-2 twice per
   keyframe, and every one of those launches' inputs (learned bits, whose
   distances are multiples of 4 and tie often) run again through the
   kernel and its plain version, which must agree exactly; each kernel
   timed at the full-width run's shape (its last call) beside its bound
   and its plain version. Then ``SlamSystem.reprojection_report`` and
   ``render_overlay`` after a short run (finite RMSE), ``calibrate`` on
   tests/test_calibrate.py's problem with its bars, and the E/H hybrid on
   tests/test_relative_pose_planar.py's plane (the homography selected,
   the pose within the test's bars).
12. The EuRoC configuration: phase 4's world and configuration through
   the double-sphere camera (``cam_type="ds"``; at 752x480 its fx = 220
   puts the image corners 88.6 degrees off the axis, inside the model's
   valid region), ``StreamingVO`` (eager: a graph replay would hide its
   kernel calls from the check below) for 8 warm-up and 120 timed frames:
   keyframe ATE at most max(2 x phase 4's, 0.05 m), at least 90% of the
   frames after the bootstrap tracked (phase 4's share printed beside),
   ms per frame (median, max), frames per second, peak memory, the landmark
   top-2 once per frame and the descriptor top-2 twice per keyframe. Then
   ``python -m vslam_tpu_torch.tools.ate_table --dataset-root`` on that
   world written as a mav0 tree (PGM images, the ds calibration, a
   vocabulary the port trained on its own features, the configuration as
   JSON): the faithful driver's full-SLAM and VO arms; every table cell
   must be finite, and each arm's frames per second and ms per frame are
   printed. Every landmark / descriptor top-2 call of both runs is kept
   and checked exact against its plain version; each kernel is timed at
   the ds run's shape (``euroc_ds_shape`` in the kernels line). Last,
   kb4 and eucm on tests/test_e2e_ds_model.py's world through
   ``SlamSystem`` and ``StreamingVO`` with that test's bars (at least 3
   keyframes, keyframe ATE under 0.12 m).
13. The measurement tools (``vslam_tpu_torch.tools``) in-process:
   ``profile_stages --frames 20 --reps 5`` (the faithful driver's stages,
   wall and device ms and device operations per call), ``profile_kf_branch``
   at its defaults, ``bench_gba_scale --pairs 512,1024`` (phase 9 solves
   the 4096-pair problem), ``bench_vocab`` at depth 5 (111,111 nodes; the
   tool's default of 6 cut to fit the script's time) and
   ``ablation_reloc --variants full`` on phase 7's world (loop closure,
   global BA and relocalization at ``poll_every=16``, ``chunk=8``), in
   deterministic mode. Each record is printed. Checks: every time finite and positive and no stage's
   device ms above its wall ms, the keyframe branch's cost positive, each
   global BA's final cost under half its initial (the JAX slow test's
   bar), the card's descent words equal to the CPU's for the same 1500
   descriptors, every ablation ATE finite, both kernels launched by the
   profiled run and by the ablation, and every K1 / K2 call of those runs
   (kept while they ran, so the profiled run's figures include the
   copies; their streaming drivers step eagerly so that every call is
   seen) exact against its plain version.
14. The benchmark program (``vslam_tpu_torch.bench``, the port of
   ``bench.py``) in process, its lines kept: ``bench_single`` through the
   streaming driver at the bench's 8 warm-up + 120 timed frames (one run)
   with ``window_ba_ms`` and ``bench_multiseq`` at its 8 worlds of 116
   frames (one run), on the emitter that holds phase 7's
   ``bench_full_slam`` (run there in deterministic mode for that phase's
   gate; the program itself never is), then ``bench_complete``; and, on a
   second emitter, ``bench_single`` through the faithful driver
   (``--driver slam``). Checks: every line parses and holds at most 2048 bytes, the
   last carries ``bench_complete``; ``euroc_vo_fps`` finite and positive
   with every timed frame tracked and a keyframe, ``window_ba_ms`` finite
   and positive; every full-SLAM figure finite, its fps positive and both
   keyframe ATEs within the orbit's diameter (loops and GBA merges
   printed, not gated); the sequence-frames per second finite and
   positive. Launches over each sub-bench's call, warm-up included: the
   streaming VO's landmark top-2 once per frame (every timed frame is
   tracked) and descriptor top-2 twice per keyframe, the multi-sequence
   run's once per lockstep frame and twice per inserted keyframe, the
   faithful run's at least as often. The streaming drivers replay their
   step as CUDA graphs (``window_ba_ms`` times the eager solve).

15. The driver entry points (``vslam_tpu_torch.entry``, the port of
   ``__graft_entry__.py``): ``entry()``'s tracking step on the card, once
   with its bound draws and once with draws taken from the CPU port's
   matches, beside the CPU port's step on the same inputs (matches,
   candidates, counts and descriptors equal, pose within 1e-4);
   ``dryrun_multichip(8)`` twice (cold, then warm) on a mesh that lists
   the card 8 times (batched tracking, the sharded global BA, the split
   SuperPoint training step: poses finite, cost not rising, loss finite);
   then tests/test_multichip_scale.py's EuRoC-scale batched step
   (``entry.FULL_WIDTH_STEP``: 8 sequences at 752x480, 1500 features)
   once untimed and 5 times timed.
   Prints ms per call and peak memory of each. Checks: the landmark
   top-2 once per tracking call (the sequence axis on its grid), the
   descriptor top-2 never, and every landmark top-2 call of the phase
   exact against its plain version; the kernel is timed at the
   EuRoC-scale step's shape (``entry_full_width_shape``).

Every stored kernel time carries where it came from (``ms_source``,
``plain_ms_source``): ``"profiler"`` (device events of a
``torch.profiler`` window) or ``"cuda_events_upper_bound"`` (the profiler
saw no event, so CUDA events around back-to-back calls: an upper bound).

``python3 chip_smoke.py --faithful-seeds 0 1 2 3 4 5`` runs, instead of
the phases, the faithful driver and its control on phase 7's world over
those RANSAC seeds (``sweep_faithful_seeds``): the measurement behind
phase 8's bar. ``--learned-seeds 0 1 2 ...`` runs phase 11's two
learned-VO runs over initialization seeds (``sweep_learned_seeds``): the
measurement behind its pinned seed. ``--full-slam`` runs phase 7 alone
(cold: nothing warmed up before it) and prints its lines.

Phases 6 to 8 (and phase 11's training and learned VO, phase 13's
ablation) run with PyTorch's deterministic algorithms (see
``deterministic``): each SLAM arm and its VO control compute the same
frames until the first poll that acts, and a run repeats bit for bit on
one software stack.

The last lines are one JSON object describing the kernels, the card's
``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

# cuBLAS picks reproducible reductions only with a fixed workspace; set
# before the first CUDA call (phases 6-7 run in deterministic mode)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from vslam_tpu_torch.utils.profiling import device_ms  # noqa: E402

# Keyframe ATE of the JAX package's StreamingVO on the benchmark world
# (synthetic.generate(num_frames=128, num_points=1200, width=752,
# height=480, seed=2, speed=3.0)) at the streaming tests' configuration,
# run on the CPU. The port must stay within max(2x this, 0.05 m).
JAX_CPU_KF_ATE_M = 0.027797708416439467

WARMUP_FRAMES = 8

# NVIDIA H100 SXM peaks (data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12     # float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12  # int8 tensor cores: the fastest integer rate
#                           listed, taken for the 1-bit products


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def small_config(SlamConfig):
    return SlamConfig(
        num_features=400, ransac_hypotheses=128, max_landmarks=8192,
        max_keyframes=64, max_inview_landmarks=512, window_cams=24,
        window_points=2048, window_obs=6144, ba_max_iters=10,
        enable_relocalization=False, enable_loop_closure=False,
        new_kf_min_inliers=60)


def call_ms(fn, iters=50, warmup=5):
    """Median milliseconds per call of ``fn`` between CUDA events recorded
    around it: the device time plus whatever the host adds while the card
    waits for the launches (what the main path pays per call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ms_source(seen):
    """Where a ``device_ms`` time came from: the profiler's device events,
    or (none seen) CUDA events around back-to-back calls, an upper bound."""
    return "profiler" if seen else "cuda_events_upper_bound"


def timings(kernel, plain, args, name):
    """Kernel and plain version timed at the same inputs, the kernel as
    the main path calls it: its ``{name}_kernel`` device time is the
    kernel alone. ``ms_source`` and ``plain_ms_source`` say where each
    time came from (``ms_source``)."""
    ms, kernel_only_ms, ops, seen = device_ms(lambda: kernel(*args),
                                              f"{name}_kernel")
    plain_ms, _, _, plain_seen = device_ms(lambda: plain(*args), "")
    return dict(
        ms=ms, ms_source=ms_source(seen), kernel_only_ms=kernel_only_ms,
        device_ops_per_call=ops, device_events_seen=seen,
        plain_ms=plain_ms, plain_ms_source=ms_source(plain_seen),
        call_ms=call_ms(lambda: kernel(*args)),
        plain_call_ms=call_ms(lambda: plain(*args)))


def at_shape(t, shape, b_ms, b_by, **extra):
    """A kernel's record at one more shape, from ``timings``' ``t``."""
    return dict(shape=shape, ms=t["ms"], ms_source=t["ms_source"],
                plain_ms=t["plain_ms"], plain_ms_source=t["plain_ms_source"],
                call_ms=t["call_ms"], plain_call_ms=t["plain_call_ms"],
                bound_ms=b_ms, bound_by=b_by, **extra)


def bound(nbytes, ops_s):
    """(bound_ms, bound_by): the bytes over the memory rate against the
    operations' seconds at their peak rates, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, ops_s) * 1e3,
            "bytes" if t_bytes >= ops_s else "operations")


def hamming_bound(a, b, va, vb):
    """The descriptor top-2 must read the valid rows of A and B (256
    {0,1} bytes each) and both validity vectors, and write three int32
    per row of A; it takes a 256-bit distance (256 ANDs and 256
    popcount-adds) for each valid pair."""
    na, nb = int(va.sum()), int(vb.sum())
    nbytes = 256 * (na + nb) + va.numel() + vb.numel() + 12 * va.numel()
    return bound(nbytes, na * nb * 512 / INT8_OPS_PER_S)


def landmark_bound(kp, kv, kxy, bank, bv, lxy, lv, max_dist_2d):
    """The landmark top-2 must read every validity and xy, the descriptor
    bytes of the keypoints that gate some landmark and of the valid bank
    slots of the landmarks that some keypoint gates, and write three
    int32 and a bool per keypoint; it tests the gate (2 subtractions, 2
    products, a sum and a compare in float32) for each valid keypoint and
    valid landmark, and takes a 256-bit distance (512 operations) for each
    gated pair and valid slot. With a leading sequence axis the bytes and
    operations are the sequences' sums. Returns (bound_ms, bound_by, the
    mean and the largest number of gated landmarks per valid keypoint)."""
    from vslam_tpu_torch.ops import hamming

    if kp.dim() == 2:
        kp, kv, kxy, bank, bv, lxy, lv = (
            x[None] for x in (kp, kv, kxy, bank, bv, lxy, lv))
    nbytes, ops_s, per_kp = 0, 0.0, []
    for s in range(kp.shape[0]):
        diff = kxy[s, :, None, :] - lxy[s, None, :, :]
        gate = ((torch.sum(diff * diff, dim=-1)
                 < hamming.gate_radius_sq(max_dist_2d))
                & lv[s, None, :] & kv[s, :, None])  # the plain version's gate
        n, p = gate.shape
        rows = int(gate.any(dim=1).sum())
        slots = int((bv[s] & gate.any(dim=0)[:, None]).sum())
        pair_slots = int((gate.float() @ bv[s].float()).sum())
        nbytes += (256 * (rows + slots) + n * (1 + 8) + p * (1 + 8)
                   + bv[s].numel() + 13 * n)
        ops_s += (6 * int(kv[s].sum()) * int(lv[s].sum()) / F32_OPS_PER_S
                  + 512 * pair_slots / INT8_OPS_PER_S)
        per_kp.append(gate.sum(dim=1)[kv[s]].float())
    per_kp = torch.cat(per_kp)
    return (*bound(nbytes, ops_s), float(per_kp.mean()), int(per_kp.max()))


def max_abs_err(got, want):
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               if g.numel() else 0 for g, w in zip(got, want))


def hamming_inputs(rng, n, m, dev, valid_frac=0.9, near=False,
                   valid_b_frac=None):
    a = rng.randint(0, 2, (n, 256)).astype(np.uint8)
    b = rng.randint(0, 2, (m, 256)).astype(np.uint8)
    if near and m:
        # rows of B that are noisy copies of rows of A: distances well
        # under the match threshold, with ties
        src = rng.randint(0, max(n, 1), m)
        flip = rng.rand(m, 256) < rng.choice([0.02, 0.05, 0.1], (m, 1))
        b = np.where(flip, 1 - a[src], a[src]).astype(np.uint8)
    vb = valid_frac if valid_b_frac is None else valid_b_frac
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return t(a), t(b), t(rng.rand(n) < valid_frac), t(rng.rand(m) < vb)


def landmark_inputs(rng, n, p, nb, dev, lm_frac=0.9, bank_frac=0.7):
    kp = rng.randint(0, 2, (n, 256)).astype(np.uint8)
    src = rng.randint(0, max(n, 1), (p, max(nb, 1)))
    flip = rng.rand(p, nb, 256) < 0.08
    near = kp[src[:, :nb]] if n else rng.randint(0, 2, (p, nb, 256))
    bank = np.where(flip, 1 - near, near).astype(np.uint8)
    kxy = (rng.rand(n, 2) * [752, 480]).astype(np.float32)
    # projected landmarks near their source keypoint, some outside the gate
    lxy = (kxy[src[:, 0]] if n else rng.rand(p, 2) * [752, 480]) + \
        rng.normal(0, 15, (p, 2))
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return (t(kp), t(rng.rand(n) < 0.95), t(kxy), t(bank),
            t(rng.rand(p, nb) < bank_frac), t(lxy.astype(np.float32)),
            t(rng.rand(p) < lm_frac), 20.0)


def stacked(parts):
    """Per-sequence landmark inputs as one stack with a leading sequence
    axis (the radius is shared)."""
    return tuple(torch.stack(x) for x in list(zip(*parts))[:7]) + (
        parts[0][7],)


def refuses(fn, what):
    try:
        fn()
    except ValueError:
        return
    check(False, f"{what} accepted a misaligned input")


def misaligned(t):
    """A contiguous copy of ``t`` one element past an allocation's
    (aligned) start."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype,
                      device=t.device)[1:].view(t.shape)
    out.copy_(t)
    return out


def phase_kernels(dev):
    from vslam_tpu_torch import synthetic
    from vslam_tpu_torch.ops import cuda_hamming, hamming

    rng = np.random.RandomState(0)
    report = {}

    # ---- K2: descriptor top-2 ----
    # main path; ragged; M=0; all-invalid A; all-invalid B; the kernel's
    # edges: N=1, N not a multiple of 16 rows, M under one 16-candidate
    # chunk, M not a multiple of a chunk or of a block's 256-candidate step
    cases = [(1500, 1500, 0.9, True, None), (1500, 1500, 0.9, False, None),
             (130, 600, 0.9, False, None), (1, 129, 0.5, True, None),
             (257, 0, 0.9, False, None), (64, 64, 0.0, False, None),
             (64, 64, 0.9, True, 0.0), (1, 1, 1.0, True, None),
             (17, 15, 0.9, True, None), (16, 32, 1.0, True, None),
             (33, 257, 0.9, True, None), (100, 2049, 0.9, True, None)]
    inputs = [(f"N={n} M={m}", hamming_inputs(rng, n, m, dev, vf, near, vbf))
              for n, m, vf, near, vbf in cases]
    inputs += [(case, tuple(torch.as_tensor(x, device=dev)
                            for x in synthetic.descriptor_ties(case)))
               for case in synthetic.DESCRIPTOR_TIE_CASES]
    a, b, va, vb = inputs[0][1]
    inputs.append(("strided B", (a, b.t().contiguous().t(), va, vb)))
    err = 0
    for label, args in inputs:
        want = hamming.hamming_top2_plain(*args)
        e = max_abs_err(cuda_hamming.hamming_top2(*args), want)
        check(e == 0, f"hamming_top2 differs from its plain version at "
                      f"{label} (max abs err {e})")
        err = max(err, e)
        if not bool(args[3].any()):  # no candidate: the 256 init, arg 0
            check(int(want[0].min()) == 256 and int(want[2].max()) == 0,
                  f"hamming_top2 without candidates at {label}")
    refuses(lambda: cuda_hamming.hamming_top2(misaligned(a), b, va, vb),
            "hamming_top2")
    main = hamming_inputs(rng, 1500, 1500, dev, 0.95, True)
    bound_ms, bound_by = hamming_bound(*main)
    report["hamming_top2"] = dict(
        max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, **timings(cuda_hamming.hamming_top2,
                                   hamming.hamming_top2_plain, main,
                                   "hamming_top2"))

    # ---- K1: landmark top-2 ----
    # main path (twice); ragged; P=0; all-invalid landmarks, all-invalid
    # banks; the kernel's edges: N=1, P of 1, under and over one
    # 32-landmark gate step, P past one and two 2048-landmark staged
    # chunks; bank widths 1, 3 and 8 (two passes of four slots), and 0
    cases = [(1500, 2048, 4, 0.9, 0.7), (1500, 2048, 4, 1.0, 1.0),
             (100, 300, 4, 0.9, 0.8), (129, 513, 3, 0.5, 0.5),
             (7, 0, 4, 0.9, 0.7), (64, 256, 4, 0.0, 0.7),
             (64, 256, 4, 0.9, 0.0), (1, 300, 4, 0.9, 0.7),
             (50, 1, 4, 1.0, 1.0), (50, 31, 4, 0.9, 0.7),
             (50, 33, 4, 0.9, 0.7), (300, 2049, 4, 0.9, 0.7),
             (200, 4100, 4, 0.9, 0.7), (80, 300, 1, 0.9, 0.7),
             (80, 300, 8, 0.9, 0.7), (80, 300, 0, 0.9, 0.7)]
    inputs = [(f"N={n} P={p} B={nb}",
               landmark_inputs(rng, n, p, nb, dev, lf, bf))
              for n, p, nb, lf, bf in cases]
    # every landmark inside every keypoint's gate, and none inside any
    every = list(landmark_inputs(rng, 64, 700, 4, dev))
    every[2] = torch.as_tensor(100 + rng.rand(64, 2) * 5, dtype=torch.float32,
                               device=dev)
    every[5] = torch.as_tensor(100 + rng.rand(700, 2) * 5,
                               dtype=torch.float32, device=dev)
    none = list(landmark_inputs(rng, 64, 700, 4, dev))
    none[5] = none[5] + 1000.0
    inputs += [("every landmark gated", tuple(every)),
               ("no landmark gated", tuple(none))]
    for case in synthetic.LANDMARK_TIE_CASES:
        data = synthetic.landmark_ties(case)
        inputs.append((case, tuple(torch.as_tensor(x, device=dev)
                                   for x in data[:7]) + (data[7],)))
    kp, kv, kxy, bank, bv, lxy, lv, r = inputs[2][1]
    inputs.append(("strided", (
        kp.t().contiguous().t(), kv, torch.stack([kxy, kxy], 1)[:, 0],
        torch.stack([bank, bank], 2)[:, :, 0], bv,
        torch.stack([lxy, lxy], 1)[:, 0], lv, r)))
    err = 0
    for label, args in inputs:
        want = hamming.landmark_top2_plain(*args)
        e = max_abs_err(cuda_hamming.landmark_top2(*args), want)
        check(e == 0, f"landmark_top2 differs from its plain version at "
                      f"{label} (max abs err {e})")
        err = max(err, e)
    refuses(lambda: cuda_hamming.landmark_top2(
        misaligned(kp), kv, kxy, bank, bv, lxy, lv, r), "landmark_top2")
    refuses(lambda: cuda_hamming.landmark_top2(
        kp, kv, kxy, bank, bv, misaligned(lxy), lv, r), "landmark_top2")
    main = landmark_inputs(rng, 1500, 2048, 4, dev)
    bound_ms, bound_by, per_kp, most = landmark_bound(*main)
    report["landmark_top2"] = dict(
        max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, gated_per_keypoint=per_kp, gated_most=most,
        **timings(cuda_hamming.landmark_top2, hamming.landmark_top2_plain,
                  main, "landmark_top2"))
    # ---- K1 over a sequence axis (the multi-sequence path) ----
    # S = 1, 2 and 8 stacked problems at the main path's shape: exact
    # against the plain version, and bit-equal to S launches of the same
    # kernel, one per sequence; one count per call whatever S is
    def check_stack(label, args):
        before = cuda_hamming.LAUNCHES["landmark_top2"]
        got = cuda_hamming.landmark_top2(*args)
        check(cuda_hamming.LAUNCHES["landmark_top2"] == before + 1,
              f"landmark_top2 over {label} counted more than one launch")
        e = max_abs_err(got, hamming.landmark_top2_plain(*args))
        check(e == 0, f"landmark_top2 differs from its plain version over "
                      f"{label} (max abs err {e})")
        for q in range(args[0].shape[0]):
            one = cuda_hamming.landmark_top2(*(a[q] for a in args[:7]),
                                             args[7])
            check(all(torch.equal(g[q], o) for g, o in zip(got, one)),
                  f"landmark_top2 over {label}: sequence {q} differs from "
                  f"its own launch")
        return got

    for num_seq in (1, 2, 8):
        check_stack(f"S={num_seq} N=1500 P=2048 B=4", stacked(
            [landmark_inputs(rng, 1500, 2048, 4, dev)
             for _ in range(num_seq)]))
    # a sequence without a valid keypoint, one with every landmark inside
    # every gate, one with none inside any
    odd = [list(landmark_inputs(rng, 64, 700, 4, dev)) for _ in range(3)]
    odd[0][1] = torch.zeros_like(odd[0][1])
    odd[1][2], odd[1][5] = every[2], every[5]
    odd[2][5] = odd[2][5] + 1000.0
    got = check_stack("S=3 (no keypoint / every landmark gated / none)",
                      stacked(odd))
    check(not bool(got[3][0].any())
          and torch.equal(got[3][1], odd[1][1])  # every valid keypoint
          and not bool(got[3][2].any()),
          "landmark_top2 over the odd stack: any_candidate")
    *ties, r_ties = synthetic.landmark_ties_stacked()
    check_stack("the tie cases, one per sequence",
                tuple(torch.as_tensor(x, device=dev) for x in ties)
                + (r_ties,))
    multi = stacked([landmark_inputs(rng, 1500, 2048, 4, dev)
                     for _ in range(8)])
    refuses(lambda: cuda_hamming.landmark_top2(multi[0][0], *multi[1:]),
            "landmark_top2 (mixed ranks)")
    refuses(lambda: cuda_hamming.landmark_top2(misaligned(multi[0]),
                                               *multi[1:]),
            "landmark_top2 (stacked)")
    t = timings(cuda_hamming.landmark_top2, hamming.landmark_top2_plain,
                multi, "landmark_top2")
    b_ms, b_by, per_kp, most = landmark_bound(*multi)
    check(t["device_ops_per_call"] == 1 and t["kernel_only_ms"] == t["ms"],
          f"landmark_top2 over S=8 ran {t['device_ops_per_call']} device "
          f"operations per call, not its one kernel")
    report["landmark_top2"]["multiseq_shape"] = at_shape(
        t, "S=8 N=1500 P=2048 B=4", b_ms, b_by, device_ops_per_call=1,
        gated_per_keypoint=per_kp)
    print(f"kernel landmark_top2 at S=8 N=1500 P=2048 B=4: exact, bit-equal "
          f"to 8 launches; device ({t['ms_source']}) {t['ms']:.4f} ms in one "
          f"operation (plain "
          f"{t['plain_ms']:.4f}); per call with host {t['call_ms']:.4f} ms "
          f"(plain {t['plain_call_ms']:.4f}); bound {b_ms * 1e3:.3f} us by "
          f"{b_by}; {per_kp:.2f} gated landmarks per valid keypoint",
          flush=True)
    del multi

    # each kernel once more at the full-SLAM slice's shapes: K2 at N=M=300
    # as match_vs_keyframes makes it, K1 at N=300, P=1024, B=4 as the
    # closure's guided matching makes it
    k2 = hamming_inputs(rng, 300, 300, dev, 0.95, True)
    k1 = landmark_inputs(rng, 300, 1024, 4, dev)
    for name, args, kernel, plain, bound_of, shape in (
            ("hamming_top2", k2, cuda_hamming.hamming_top2,
             hamming.hamming_top2_plain, hamming_bound, "N=M=300"),
            ("landmark_top2", k1, cuda_hamming.landmark_top2,
             hamming.landmark_top2_plain,
             lambda *a: landmark_bound(*a)[:2], "N=300 P=1024 B=4")):
        e = max_abs_err(kernel(*args), plain(*args))
        check(e == 0, f"{name} differs from its plain version at {shape}")
        t = timings(kernel, plain, args, name)
        b_ms, b_by = bound_of(*args)
        report[name]["slam_shape"] = at_shape(t, shape, b_ms, b_by)
        print(f"kernel {name} at {shape}: exact; device ({t['ms_source']}) "
              f"{t['ms']:.4f} ms "
              f"(plain {t['plain_ms']:.4f}); per call with host "
              f"{t['call_ms']:.4f} ms (plain {t['plain_call_ms']:.4f}); "
              f"bound {b_ms * 1e3:.3f} us by {b_by}", flush=True)
    torch.cuda.synchronize()
    for name, r in report.items():
        check(r["device_ops_per_call"] == 1
              and r["kernel_only_ms"] == r["ms"],
              f"{name} ran {r['device_ops_per_call']} device operations per "
              f"call, not its one kernel")
        print(f"kernel {name}: exact vs plain in every case; device "
              f"({r['ms_source']}) {r['ms']:.4f} ms per call as the main "
              f"path calls it "
              f"({r['device_ops_per_call']} device operation, "
              f"{r['device_events_seen']} events seen in 20 calls), "
              f"{r['kernel_only_ms']:.4f} ms kernel alone (plain "
              f"{r['plain_ms']:.4f} ms); per call with host "
              f"{r['call_ms']:.4f} ms (plain {r['plain_call_ms']:.4f} ms); "
              f"bound {r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}",
              flush=True)
    r = report["landmark_top2"]
    print(f"landmark_top2 at the main-path inputs: "
          f"{r['gated_per_keypoint']:.2f} gated landmarks per valid "
          f"keypoint, {r['gated_most']} at most", flush=True)
    return report


def vo_run(seq, frames, dev, cuda_graphs):
    """``StreamingVO`` at the benchmark's configuration over ``frames``:
    WARMUP_FRAMES untimed, then each frame timed to a synchronize, the
    launch counters reset in between. Returns (driver, logs, summary)."""
    from vslam_tpu_torch import bench
    from vslam_tpu_torch.eval import ate
    from vslam_tpu_torch.pipeline.streaming import StreamingVO

    vo = StreamingVO(seq.calib, bench.vo_config(), max_frames=len(frames),
                     device=dev, cuda_graphs=cuda_graphs)
    vo.run(frames[:WARMUP_FRAMES])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms = []
    for img_l, img_r in frames[WARMUP_FRAMES:]:
        t = time.perf_counter()
        vo.process_frame(img_l, img_r)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    res = vo.results()
    n_timed = len(frames) - WARMUP_FRAMES
    kfs_timed = int(res["is_keyframe"][WARMUP_FRAMES:].sum())
    fids, pos, _ = vo.keyframe_trajectory()
    kf_ms = [t for t, k in zip(ms, res["is_keyframe"][WARMUP_FRAMES:]) if k]
    tr_ms = [t for t, k in zip(ms, res["is_keyframe"][WARMUP_FRAMES:])
             if not k]
    summary = dict(
        cuda_graphs=vo.cuda_graphs,
        frames=int(res["frames"]), timed_frames=n_timed,
        keyframes=int(res["is_keyframe"].sum()),
        keyframes_timed=kfs_timed,
        tracked_timed=int(res["tracked_ok"][WARMUP_FRAMES:].sum()),
        tracked_after_bootstrap=int(res["tracked_ok"][1:].sum()),
        kf_ate_m=float(ate.align_svd(pos, seq.poses[fids, :3])[2]),
        full_ate_m=float(ate.align_svd(res["trajectory"][:, :3],
                                       seq.poses[:len(frames), :3])[2]),
        median_ms_per_frame=statistics.median(ms),
        fps=1e3 * n_timed / sum(ms),
        median_ms_tracking_frame=statistics.median(tr_ms) if tr_ms else None,
        median_ms_keyframe=statistics.median(kf_ms) if kf_ms else None,
        max_ms_per_frame=max(ms),
        max_memory_allocated_bytes=int(peak),
        capture=vo.capture_stats,
        launches=launches,
        window_obs_dropped_max=int(res["window_obs_dropped"].max()))
    return vo, res, summary


def check_vo_run(name, res, summary):
    traj = res["trajectory"]
    check(np.isfinite(traj).all(), f"{name}: trajectory is not finite")
    check(bool(res["tracked_ok"][1:].all()),
          f"{name}: tracking lost after bootstrap: "
          f"{np.flatnonzero(~res['tracked_ok'][1:]) + 1}")
    n_timed, kfs = summary["timed_frames"], summary["keyframes_timed"]
    launches = summary["launches"]
    check(launches["landmark_top2"] == n_timed,
          f"{name}: landmark_top2 launched {launches['landmark_top2']} "
          f"times in {n_timed} frames")
    check(launches["hamming_top2"] == 2 * kfs,
          f"{name}: hamming_top2 launched {launches['hamming_top2']} times "
          f"for {kfs} keyframes")
    check(kfs > 0, f"{name}: no keyframe in the timed frames")
    bound = max(2.0 * JAX_CPU_KF_ATE_M, 0.05)
    check(summary["kf_ate_m"] <= bound,
          f"{name}: keyframe ATE {summary['kf_ate_m']:.4f} m > {bound:.4f} m")


def graph_window(seq, frames, dev, n_window=8):
    """A ``torch.profiler`` window over ``n_window`` graphed frames (after
    16 untimed), with no synchronize inside but the last: K1's kernel
    events, the Python calls of its wrapper (none: the kernel runs inside
    the graph replays), the host's CUDA runtime calls per frame and the
    device's busy share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from vslam_tpu_torch import bench
    from vslam_tpu_torch.ops import cuda_hamming
    from vslam_tpu_torch.pipeline.streaming import StreamingVO

    vo = StreamingVO(seq.calib, bench.vo_config(), max_frames=len(frames),
                     device=dev)
    vo.run(frames[:16])
    torch.cuda.synchronize()
    wrapper = cuda_hamming.landmark_top2
    calls = []
    cuda_hamming.landmark_top2 = lambda *a: (calls.append(1), wrapper(*a))[1]
    try:
        for attempt in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                vo.run(frames[16 + attempt * n_window:
                              16 + (attempt + 1) * n_window])
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            cuda = [e for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            if cuda:
                break
            print("graphed window: the profiler saw no device event; again",
                  flush=True)
    finally:
        cuda_hamming.landmark_top2 = wrapper
    host = collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CPU
        and e.name.startswith("cuda"))
    launch_calls = sum(n for k, n in host.items() if k.startswith((
        "cudaLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset")))
    # the driver's blocking reads: event and stream waits and synchronous
    # copies (the cudaDeviceSynchronize calls are the window's closing
    # synchronize and the profiler's own)
    blocking = sum(n for k, n in host.items() if k in (
        "cudaEventSynchronize", "cudaStreamSynchronize", "cudaMemcpy"))
    busy_ms = sum(e.device_time_total for e in cuda) / 1e3
    res = vo.results()
    window = slice(16 + attempt * n_window, 16 + (attempt + 1) * n_window)
    out = dict(
        frames=n_window, keyframes=int(res["is_keyframe"][window].sum()),
        k1_kernel_events=sum(1 for e in cuda
                             if "landmark_top2_kernel" in e.name),
        k1_wrapper_calls=len(calls),
        device_events=len(cuda),
        host_launch_calls_per_frame=launch_calls / n_window,
        blocking_host_reads_per_frame=blocking / n_window,
        host_runtime_calls={k: n for k, n in sorted(host.items())},
        wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_busy_ms_per_frame=busy_ms / n_window,
        # the profiler slows the host, so this share is an upper bound
        device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms))
    return out


def phase_main_path(dev):
    """The bench VO world three times, eager, graphed and eager again (the
    eager pair shows what two runs of one step part by: the window BA's
    atomic sums), a deterministic eager / graphed pair over its first 48
    frames, a profiled window of graphed frames and the cull's device
    time (see the module docstring, phase 4). Returns the graphed run's
    launches and summary."""
    from vslam_tpu_torch import synthetic
    from vslam_tpu_torch.pipeline import keyframe as kf_mod
    from vslam_tpu_torch.utils.profiling import device_ms as dms

    t0 = time.perf_counter()
    seq = synthetic.generate(num_frames=128, num_points=1200, width=752,
                             height=480, seed=2, speed=3.0)
    print(f"world: {len(seq.images)} frames 752x480 generated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    frames = [(torch.as_tensor(l).to(dev), torch.as_tensor(r).to(dev))
              for l, r in seq.images]
    runs = {}
    for name, graphs in (("eager", False), ("graphed", True),
                         ("eager_again", False)):
        vo, res, summary = vo_run(seq, frames, dev, graphs)
        runs[name] = (res, summary)
        print(f"main path, {name}: " + json.dumps(summary), flush=True)
        check_vo_run(f"main path, {name}", res, summary)
        if graphs:
            # the cull's device time on a keyframe below the pressure:
            # the graphed step computes it and keeps nothing, where an
            # eager step could skip it on a host read of the pressure test
            st, cfg = vo.state, vo.cfg
            cull_ms = dms(lambda: kf_mod.cull_under_pressure(
                st.kf, st.lm, cfg.lm_cull_pressure, cfg.lm_cull_min_obs))[0]
            below = int(st.lm.valid.sum()) < int(
                cfg.lm_cull_pressure * st.lm.valid.shape[0])
        del vo

    def apart(a, b):
        return dict(
            same_keyframes=bool((a["is_keyframe"] == b["is_keyframe"]).all()),
            same_tracked=bool((a["tracked_ok"] == b["tracked_ok"]).all()),
            max_traj_diff_m=float(np.abs(a["trajectory"]
                                         - b["trajectory"]).max()))

    (e, es), (g, gs), (e2, e2s) = (runs[k] for k in (
        "eager", "graphed", "eager_again"))
    vs_eager, eager_pair = apart(e, g), apart(e, e2)
    exact_held = (vs_eager["same_keyframes"] and vs_eager["same_tracked"]
                  and vs_eager["max_traj_diff_m"] <= 1e-4)
    eager_parts = eager_pair["max_traj_diff_m"] > 1e-4
    # deterministic: the same arithmetic in both, atomics in order
    with deterministic():
        short = frames[:48]
        det = {graphs: vo_run(seq, short, dev, graphs)[1]
               for graphs in (False, True)}
    det_pair = apart(det[False], det[True])
    cmp = dict(graphed_vs_eager=vs_eager, eager_vs_eager=eager_pair,
               held="within 1e-4 m" if exact_held else
               "as the eager pair is held (keyframe count within 1, every "
               "frame tracked, ATE bound)",
               deterministic_48_frames=dict(
                   det_pair, bit_for_bit=det_pair["max_traj_diff_m"] == 0.0),
               fps=dict(eager=es["fps"], graphed=gs["fps"],
                        eager_again=e2s["fps"]),
               cull_device_ms=cull_ms, cull_below_pressure=below)
    print("main path, graphed against eager: " + json.dumps(cmp), flush=True)
    check(gs["launches"] == es["launches"] == e2s["launches"],
          f"main path: launches differ between the runs: {gs['launches']}, "
          f"{es['launches']}, {e2s['launches']}")
    check(det_pair["same_keyframes"] and det_pair["same_tracked"]
          and det_pair["max_traj_diff_m"] <= 1e-4,
          f"main path, deterministic: graphed against eager {det_pair}")
    if not exact_held:
        check(eager_parts, f"main path: graphed parts from eager "
                           f"({vs_eager}) where two eager runs do not "
                           f"({eager_pair})")
        check(abs(gs["keyframes"] - es["keyframes"]) <= 1,
              f"main path: {gs['keyframes']} keyframes graphed, "
              f"{es['keyframes']} eager")

    window = graph_window(seq, frames, dev)
    print("main path, graphed window: " + json.dumps(window), flush=True)
    check(window["k1_kernel_events"] >= 1 and window["k1_wrapper_calls"] == 0,
          f"graphed window: K1 events {window['k1_kernel_events']}, wrapper "
          f"calls {window['k1_wrapper_calls']}")
    check(window["blocking_host_reads_per_frame"] <= 1.0,
          f"graphed window: {window['blocking_host_reads_per_frame']} "
          f"blocking host reads per frame")
    return gs["launches"], gs


def phase_small_world(dev):
    """The port on the card and on the CPU on the JAX streaming tests'
    world: both within those tests' bounds."""
    from vslam_tpu_torch import synthetic
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.eval import ate
    from vslam_tpu_torch.pipeline.streaming import StreamingVO

    seq = synthetic.generate(num_frames=24, num_points=500, seed=3)
    out = {}
    for where in (dev, torch.device("cpu")):
        vo = StreamingVO(seq.calib, small_config(SlamConfig), max_frames=64,
                         device=where)
        vo.run(seq.images)
        res = vo.results()
        fids, pos, _ = vo.keyframe_trajectory()
        out[where.type] = dict(
            traj=res["trajectory"], kf=res["is_keyframe"],
            kf_ate=float(ate.align_svd(pos, seq.poses[fids, :3])[2]),
            full_ate=float(ate.align_svd(res["trajectory"][:, :3],
                                         seq.poses[:24, :3])[2]))
        check(bool(res["tracked_ok"][2:].all()),
              f"small world: tracking lost on {where.type}")
        check(out[where.type]["kf_ate"] < 0.08,
              f"small world: keyframe ATE on {where.type}")
        check(out[where.type]["full_ate"] < 0.10,
              f"small world: trajectory ATE on {where.type}")
    gpu, cpu = out["cuda"], out["cpu"]
    diff = float(np.abs(gpu["traj"] - cpu["traj"]).max())
    print(f"small world: kf ATE cuda {gpu['kf_ate']:.4f} m / cpu "
          f"{cpu['kf_ate']:.4f} m; trajectory ATE cuda {gpu['full_ate']:.4f}"
          f" / cpu {cpu['full_ate']:.4f}; same keyframes: "
          f"{bool((gpu['kf'] == cpu['kf']).all())}; max pose difference "
          f"{diff:.2e}", flush=True)


# ---------------------------------------------------------------------------
# the full-SLAM slice
# ---------------------------------------------------------------------------

# The injected-drift scenario of tests/test_streaming_slam.py: drift creeps
# into the live gauge over frames 110-150, 3 m and 0.1 rad in all; the old
# map (keyframes before frame 100, and the landmarks they anchor) stays.
CREEP_FROM, CREEP_TO, BOUNDARY_FRAME = 110, 150, 100
# The scenario's RANSAC seed (SlamConfig.seed of all three arms). The run
# is chaotic: over seeds 0-5 on an H100 (deterministic mode,
# ``tools/slam_seed_sweep.py --scenario injected``) the test's bars held
# for seed 0 only with the DLT's inverse iteration through
# ``torch.cholesky_solve`` (MAGMA on the card, which a CUDA graph cannot
# capture), and for seeds 1, 4 and 5 with its two triangular solves: the
# first of those.
INJECTED_SEED = 1
T_OFF = np.array([2.4, -0.6, 1.6, 0.0, 0.04997917, 0.0, 0.99875026],
                 np.float32)

# the pano world's orbit (synthetic_pano.generate_pano_loop's default)
PANO_ORBIT_RADIUS_M = 3.0
# Phase 8's RANSAC seed (SlamConfig.seed in the command line's config).
# ``--faithful-seeds 0 1 2 3 4 5`` on an H100: with the DLT's inverse
# iteration through ``torch.cholesky_solve`` every faithful arm ended
# within the orbit's diameter (SLAM 2.10-5.25 m, control 1.13-3.48 m);
# with its two triangular solves (the graph form's) seed 0's SLAM arm
# ended 8.24 m off and seed 3's control 6.27 m, the other arms 0.18-4.64
# m. Seed 1 is the first whose arms both hold.
CLI_SEED = 1

# The JAX package's full-SLAM figures on the bench world (BENCH_r05.json):
# taken on a TPU, reported beside the port's, never gated on.
JAX_TPU_FULL_SLAM = dict(loops_closed=1, gba_merges=1, reloc="1/1",
                         kf_ate_m=1.559, vo_control_kf_ate_m=3.547)


def pano_config(SlamConfig):
    """tests/test_streaming_slam.py's pano_config."""
    return SlamConfig(
        num_features=600, ransac_hypotheses=128, max_landmarks=32768,
        max_keyframes=128, max_inview_landmarks=512, window_cams=24,
        window_points=2048, window_obs=6144, ba_max_iters=10,
        enable_relocalization=False, enable_loop_closure=True,
        enable_gba_after_loop=False,
        new_kf_min_inliers=60, loop_closing_time_threshold=20,
        quality_level=0.001, match_max_dist_2d=30.0)


def keyframe_ate(driver, seq):
    from vslam_tpu_torch.eval import ate

    fids, pos, _ = driver.keyframe_trajectory()
    return float(ate.align_svd(pos, seq.poses[fids, :3])[2])


def inject_gauge_offset(driver, T_off):
    """Move the live gauge (keyframes from BOUNDARY_FRAME on, the landmarks
    they anchor, the tracker) by T_off; the old map stays."""
    from vslam_tpu_torch.geometry import lie

    st = driver.state
    T = torch.as_tensor(T_off, device=st.cur_pose.device)
    kf, lm = st.kf, st.lm
    live_kf = kf.valid & (kf.frame_id >= BOUNDARY_FRAME)
    K = live_kf.shape[0]
    pose_l = torch.where(live_kf[:, None],
                         lie.se3_mul(T.expand(K, 7), kf.pose_l), kf.pose_l)
    pose_r = torch.where(live_kf[:, None],
                         lie.se3_mul(T.expand(K, 7), kf.pose_r), kf.pose_r)
    anchor = torch.clamp(lm.from_kf, min=0).long()
    live_lm = lm.valid & (lm.from_kf >= 0) & live_kf[anchor]
    pos = torch.where(live_lm[:, None], lie.se3_apply(T, lm.pos), lm.pos)
    # in place: the driver's graphs read the state where they were captured
    driver.write_state(
        kf=kf.replace(pose_l=pose_l, pose_r=pose_r), lm=lm.replace(pos=pos),
        cur_pose=lie.se3_mul(T, st.cur_pose),
        last_pose=lie.se3_mul(T, st.last_pose))


def run_with_injection(driver, images, dev):
    """Drift creeps in over CREEP_FROM..CREEP_TO, each frame nudging the
    live gauge by T_OFF^(1/N)."""
    from vslam_tpu_torch.geometry import lie

    n = CREEP_TO - CREEP_FROM
    T_step = lie.se3_exp(lie.se3_log(torch.as_tensor(T_OFF)) / n).numpy()
    driver.run(images[:CREEP_FROM])
    for f in range(CREEP_FROM, CREEP_TO):
        driver.process_frame(*images[f])
        inject_gauge_offset(driver, T_step)
    driver.run(images[CREEP_TO:])
    if dev.type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms for the SLAM phases: the float
    scatter-adds of the BA normal equations (``index_add_``) are atomic on
    the card, so two runs of one world part ways in the last bits and then,
    the world being chaotic, in their trajectories. Deterministic, the SLAM
    arm and its VO control compute the same frames until the first poll
    that acts (closure, relocalization), so their ATE difference is the
    loop machinery's, and a run is repeatable on one software stack."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def reset_launches():
    from vslam_tpu_torch.ops import cuda_hamming

    for name in cuda_hamming.LAUNCHES:
        cuda_hamming.LAUNCHES[name] = 0


def read_launches():
    from vslam_tpu_torch.ops import cuda_hamming

    return dict(cuda_hamming.LAUNCHES)


def phase_injected_drift(dev):
    """tests/test_streaming_slam.py::test_streaming_slam_stitches_injected_
    drift on the card, with that test's bars but one: the share of the
    break's energy removed over the clean-VO floor is printed, not gated.
    On this world the injection does not always separate the gauges
    (tracking against the old landmarks pulls the live gauge back): over
    RANSAC seeds 0-5 the injected VO run came out above the clean one in
    4 of 6 runs of the port on an H100 (1 of 6 with the DLT's solve before
    its graph form) and 2 of 6 of the JAX package on a CPU, so the share
    is undefined in some runs (``tools/slam_seed_sweep.py``). The run's
    seed is INJECTED_SEED."""
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.pipeline.streaming import StreamingSLAM, StreamingVO
    from vslam_tpu_torch.synthetic_pano import generate_pano_loop
    from vslam_tpu_torch.tools import bench_worlds

    t0 = time.perf_counter()
    seq = generate_pano_loop(num_frames=256, revolutions=1.75, seed=2)
    images = [(torch.as_tensor(l).to(dev), torch.as_tensor(r).to(dev))
              for l, r in seq.images]
    voc = bench_worlds.train_vocabulary(bench_worlds.vocabulary_pool(
        seq.images, range(0, 256, 8), 600, dev))
    print(f"injected drift: world and vocabulary ({voc.num_words} words) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    vo_ate = {}
    for arm in ("clean", "injected"):
        cfg_vo = pano_config(SlamConfig)
        cfg_vo.seed = INJECTED_SEED
        cfg_vo.enable_loop_closure = False
        vo = StreamingVO(seq.calib, cfg_vo, max_frames=288, device=dev)
        if arm == "clean":
            vo.run(images)
        else:
            run_with_injection(vo, images, dev)
        vo_ate[arm] = keyframe_ate(vo, seq)
    floor, rmse_vo = vo_ate["clean"], vo_ate["injected"]
    t_vo = time.perf_counter() - t0

    cfg = pano_config(SlamConfig)
    cfg.seed = INJECTED_SEED
    cfg.enable_gba_after_loop = True
    slam = StreamingSLAM(seq.calib, cfg, voc, max_frames=288, poll_every=16,
                         device=dev)
    reset_launches()
    t0 = time.perf_counter()
    run_with_injection(slam, images, dev)
    t_slam = time.perf_counter() - t0
    launches = read_launches()

    rmse_slam = keyframe_ate(slam, seq)
    res = slam.results()
    n_kf = int(res["is_keyframe"].sum())
    break_vo = max(rmse_vo ** 2 - floor ** 2, 0.0)
    break_slam = max(rmse_slam ** 2 - floor ** 2, 0.0)
    # undefined (None) where the injection did not separate the gauges
    removed = 1.0 - break_slam / break_vo if break_vo > 0 else None
    summary = dict(
        loops=slam.loop_edges,
        loop_frames=[(slam.frame_of_slot[c], slam.frame_of_slot[o])
                     for c, o in slam.loop_edges],
        gba_merges=slam.gba_merges, gba=slam.gba_stats,
        kf_ate_slam_m=rmse_slam, kf_ate_vo_injected_m=rmse_vo,
        kf_ate_clean_vo_m=floor, break_removed=removed,
        tracked=float(res["tracked_ok"][3:].mean()), keyframes=n_kf,
        launches=launches, loop_stats=dict(slam.loop_stats),
        loop_timings_s={k: round(v, 4) for k, v in slam.loop_timings.items()},
        closure_stats=slam.closure_stats,
        seconds_vo_arms=t_vo, seconds_slam=t_slam)
    print("injected drift: " + json.dumps(summary), flush=True)

    check(slam.loop_edges, "injected drift: no loop closed across the break")
    cur, cand = slam.loop_edges[0]
    gap = slam.frame_of_slot[cur] - slam.frame_of_slot[cand]
    check(gap > cfg.loop_closing_time_threshold,
          f"injected drift: loop frame gap {gap}")
    check(rmse_slam < rmse_vo, f"injected drift: SLAM ATE {rmse_slam:.2f} "
                               f">= VO {rmse_vo:.2f}")
    check(rmse_slam < 5.0, f"injected drift: SLAM ATE {rmse_slam:.2f} m")
    check(res["tracked_ok"][3:].mean() > 0.9, "injected drift: tracking")
    check(slam.gba_merges >= 1, "injected drift: no GBA merge")
    check(launches["landmark_top2"] > len(images),
          f"injected drift: landmark_top2 launched "
          f"{launches['landmark_top2']} times, none from the closure path")
    check(launches["hamming_top2"] > 2 * n_kf,
          f"injected drift: hamming_top2 launched {launches['hamming_top2']} "
          f"times for {n_kf} keyframes, none from the closure path")
    return launches, summary


def counting(cls):
    """``cls`` whose instances keep, in ``run_launches``, the kernels'
    launches of each call of ``run``: the benchmark program builds its
    drivers itself, and this reads each run's own counts without resetting
    the counters."""
    class Counting(cls):
        def run(self, frames):
            before = read_launches()
            n = super().run(frames)
            after = read_launches()
            self.run_launches = getattr(self, "run_launches", []) + [
                {k: after[k] - before[k] for k in after}]
            return n

    return Counting


def phase_full_slam(dev, em, n_frames=288):
    """bench.bench_full_slam on the card, in deterministic mode: the pano
    revisit world of ``bench_worlds.full_slam_world`` (752x480, 288
    frames, 1.75 revolutions, 300 features), one timed run of the
    full-SLAM arm and the VO control, 32 untimed frames and 256 timed
    each, without the sub-bench's warm-up run (phases 4-6 have warmed the
    kernels and solvers up). ``em`` is the benchmark emitter that phase 14
    goes on with. Returns (the SLAM arm's launches in its 256 timed frames,
    both arms' summaries, the world as ``full_slam_world`` gives it)."""
    from unittest import mock

    from vslam_tpu_torch import bench
    from vslam_tpu_torch.eval import recovery
    from vslam_tpu_torch.tools import bench_worlds

    t0 = time.perf_counter()
    world = bench_worlds.full_slam_world(n_frames, 300, dev)
    seq, voc, _ = world
    print(f"full SLAM: world and vocabulary ({voc.num_words} words) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    traj_len = float(np.linalg.norm(np.diff(seq.poses[:, :3], axis=0),
                                    axis=1).sum())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(bench, "StreamingSLAM",
                           counting(bench.StreamingSLAM)), \
            mock.patch.object(bench, "StreamingVO",
                              counting(bench.StreamingVO)):
        drivers = bench.bench_full_slam(em, world=world, max_runs=1,
                                        warmup_run=False, device=dev)
    torch.cuda.synchronize()
    print("full SLAM: the sub-bench's call (timed run, VO control): " +
          json.dumps(dict(
              seconds=time.perf_counter() - t0,
              peak_memory_bytes=int(torch.cuda.max_memory_allocated()))),
          flush=True)

    out = {}
    warm = 32   # bench_full_slam's untimed prefix of every run
    for (arm, fps), drv in zip((("slam", em.out["full_slam_fps"]),
                                ("vo", em.out["full_slam_vo_control_fps"])),
                               drivers):
        full = arm == "slam"
        res = drv.results()
        r = dict(
            frames=int(res["frames"]), fps=fps,
            kf_ate_m=keyframe_ate(drv, seq),
            keyframes=int(res["is_keyframe"].sum()),
            timed_keyframes=int(res["is_keyframe"][warm:].sum()),
            tracked=int(res["tracked_ok"].sum()),
            obs_drop_max=int(res["window_obs_dropped"].max()),
            # the second run call is the timed one
            launches=drv.run_launches[1],
            trajectory_finite=bool(np.isfinite(res["trajectory"]).all()))
        if full:
            # each relocalization attempt and each loss episode, on a line
            # before the arm's
            attempts = recovery.attempt_records(
                drv.reloc_diags, res["trajectory"], seq.poses)
            print("full SLAM, relocalization: " + json.dumps(dict(
                attempts=[{k: a[k] for k in (
                    "frame", "frames_lost", "gate", "candidates", "best_n",
                    "best_gate_err", "ok", "coasted_err_m",
                    "last_tracked_err_m")} for a in attempts],
                accepted_by_frames_lost=recovery.acceptance_by_bin(attempts),
                loss_episodes=recovery.loss_episodes(
                    res["tracked_ok"], res["is_keyframe"],
                    drv.reloc_events))), flush=True)
            r.update(
                loops_closed=len(drv.loop_edges), loops=drv.loop_edges,
                gba_merges=drv.gba_merges, gba=drv.gba_stats,
                reloc_attempts=len(drv.reloc_events),
                reloc_ok=sum(1 for _, ok in drv.reloc_events if ok),
                reloc_diags=drv.reloc_diags,
                loop_stats=dict(drv.loop_stats),
                loop_timings_s={k: round(v, 4)
                                for k, v in drv.loop_timings.items()},
                closure_stats=drv.closure_stats)
        out[arm] = r
        print(f"full SLAM, {arm} arm: " + json.dumps(r), flush=True)

    # the SLAM arm once more with its step eager (``cuda_graphs=False``),
    # timed as bench_full_slam times it: both fps from this call
    from vslam_tpu_torch.pipeline.streaming import StreamingSLAM

    _, _, make_cfg = world
    drv = StreamingSLAM(seq.calib, make_cfg(True), voc,
                        max_frames=n_frames + 8, poll_every=32, chunk=8,
                        device=dev, cuda_graphs=False)
    drv.run(seq.images[:warm])
    drv.poll()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drv.run(seq.images[warm:])
    drv._merge_gba_if_ready()
    torch.cuda.synchronize()
    res = drv.results()
    eager = dict(
        fps=(n_frames - warm) / (time.perf_counter() - t0),
        kf_ate_m=keyframe_ate(drv, seq), loops=drv.loop_edges,
        gba_merges=drv.gba_merges,
        keyframes=int(res["is_keyframe"].sum()),
        tracked=int(res["tracked_ok"].sum()),
        reloc=f"{sum(1 for _, ok in drv.reloc_events if ok)}/"
              f"{len(drv.reloc_events)}")
    graphed = out["slam"]
    eager["graphed_fps"] = graphed["fps"]
    eager["same_as_graphed"] = all(
        eager[k] == graphed[g] for k, g in (
            ("kf_ate_m", "kf_ate_m"), ("loops", "loops"),
            ("gba_merges", "gba_merges"), ("keyframes", "keyframes"),
            ("tracked", "tracked")))
    print("full SLAM, slam arm eager: " + json.dumps(eager), flush=True)
    del drv

    slam, vo = out["slam"], out["vo"]
    port = dict(loops_closed=slam["loops_closed"],
                gba_merges=slam["gba_merges"],
                reloc=f"{slam['reloc_ok']}/{slam['reloc_attempts']}",
                kf_ate_m=slam["kf_ate_m"], vo_control_kf_ate_m=vo["kf_ate_m"])
    same = {k: port[k] == v for k, v in JAX_TPU_FULL_SLAM.items()
            if not k.endswith("_m")}
    print("full SLAM: path length " + f"{traj_len:.1f} m; port " +
          json.dumps(port) + "; JAX package on a TPU (BENCH_r05.json) " +
          json.dumps(JAX_TPU_FULL_SLAM) + "; counters reproduced: " +
          json.dumps(same), flush=True)
    for arm, r in out.items():
        check(r["frames"] == n_frames, f"full SLAM {arm}: {r['frames']} "
                                       f"frames processed")
        check(r["trajectory_finite"], f"full SLAM {arm}: trajectory is not "
                                      f"finite")
    check(slam["kf_ate_m"] <= 1.15 * vo["kf_ate_m"],
          f"full SLAM: keyframe ATE {slam['kf_ate_m']:.3f} m > 1.15 x the VO "
          f"control's {vo['kf_ate_m']:.3f} m")
    # in the timed frames the control launches the landmark top-2 once per
    # frame and the descriptor top-2 twice per keyframe; the SLAM arm adds
    # its closure and relocalization calls
    timed = n_frames - warm
    check(vo["launches"] == dict(landmark_top2=timed,
                                 hamming_top2=2 * vo["timed_keyframes"]),
          f"full SLAM, vo arm: launches {vo['launches']} in {timed} frames, "
          f"{vo['timed_keyframes']} keyframes")
    check(slam["launches"]["landmark_top2"] >= timed
          and slam["launches"]["hamming_top2"]
          >= 2 * slam["timed_keyframes"],
          f"full SLAM, slam arm: launches {slam['launches']} in {timed} "
          f"frames, {slam['timed_keyframes']} keyframes")
    return slam["launches"], out, world


# ---------------------------------------------------------------------------
# the faithful driver and the command line; the large-map solvers
# ---------------------------------------------------------------------------

def phase_cli(dev, world):
    """The command line on phase 7's world, from files (see the module
    docstring, phase 8)."""
    import tempfile

    from vslam_tpu_torch import cli, synthetic
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.io import calib as calib_mod
    from vslam_tpu_torch.io import map_io
    from vslam_tpu_torch.loop import vocabulary as vocab_mod
    from vslam_tpu_torch.pipeline.slam import SlamSystem
    from vslam_tpu_torch.utils import checkpoint

    seq, voc, make_cfg = world
    n_frames = len(seq.images)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = os.path.join(tmp, "mav0")
        synthetic.write_mav0(seq, data)
        calib_path = os.path.join(tmp, "calib.json")
        calib_mod.save_calibration(seq.calib, calib_path)
        voc_path = os.path.join(tmp, "voc.txt")
        vocab_mod.save_dbow2_text(voc, voc_path)
        cfg_path = os.path.join(tmp, "config.json")
        cfg = make_cfg(True)
        cfg.seed = CLI_SEED
        cfg.to_json(cfg_path)
        print(f"command line: dataset ({n_frames} PGM pairs), calibration, "
              f"vocabulary and config written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        for name, extra in (("slam", []),
                            ("control", ["--no-loop", "--no-reloc"]),
                            ("streaming", ["--driver", "streaming"])):
            map_name = os.path.join(tmp, f"map_{name}")
            metrics = os.path.join(tmp, f"metrics_{name}.jsonl")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            rc = cli.main(["--dataset-path", data, "--cam-calib", calib_path,
                           "--voc-path", voc_path, "--config", cfg_path,
                           "--map-name", map_name, "--metrics", metrics,
                           *extra])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = read_launches()
            check(rc == 0, f"command line ({name}): return code {rc}")
            drv = cli.LAST_DRIVER
            with open(map_name + ".json") as f:
                raw = json.load(f)
            check(sorted(raw) == [f"value{i}" for i in range(5)],
                  f"command line ({name}): map keys {sorted(raw)}")
            cams, lms, est, gt, ate_val = map_io.load_map(map_name + ".json")
            with open(metrics) as f:
                rows = [json.loads(line) for line in f]
            n_kf = sum(r["kind"] == "keyframe" for r in rows)
            r = dict(
                seconds=dt, fps=n_frames / dt, frames=len(rows),
                keyframes=n_kf, tracked=sum(bool(x["ok"]) for x in rows),
                kf_ate_m=ate_val, cameras=len(cams), landmarks=len(lms),
                loops_closed=len(getattr(drv, "loop_edges", [])),
                gba_merges=getattr(drv, "gba_merges", 0),
                reloc_attempts=len(getattr(drv, "reloc_events", [])),
                reloc_ok=sum(1 for _, ok in getattr(drv, "reloc_events", [])
                             if ok),
                peak_memory_bytes=int(torch.cuda.max_memory_allocated()),
                launches=launches,
                # landmark top-2: once per frame in tracking, the rest in
                # the closure's guided matching and verification; descriptor
                # top-2: twice per keyframe in stereo matching, the rest in
                # the harvests of the closure and of relocalization
                launch_split=dict(
                    landmark_top2=dict(
                        tracking=len(rows),
                        closure=launches["landmark_top2"] - len(rows)),
                    hamming_top2=dict(
                        stereo=2 * n_kf,
                        harvest=launches["hamming_top2"] - 2 * n_kf)))
            if name == "slam":
                r["stage_timer"] = drv.timer.summary()
                r["rejected_loops"] = len(drv.rejected_loops)
            out[name] = r
            print(f"command line, {name}: " + json.dumps(r), flush=True)
            check(len(rows) == n_frames, f"command line ({name}): "
                                         f"{len(rows)} frames")
            check(np.isfinite(ate_val), f"command line ({name}): ATE "
                                        f"{ate_val}")
            check(len(cams) == n_kf and len(gt) == n_frames
                  and len(est) == n_kf and len(lms) > 0,
                  f"command line ({name}): map contents")
            check(launches["landmark_top2"] >= n_frames,
                  f"command line ({name}): landmark_top2 launched "
                  f"{launches['landmark_top2']} times in {n_frames} frames")
            check(launches["hamming_top2"] >= 2 * n_kf,
                  f"command line ({name}): hamming_top2 launched "
                  f"{launches['hamming_top2']} times for {n_kf} keyframes")
            if name != "control":
                got = drv.voc
                check(got.num_words == voc.num_words
                      and np.array_equal(got.node_desc, voc.node_desc)
                      and np.array_equal(got.weights, voc.weights)
                      and np.array_equal(got.children, voc.children),
                      f"command line ({name}): the vocabulary read back "
                      f"differs from the one saved")
        # The faithful run against its control is printed, not gated: on
        # this world both break in the second lap (300 features, a 3 m
        # orbit), at a frame that the RANSAC seed decides. Over seeds 0-5 on
        # an H100 (``--faithful-seeds``) the faithful run ended at 0.09-2.06
        # x its control, within 1.15 x in 5 of 6 (0.72-2.64 x, 3 of 6, with
        # the DLT's solve before its graph form; see CLI_SEED). The gate is
        # the world's scale: a trajectory that ran away ends tens of metres
        # off, one that holds together within the orbit's diameter.
        ratio = out["slam"]["kf_ate_m"] / out["control"]["kf_ate_m"]
        print(f"command line: faithful SLAM keyframe ATE "
              f"{out['slam']['kf_ate_m']:.3f} m, {ratio:.2f} x its control's "
              f"{out['control']['kf_ate_m']:.3f} m", flush=True)
        for name in ("slam", "control", "streaming"):
            check(out[name]["kf_ate_m"] < 2 * PANO_ORBIT_RADIUS_M,
                  f"command line ({name}): keyframe ATE "
                  f"{out[name]['kf_ate_m']:.3f} m, beyond the orbit's "
                  f"diameter")

        # the same entry point held to the repository's own bar: the small
        # world of the end-to-end VO tests, keyframe ATE under 0.08 m
        small = synthetic.generate(num_frames=24, num_points=500, seed=3)
        small_dir = os.path.join(tmp, "small")
        synthetic.write_mav0(small, os.path.join(small_dir, "mav0"))
        calib_mod.save_calibration(small.calib,
                                   os.path.join(small_dir, "calib.json"))
        small_config(SlamConfig).to_json(os.path.join(small_dir, "cfg.json"))
        html = os.path.join(small_dir, "view.html")
        rc = cli.main(["--dataset-path", os.path.join(small_dir, "mav0"),
                       "--cam-calib", os.path.join(small_dir, "calib.json"),
                       "--config", os.path.join(small_dir, "cfg.json"),
                       "--map-name", os.path.join(small_dir, "map"),
                       "--viz-html", html])
        small_ate = map_io.load_map(os.path.join(small_dir, "map.json"))[4]
        print(f"command line, small world: keyframe ATE {small_ate:.4f} m "
              f"over {len(cli.LAST_DRIVER.slot_of_frame)} keyframes",
              flush=True)
        check(rc == 0 and small_ate < 0.08,
              f"command line (small world): return code {rc}, keyframe ATE "
              f"{small_ate}")
        # the HTML viewer holds the run's trajectory
        with open(html) as f:
            page = f.read()
        start = page.index("const D = ") + len("const D = ")
        view = json.loads(page[start:page.index(";\n", start)])
        traj = np.asarray(cli.LAST_DRIVER.trajectory)[:, :3]
        check(len(view["traj"]) == len(small.images)
              and np.allclose(view["traj"], traj, atol=1e-5),
              "command line (small world): --viz-html trajectory")
        print(f"command line, small world: --viz-html wrote {len(page)} "
              f"bytes, {len(view['traj'])} poses, {len(view['lm'])} "
              f"landmarks", flush=True)
        out["small_world_kf_ate_m"] = small_ate

        # checkpoint round trip in the middle of a SlamSystem run
        images = [(torch.as_tensor(l).to(dev), torch.as_tensor(r).to(dev))
                  for l, r in seq.images[:65]]
        a = SlamSystem(seq.calib, make_cfg(True), device=dev)
        a.set_vocabulary(voc)
        for f in range(64):
            a.process_frame(*images[f])
        ckpt = os.path.join(tmp, "ckpt")
        checkpoint.save(a, ckpt)
        info_a = a.process_frame(*images[64])
        b = checkpoint.load(
            SlamSystem(seq.calib, make_cfg(True), device=dev), ckpt,
            device=dev)
        info_b = b.process_frame(*images[64])
        same_pose = bool(torch.equal(a.track.current_pose,
                                     b.track.current_pose))
        print(f"checkpoint: frame 64 uninterrupted {json.dumps(info_a)}; "
              f"restored {json.dumps(info_b)}; same pose bits: {same_pose}",
              flush=True)
        check(info_a == info_b and same_pose,
              "checkpoint: the restored run's frame 64 differs")
        check(b.voc.num_words == voc.num_words and b.frame == 65,
              "checkpoint: restored bookkeeping")
    return out


def phase_large_solvers(dev, smi):
    """The matrix-free solvers above the dense limits (see the module
    docstring, phase 9)."""
    from vslam_tpu_torch import interop, synthetic
    from vslam_tpu_torch.core.state import KeyframeState, LandmarkState
    from vslam_tpu_torch.loop import closure
    from vslam_tpu_torch.parallel import sharded_ba
    from vslam_tpu_torch.parallel.mesh import make_mesh
    from vslam_tpu_torch.pipeline import ba_global
    from vslam_tpu_torch.solvers import ba, ba_cg, pose_graph, pose_graph_cg

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0, int(
            torch.cuda.max_memory_allocated())

    # ---- solve_ba_cg: 8192 cameras, 65,536 landmarks, 1,048,576 obs ----
    t0 = time.perf_counter()
    arrays, poses_gt, _ = synthetic.make_big_problem()
    prob = interop.from_arrays(ba.BAProblem, arrays, dev)
    t_make = time.perf_counter() - t0
    check(prob.poses.shape[0] == 8192
          and prob.obs_cam.shape[0] == 1024 * 1024, "big problem's size")
    solve = lambda: ba_cg.solve_ba_cg(  # noqa: E731
        prob, cam_name="pinhole", huber=2.0, max_iters=3, cg_iters=8)
    solve()   # untimed: allocator warm-up
    (poses, points, stats), dt, peak = timed(solve)
    init, final = float(stats["initial_cost"]), float(stats["final_cost"])
    gt = torch.as_tensor(poses_gt[:, :3], device=dev)
    err0 = float(torch.linalg.norm(prob.poses[:, :3] - gt, dim=-1).mean())
    err1 = float(torch.linalg.norm(poses[:, :3] - gt, dim=-1).mean())
    r_ba = dict(cameras=8192, landmarks=65536, observations=1024 * 1024,
                valid_observations=int(prob.obs_valid.sum()),
                initial_cost=init, final_cost=final,
                lm_iterations=stats["iterations"],
                cg_iterations=stats["cg_iterations"],
                ms_per_lm_iteration=1e3 * dt / max(stats["iterations"], 1),
                seconds=dt, mean_camera_error_m=[err0, err1],
                peak_memory_bytes=peak, seconds_generate=t_make, card=smi)
    print("large solvers, solve_ba_cg: " + json.dumps(r_ba), flush=True)
    check(final < 0.5 * init, f"solve_ba_cg: cost {init} -> {final}")
    check(err1 < err0, f"solve_ba_cg: camera error {err0} -> {err1}")
    check(bool(torch.isfinite(poses).all() & torch.isfinite(points).all()),
          "solve_ba_cg: non-finite result")

    # ---- the same solve with the observations in two shards ----
    # (parallel/sharded_ba over a mesh that names this card twice: the
    # shards' partial sums are added on the lead device, so the costs agree
    # up to the order of float32 sums: 1e-3 relative)
    mesh = make_mesh(2, devices=[dev, dev])
    sharded = lambda: sharded_ba.solve_sharded(  # noqa: E731
        prob, mesh, cam_name="pinhole", huber=2.0, max_iters=3, cg_iters=8)
    sharded()
    (poses_s, points_s, stats_s), dt_s, peak_s = timed(sharded)
    final_s = float(stats_s["final_cost"])
    r_sh = dict(shards=2, devices=[str(d) for d in mesh.axis_devices()],
                initial_cost=float(stats_s["initial_cost"]),
                final_cost=final_s, unsharded_final_cost=final,
                lm_iterations=stats_s["iterations"],
                cg_iterations=stats_s["cg_iterations"],
                ms_per_lm_iteration=1e3 * dt_s / max(stats_s["iterations"], 1),
                unsharded_ms_per_lm_iteration=r_ba["ms_per_lm_iteration"],
                max_pose_difference=float((poses_s - poses).abs().max()),
                peak_memory_bytes=peak_s, card=smi)
    print("large solvers, solve_sharded: " + json.dumps(r_sh), flush=True)
    check(stats_s["iterations"] == stats["iterations"]
          and abs(final_s - final) <= 1e-3 * final,
          f"solve_sharded: cost {final_s} against the unsharded {final}")
    check(bool(torch.isfinite(poses_s).all() & torch.isfinite(points_s).all()),
          "solve_sharded: non-finite result")
    del prob, poses, points, poses_s, points_s

    # ---- solve_ba_schur_intrinsics: free intrinsics, pulled back to truth --
    arrays = synthetic.make_intrinsics_problem()
    iprob = interop.from_arrays(ba.BAProblem, arrays, dev)
    solve = lambda: ba.solve_ba_schur_intrinsics(  # noqa: E731
        iprob, cam_name="pinhole", huber=2.0, max_iters=30)
    solve()
    (_, _, intr2, stats), dt, peak = timed(solve)
    init, final = float(stats["initial_cost"]), float(stats["final_cost"])
    intr2 = intr2.cpu().numpy()
    r_in = dict(cameras=6, landmarks=120, observations=720,
                initial_cost=init, final_cost=final,
                lm_iterations=int(stats["iterations"]),
                ms_per_lm_iteration=1e3 * dt / max(int(stats["iterations"]),
                                                   1),
                start_fx_fy_cx=arrays["intr"][0, :3].tolist(),
                fx_fy_cx=intr2[:, :3].tolist(),
                truth_fx_fy_cx=synthetic.ORBIT_PINHOLE[:3].tolist(), card=smi)
    print("large solvers, solve_ba_schur_intrinsics: " + json.dumps(r_in),
          flush=True)
    # tests/test_ba.py::test_ba_joint_intrinsics_recovery's bars
    check(final < 0.1 * init, f"solve_ba_schur_intrinsics: cost {init} -> "
                              f"{final}")
    check(bool(np.all(np.abs(intr2[:, 0] - 400.0) < 1.5)
               and np.all(np.abs(intr2[:, 2] - 376.0) < 1.5)),
          f"solve_ba_schur_intrinsics: intrinsics {intr2[:, :3]}")

    # ---- solve_pose_graph_cg: a ring of 2048 keyframes, one loop edge ----
    n = 2048
    gt_p, poses0, ei, ej, meas = synthetic.make_ring_graph(n, drift=0.4)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    pg = pose_graph.PoseGraphProblem(
        poses=t(poses0), fixed=torch.arange(n, device=dev) == 0,
        edge_i=t(ei), edge_j=t(ej), edge_meas=t(meas),
        edge_valid=torch.ones(n, dtype=torch.bool, device=dev))
    check(n > closure.POSE_GRAPH_DENSE_MAX, "ring under the dense limit")
    solve = lambda: pose_graph_cg.solve_pose_graph_cg(  # noqa: E731
        pg, max_iters=20, cg_iters=30)
    solve()
    (opt, stats), dt, peak = timed(solve)
    init, final = float(stats["initial_cost"]), float(stats["final_cost"])
    end0 = float(np.linalg.norm(poses0[-1, :3] - gt_p[-1, :3]))
    end1 = float(torch.linalg.norm(opt[-1, :3] - t(gt_p[-1, :3])))
    r_pg = dict(keyframes=n, edges=n, initial_cost=init, final_cost=final,
                lm_iterations=20, cg_iterations=600,
                ms_per_lm_iteration=1e3 * dt / 20, seconds=dt,
                last_pose_error_m=[end0, end1], peak_memory_bytes=peak,
                card=smi)
    print("large solvers, solve_pose_graph_cg: " + json.dumps(r_pg),
          flush=True)
    check(final < 0.2 * init, f"solve_pose_graph_cg: cost {init} -> {final}")
    check(end1 < 0.5 * end0, f"solve_pose_graph_cg: last pose error {end0} "
                             f"-> {end1}")

    # ---- run_global_ba above BLOCKED_MAX_PAIRS keyframe pairs ----
    n_pairs = 160
    kfa, lma, gt_k = synthetic.make_orbit_state(
        n_pairs=n_pairs, pts_per_kf=64, obs_per_pt=6)
    kf = interop.from_arrays(KeyframeState, kfa, dev)
    lm = interop.from_arrays(LandmarkState, lma, dev)
    check(ba_global._pow2(n_pairs) > ba_global.BLOCKED_MAX_PAIRS,
          "orbit state under the blocked solver's limit")
    intr = t(synthetic.ORBIT_PINHOLE)
    solve = lambda: ba_global.run_global_ba(  # noqa: E731
        kf, lm, intr, intr, cam_name="pinhole", huber=2.0, max_iters=5,
        cg_iters=10)
    solve()
    (kf2, lm2, stats), dt, peak = timed(solve)
    init, final = float(stats["initial_cost"]), float(stats["final_cost"])
    gt_l = t(gt_k[:, 0, :3])
    err0 = float(torch.linalg.norm(kf.pose_l[:n_pairs, :3] - gt_l,
                                   dim=-1).mean())
    err1 = float(torch.linalg.norm(kf2.pose_l[:n_pairs, :3] - gt_l,
                                   dim=-1).mean())
    r_gba = dict(keyframes=n_pairs, landmarks=int(lm.next_slot),
                 initial_cost=init, final_cost=final,
                 lm_iterations=stats["iterations"],
                 cg_iterations=stats.get("cg_iterations"),
                 ms_per_lm_iteration=1e3 * dt / max(stats["iterations"], 1),
                 seconds=dt, mean_camera_error_m=[err0, err1],
                 peak_memory_bytes=peak, card=smi)
    print("large solvers, run_global_ba (CG branch): " + json.dumps(r_gba),
          flush=True)
    check("cg_iterations" in stats, "run_global_ba did not take the "
                                    "matrix-free branch")
    check(final < 0.5 * init, f"run_global_ba: cost {init} -> {final}")
    check(bool(torch.isfinite(kf2.pose_l).all()
               & torch.isfinite(lm2.pos).all()),
          "run_global_ba: non-finite result")
    return dict(ba_cg=r_ba, sharded=r_sh, intrinsics=r_in, pose_graph_cg=r_pg,
                gba_cg=r_gba)


# ---------------------------------------------------------------------------
# the multi-sequence path
# ---------------------------------------------------------------------------

# bench.bench_multiseq runs 116 frames (phase 14 runs it so); cut to 40
# here to keep the whole script near 850 s with phases 13 and 14
MULTISEQ_S, MULTISEQ_FRAMES = 8, 40
# A sequence must stay tracked on at least the single-sequence driver's
# share of the timed frames (world seed 10, same configuration) less this.
MULTISEQ_TRACKED_MARGIN = 0.05
# Trajectory ATE per sequence: at most twice the single-sequence driver's
# on world seed 10, or the bar of the JAX package's multi-sequence test
# (tests/test_multiseq.py: 0.15 m), whichever is larger. The lockstep step
# serves one keyframe request and one window BA per frame, so a sequence
# waits up to S - 1 frames for either and ends worse than the synchronous
# single-sequence driver.
MULTISEQ_ATE_FLOOR_M = 0.15
# 16 before phase 13 was added: the profiler's processing of a window
# (~7000 device operations per lockstep frame) is most of this phase's time
PROFILED_LOCKSTEP_FRAMES = 4


def phase_multiseq(dev, smi, single_vo_fps):
    """bench.bench_multiseq on the card: 8 worlds of 40 frames at 752x480
    through ``MultiSeqVO`` in lockstep, 8 warm-up and 32 timed frames, and
    the single-sequence ``StreamingVO`` on the first world at the same
    configuration beside it. A second pass gives the time per lockstep
    frame (a synchronize after each) and, over its last 4 frames, a
    ``torch.profiler`` window: device operations and device-to-host copies
    per lockstep frame and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from vslam_tpu_torch import bench, synthetic
    from vslam_tpu_torch.eval import ate
    from vslam_tpu_torch.parallel.multiseq_runner import MultiSeqVO
    from vslam_tpu_torch.pipeline.streaming import StreamingVO

    S, F, warm = MULTISEQ_S, MULTISEQ_FRAMES, WARMUP_FRAMES
    n_timed = F - warm
    t0 = time.perf_counter()
    worlds = [synthetic.generate(num_frames=F, num_points=500, width=752,
                                 height=480, seed=10 + s, speed=3.0)
              for s in range(S)]
    packed = MultiSeqVO.pack_frames(
        [(np.stack([w.images[f][0] for w in worlds]),
          np.stack([w.images[f][1] for w in worlds])) for f in range(F)])
    print(f"multi-sequence: {S} worlds of {F} frames 752x480 generated and "
          f"packed {list(packed.shape)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cfg = bench.multiseq_config()

    def timed_ate(traj, world):
        return float(ate.align_svd(traj[warm:F, :3],
                                   world.poses[warm:F, :3])[2])

    # ---- the single-sequence driver on world seed 10 ----
    frames1 = [(torch.as_tensor(l).to(dev), torch.as_tensor(r).to(dev))
               for l, r in worlds[0].images]
    vo1 = StreamingVO(worlds[0].calib, cfg, max_frames=F, device=dev)
    vo1.run(frames1[:warm])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vo1.run(frames1[warm:])
    torch.cuda.synchronize()
    fps1 = n_timed / (time.perf_counter() - t0)
    res1 = vo1.results()
    single = dict(
        fps=fps1, tracked_share=float(res1["tracked_ok"][warm:].mean()),
        keyframes=int(res1["is_keyframe"].sum()),
        ate_m=timed_ate(res1["trajectory"], worlds[0]))
    del vo1, frames1
    print("multi-sequence, single-sequence StreamingVO on world seed 10: "
          + json.dumps(single), flush=True)

    # ---- pass 1: the timed run ----
    ms = MultiSeqVO(worlds[0].calib, S, cfg, max_frames=F, device=dev)
    ms.run(packed[:warm])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ms.run(packed[warm:])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    peak = int(torch.cuda.max_memory_allocated())
    res = ms.results()
    infos = ms.infos[warm:]
    inserted_timed = int(res["is_keyframe"][:, warm:].sum())
    per_seq = [dict(
        ate_m=timed_ate(res["trajectories"][s], worlds[s]),
        tracked=int((res["inliers"][s, warm:] > 0).sum()),
        keyframes=int(res["is_keyframe"][s].sum()),
        window_bas=sum(i.ba_seq == s for i in ms.infos),
        landmarks=int(ms.lm.valid[s].sum())) for s in range(S)]
    finite = bool(np.isfinite(res["trajectories"]).all())

    # ---- pass 2: per-frame times, then a profiled window ----
    ms.reset()
    ms.run(packed[:warm])
    torch.cuda.synchronize()
    frame_ms, kinds = [], []
    first_profiled = F - PROFILED_LOCKSTEP_FRAMES
    for f in range(warm, first_profiled):
        t = time.perf_counter()
        ms.process_frames(packed[f, 0], packed[f, 1])
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        info = ms.infos[-1]
        kinds.append(("kf" if info.fire else "")
                     + ("+ba" if info.ba_seq is not None else "") or "track")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ms.run(packed[first_profiled:])
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.count > 0]
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    check(busy_s > 0, "multi-sequence: the profiler saw no device time")
    n_prof = PROFILED_LOCKSTEP_FRAMES
    profiled = dict(
        lockstep_frames=n_prof, wall_ms_per_frame=1e3 * wall_prof / n_prof,
        device_busy_ms_per_frame=1e3 * busy_s / n_prof,
        device_idle_share=1.0 - busy_s / wall_prof,
        device_ops_per_frame=sum(e.count for e in events) / n_prof,
        device_to_host_copies_per_frame=sum(
            e.count for e in events if "Memcpy DtoH" in e.key) / n_prof,
        keyframe_branches=sum(i.fire for i in ms.infos[first_profiled:]),
        window_bas=sum(i.ba_seq is not None
                       for i in ms.infos[first_profiled:]))

    def median_of(kind):
        xs = [t for t, k in zip(frame_ms, kinds) if k == kind]
        return (statistics.median(xs) if xs else None, len(xs))

    summary = dict(
        sequences=S, lockstep_frames=F, timed_lockstep_frames=n_timed,
        seq_frames_per_s=S * n_timed / dt, seconds=dt,
        single_sequence_fps_same_world=fps1,
        single_sequence_fps_phase_4=single_vo_fps,
        ratio_to_single_sequence=S * n_timed / dt / fps1,
        ms_per_lockstep_frame_median=statistics.median(frame_ms),
        ms_per_lockstep_frame_max=max(frame_ms),
        ms_median_by_kind={k: median_of(k) for k in sorted(set(kinds))},
        per_sequence=per_seq, keyframes_inserted_timed=inserted_timed,
        window_bas_timed=sum(i.ba_seq is not None for i in infos),
        peak_memory_bytes=peak, launches=launches, profiled=profiled,
        card=smi)
    print("multi-sequence: " + json.dumps(summary), flush=True)

    check(finite, "multi-sequence: a trajectory is not finite")
    check(launches["landmark_top2"] == n_timed,
          f"multi-sequence: landmark_top2 launched "
          f"{launches['landmark_top2']} times in {n_timed} lockstep frames")
    check(launches["hamming_top2"] == 2 * inserted_timed > 0,
          f"multi-sequence: hamming_top2 launched {launches['hamming_top2']} "
          f"times for {inserted_timed} keyframes")
    need = single["tracked_share"] - MULTISEQ_TRACKED_MARGIN
    ate_bar = max(2.0 * single["ate_m"], MULTISEQ_ATE_FLOOR_M)
    for s, r in enumerate(per_seq):
        check(r["tracked"] / n_timed >= need,
              f"multi-sequence: sequence {s} tracked {r['tracked']} of "
              f"{n_timed} frames, under {need:.3f}")
        check(r["ate_m"] <= ate_bar,
              f"multi-sequence: sequence {s} ATE {r['ate_m']:.4f} m > "
              f"{ate_bar:.4f} m")
        check(r["keyframes"] >= 2 and r["window_bas"] >= 2,
              f"multi-sequence: sequence {s} took {r['keyframes']} keyframes "
              f"and {r['window_bas']} window BAs")
    return launches, summary


# ---------------------------------------------------------------------------
# the learned frontend, reporting, calibration and the legacy solvers
# ---------------------------------------------------------------------------

# The learned-VO runs' initialization (the ``SuperPointTPU(generator=...)``
# seed) of both worlds. The JAX test's bars hold for some initializations
# and not others, in both packages (over flax keys 0-7 the JAX package's
# small-world run ended under 1.3 m for 3 of 8, once at 250 m; PERF.md PR
# 7). Pinned from a sweep on an H100 (``--learned-seeds 0 1 2 3 4 5 6 7``,
# deterministic mode): seed 5 gave 0.565 m on the small world and tracked
# every frame after frame 3 at full width; seeds 0, 3, 5, 7 met the small
# world's bars, 0-3, 5 and 7 the full width's.
LEARNED_SEED = 5
LEARNED_SMALL_FEATURES = 256
LEARNED_FULL_FEATURES = 512
# The JAX package's learned-frontend VO on a TPU (ROUND5_NOTES.md:180-184:
# streaming driver, 752x480, 512 learned features, 48 frames): another
# machine's figures, printed beside the card's, never compared.
JAX_TPU_LEARNED_VO = dict(fps=42.7, tracked="45/45", ate_m=2.6)


def learned_worlds():
    """(small, full): the JAX test's world (16 frames, 320x240) and the
    full-width one (48 frames, 752x480), each with its training frames."""
    from vslam_tpu_torch import synthetic

    small = synthetic.generate(num_frames=16, num_points=500, seed=4)
    full = synthetic.generate(num_frames=48, num_points=1200, width=752,
                              height=480, seed=4)
    return (small, [0, 2, 4, 6, 8]), (full, [0, 8, 16, 24, 32, 40])


def train_superpoint(seq, frames, seed, dev):
    """``synthetic.train_learned_frontend`` on the card. Returns (model,
    first and last loss, seconds including a synchronize)."""
    from vslam_tpu_torch import synthetic

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, losses = synthetic.train_learned_frontend(seq, frames, seed,
                                                     device=dev)
    losses = losses.cpu()
    return model, (float(losses[0]), float(losses[-1])), \
        time.perf_counter() - t0


@contextlib.contextmanager
def kernel_inputs():
    """While open, a copy of the arguments of every call of the two
    kernels' wrappers is kept, by kernel name; the wrappers and their
    counts are otherwise untouched. A streaming driver built while it is
    open runs its step eagerly: a graph replay calls no wrapper, so its
    launches would go unkept (a driver built before it opens is built
    with ``cuda_graphs=False`` by its phase)."""
    from unittest import mock

    from vslam_tpu_torch.ops import cuda_hamming
    from vslam_tpu_torch.pipeline.streaming import StreamingVO

    calls = {"landmark_top2": [], "hamming_top2": []}
    wrappers = {name: getattr(cuda_hamming, name) for name in calls}
    eager = mock.patch.object(StreamingVO, "_graphs_wanted",
                              lambda self, flag: False)

    def keeping(name):
        def call(*args):
            calls[name].append(tuple(
                a.clone() if torch.is_tensor(a) else a for a in args))
            return wrappers[name](*args)
        return call

    for name in calls:
        setattr(cuda_hamming, name, keeping(name))
    try:
        with eager:
            yield calls
    finally:
        for name, fn in wrappers.items():
            setattr(cuda_hamming, name, fn)


def check_kernel_inputs(calls, where):
    """Every kept call once more through its kernel and its plain version:
    exact agreement. Returns per kernel the calls checked and the share of
    valid rows whose best and second distance tie."""
    from vslam_tpu_torch.ops import cuda_hamming, hamming

    out = {}
    for name, plain in (("landmark_top2", hamming.landmark_top2_plain),
                        ("hamming_top2", hamming.hamming_top2_plain)):
        ties, rows = 0, 0
        for i, args in enumerate(calls[name]):
            want = plain(*args)
            e = max_abs_err(getattr(cuda_hamming, name)(*args), want)
            check(e == 0, f"{where}: {name} differs from its plain version "
                          f"on call {i} of the run (max abs err {e})")
            valid = args[1] if name == "landmark_top2" else args[2]
            ties += int(((want[0] == want[1]) & (want[0] < 256)
                         & valid).sum())
            rows += int(valid.sum())
        out[name] = dict(calls_checked=len(calls[name]),
                         tied_share=ties / max(rows, 1))
    return out


def learned_vo(seq, model, num_features, dev):
    """``StreamingVO(feature_fn=...)`` over ``seq`` on the card, the
    launch counters reset just before and the kernels' inputs kept
    (``kernel_inputs``: a copy of under 1 MB per call, inside the timed
    run). Returns a summary dict."""
    from vslam_tpu_torch import synthetic
    from vslam_tpu_torch.eval import ate
    from vslam_tpu_torch.models.learned_frontend import make_feature_fn
    from vslam_tpu_torch.pipeline.streaming import StreamingVO

    frames = [(torch.as_tensor(l).to(dev), torch.as_tensor(r).to(dev))
              for l, r in seq.images]
    vo = StreamingVO(seq.calib, synthetic.learned_config(num_features),
                     max_frames=len(frames) + 8, device=dev,
                     feature_fn=make_feature_fn(
                         model, num_features,
                         synthetic.LEARNED_SCORE_THRESHOLD))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with kernel_inputs() as calls:
        t0 = time.perf_counter()
        vo.run(frames)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = read_launches()
    res = vo.results()
    fids, pos, _ = vo.keyframe_trajectory()
    ok = res["tracked_ok"]
    return dict(
        frames=int(res["frames"]), seconds=dt, fps=len(frames) / dt,
        tracked=int(ok.sum()), tracked_share_after_3=float(ok[3:].mean()),
        keyframes=int(res["is_keyframe"].sum()), kf_frames=fids.tolist(),
        kf_ate_m=float(ate.align_svd(pos, seq.poses[fids, :3])[2])
        if len(fids) >= 3 else float("nan"),
        median_inliers=float(np.median(res["inliers"][1:])),
        finite=bool(np.isfinite(res["trajectory"]).all()),
        peak_memory_bytes=int(torch.cuda.max_memory_allocated()),
        launches=launches, kernel_calls=calls)


def check_learned_launches(r, where):
    check(r["launches"]["landmark_top2"] == r["frames"],
          f"{where}: landmark_top2 launched {r['launches']['landmark_top2']} "
          f"times in {r['frames']} frames")
    check(r["launches"]["hamming_top2"] == 2 * r["keyframes"],
          f"{where}: hamming_top2 launched {r['launches']['hamming_top2']} "
          f"times for {r['keyframes']} keyframes")


def time_at_shape(calls, kernels, key, path):
    """Each kernel that ran timed at its last kept call of a run
    (``calls``, from ``kernel_inputs``), as ``slam_shape`` at the SLAM
    slice's: ``kernels[name][key]``; ``path`` names the run in the
    printout."""
    from vslam_tpu_torch.ops import cuda_hamming, hamming

    for name, plain, bound_of in (
            ("landmark_top2", hamming.landmark_top2_plain,
             lambda *a: landmark_bound(*a)[:2]),
            ("hamming_top2", hamming.hamming_top2_plain, hamming_bound)):
        if not calls[name]:
            continue
        args = calls[name][-1]
        seqs = f"S={args[0].shape[0]} " if args[0].dim() == 3 else ""
        shape = (f"{seqs}N={args[0].shape[-2]} P={args[3].shape[-3]} "
                 f"B={args[3].shape[-2]}" if name == "landmark_top2" else
                 f"N={args[0].shape[0]} M={args[1].shape[0]}")
        t = timings(getattr(cuda_hamming, name), plain, args, name)
        b_ms, b_by = bound_of(*args)
        kernels[name][key] = at_shape(t, shape, b_ms, b_by)
        print(f"kernel {name} at the {path} {shape}: device "
              f"({t['ms_source']}) {t['ms']:.4f} ms (plain "
              f"{t['plain_ms']:.4f}, {t['plain_ms_source']}); per call with "
              f"host {t['call_ms']:.4f} ms (plain {t['plain_call_ms']:.4f}); "
              f"bound {b_ms * 1e3:.3f} us by {b_by}", flush=True)


def phase_learned(dev, smi, kernels):
    """The learned frontend on the card, and the reporting, calibration
    and legacy-solver entry points (see the module docstring, phase 11).
    Adds each kernel's ``learned_shape`` to ``kernels``. Returns the
    full-width learned-VO run's launches."""
    from vslam_tpu_torch import synthetic
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.models import superpoint as sp
    from vslam_tpu_torch.models.learned_frontend import \
        extract_features_learned
    from vslam_tpu_torch.pipeline import projections
    from vslam_tpu_torch.pipeline.slam import SlamSystem
    from vslam_tpu_torch.solvers import relative_pose as rp
    from vslam_tpu_torch.tools import calibrate as cal

    # ---- SuperPoint at its default width: the card against the CPU ----
    (small, small_frames), (full, full_frames) = learned_worlds()
    cpu_model = sp.SuperPointTPU(generator=torch.Generator().manual_seed(0))
    card_model = sp.SuperPointTPU().to(dev)
    card_model.load_state_dict(cpu_model.state_dict())
    img = torch.as_tensor(full.images[0][0])
    x = img.float()[None, :, :, None] / 255.0
    with torch.no_grad():
        lc, dc = cpu_model(x)
        lg, dg = (t.cpu() for t in card_model(x.to(dev)))
    rel = [float((g - c).abs().max() / c.abs().max())
           for g, c in ((lg, lc), (dg, dc))]
    clear = dc.abs() > 1e-4
    same_bits = float(((dg > 0) == (dc > 0))[clear].float().mean())
    img_dev = img.to(dev)
    with torch.no_grad():
        fwd_ms = device_ms(lambda: card_model(x.to(dev)), "")[0]
        ext_ms, _, ext_ops, _ = device_ms(
            lambda: extract_features_learned(card_model, img_dev, 512), "")
    r = dict(shape="1x480x752x1, dim 256, width 64",
             logits_max_rel_err=rel[0], desc_max_rel_err=rel[1],
             same_bits_where_clear=same_bits,
             clear_share=float(clear.float().mean()),
             forward_device_ms=fwd_ms, extract_512_device_ms=ext_ms,
             extract_device_ops=ext_ops, card=smi)
    print("learned, SuperPoint card vs CPU: " + json.dumps(r), flush=True)
    check(max(rel) <= 1e-3, f"SuperPoint on the card differs from the CPU: "
                            f"relative error {rel}")
    check(same_bits >= 0.999, f"SuperPoint descriptor bits: {same_bits}")

    out = {}
    with deterministic():
        # ---- the JAX test's model trained on the card, small world ----
        model, (l0, l1), secs = train_superpoint(
            small, small_frames, LEARNED_SEED, dev)
        r = learned_vo(small, model, LEARNED_SMALL_FEATURES, dev)
        r.update(train_seconds=secs, first_loss=l0, last_loss=l1,
                 init_seed=LEARNED_SEED, kernel_inputs=check_kernel_inputs(
                     r.pop("kernel_calls"), "learned small world"))
        print("learned VO, small world: " + json.dumps(r), flush=True)
        check(l1 < 0.8 * l0, f"learned small world: loss {l0} -> {l1}")
        check(r["frames"] == 16 and r["finite"], "learned small world: run")
        check(r["tracked_share_after_3"] > 0.7,
              f"learned small world: tracked {r['tracked_share_after_3']}")
        check(r["keyframes"] >= 3 and r["kf_ate_m"] < 1.3,
              f"learned small world: {r['keyframes']} keyframes, ATE "
              f"{r['kf_ate_m']}")
        check_learned_launches(r, "learned small world")

        # ---- full width: 48 frames at 752x480, 512 learned features ----
        model, (l0, l1), secs = train_superpoint(
            full, full_frames, LEARNED_SEED, dev)
        r = learned_vo(full, model, LEARNED_FULL_FEATURES, dev)
        calls = r.pop("kernel_calls")
        r.update(train_seconds=secs, first_loss=l0, last_loss=l1,
                 init_seed=LEARNED_SEED, card=smi,
                 kernel_inputs=check_kernel_inputs(calls,
                                                   "learned full width"))
        time_at_shape(calls, kernels, "learned_shape", "learned path's")
        del calls
        out["full"] = r
        print("learned VO, full width: " + json.dumps(r), flush=True)
        print("learned VO, the JAX package on a TPU (ROUND5_NOTES.md, TPU, "
              "not comparable): " + json.dumps(JAX_TPU_LEARNED_VO),
              flush=True)
        check(r["frames"] == 48 and r["finite"],
              "learned full width: frames or trajectory")
        check(r["tracked_share_after_3"] > 0.7,
              f"learned full width: tracked {r['tracked_share_after_3']}")
        check_learned_launches(r, "learned full width")

        # ---- the reprojection report of a short SlamSystem run ----
        seq = synthetic.generate(num_frames=12, num_points=500, seed=3)
        slam = SlamSystem(seq.calib, small_config(SlamConfig), device=dev)
        for img_l, img_r in seq.images:
            slam.process_frame(img_l, img_r)
        rep = slam.reprojection_report()
        rmse = projections.reprojection_rmse(rep)
        overlay = slam.render_overlay(seq.images[-1][0])
        r = dict(observations=int(rep.valid.sum()), rmse_px=rmse,
                 flagged=int((rep.outlier_flags != 0).sum()),
                 overlay_shape=list(overlay.shape))
        print("reprojection report: " + json.dumps(r), flush=True)
        check(np.isfinite(rmse) and r["observations"] > 0,
              f"reprojection report: RMSE {rmse}")

    # ---- calibration at tests/test_calibrate.py's problem ----
    prob, truth = synthetic.make_calib_problem()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T_w_i, T_i_c, intr, stats = cal.calibrate(
        cal.CalibProblem(**{k: torch.as_tensor(v) for k, v in prob.items()}),
        cam_name="ds", max_iters=40, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    err = np.abs(intr.cpu().numpy() - truth["intr"])
    t_err = np.abs(T_i_c.cpu().numpy()[:, :3] - truth["T_i_c"][:, :3])
    r = dict(frames=len(truth["T_w_i"]), observations=len(prob["obs_uv"]),
             initial_cost=float(stats["initial_cost"]),
             final_cost=float(stats["final_cost"]),
             focal_center_err_px=float(err[:, :4].max()),
             xi_alpha_err=float(err[:, 4:6].max()),
             baseline_err_m=float(t_err.max()), seconds=dt,
             ms_per_iteration=1e3 * dt / 40)
    print("calibration: " + json.dumps(r), flush=True)
    check(r["final_cost"] < 1e-4 * r["initial_cost"]
          and r["focal_center_err_px"] < 1.0 and r["xi_alpha_err"] < 0.01
          and r["baseline_err_m"] < 1e-3, "calibration: the test's bars")

    # ---- the E/H hybrid on tests/test_relative_pose_planar.py's plane ----
    f1, f2, T_gt = synthetic.planar_two_view(planar=True, noise=5e-4, seed=1)
    T, inl, num, ok, used_h = rp.ransac_relative_pose_hybrid(
        torch.as_tensor(f1).to(dev), torch.as_tensor(f2).to(dev),
        torch.ones(len(f1), dtype=torch.bool, device=dev), threshold=3e-3,
        generator=torch.Generator(device=dev).manual_seed(1))
    T = T.cpu().numpy()
    t_gt = T_gt[:3] / np.linalg.norm(T_gt[:3])
    dir_err = float(np.arccos(np.clip(abs(np.dot(T[:3], t_gt)), -1, 1)))
    from vslam_tpu_torch.geometry import lie

    rot_err = float(torch.linalg.vector_norm(lie.se3_log(lie.se3_mul(
        lie.se3_inv(torch.as_tensor(T)), torch.as_tensor(
            np.concatenate([t_gt, T_gt[3:]]), dtype=torch.float32)))[3:]))
    r = dict(ok=bool(ok), used_homography=bool(used_h), inliers=int(num),
             rotation_err_rad=rot_err, direction_err_rad=dir_err)
    print("relative pose, planar hybrid: " + json.dumps(r), flush=True)
    check(r["ok"] and r["used_homography"] and rot_err < 0.02
          and dir_err < 0.06, "relative pose: the planar hybrid")
    return out["full"]["launches"]


# ---------------------------------------------------------------------------
# the EuRoC configuration: double-sphere, KB4 and EUCM cameras
# ---------------------------------------------------------------------------

# Phase 12's floor on the share of timed frames tracked after the bootstrap
# in the double-sphere run (phase 4's pinhole run tracks all of them; the
# share of both is printed).
EUROC_TRACKED_FLOOR = 0.9


def ds_model_config(SlamConfig):
    """tests/test_e2e_ds_model.py's configuration."""
    return SlamConfig(
        num_features=400, ransac_hypotheses=128, max_landmarks=8192,
        max_keyframes=64, max_inview_landmarks=512, window_cams=24,
        window_points=2048, window_obs=6144, ba_max_iters=8,
        enable_relocalization=False, enable_loop_closure=False,
        new_kf_min_inliers=60)


def table_cells(table, name):
    """The numbers of ``name``'s row of an ATE table (SLAM ATE, VO ATE,
    loops, ground-truth path, SLAM drift)."""
    row = [ln for ln in table.splitlines() if ln.startswith(f"| {name} |")]
    check(len(row) == 1, f"EuRoC table: no row for {name}")
    return [float(c) for c in row[0].split("|")[2:-1]]


def phase_euroc(dev, smi, kernels, pinhole):
    """The EuRoC configuration on the card (see the module docstring,
    phase 12): ``pinhole`` is phase 4's summary. Adds each kernel's
    ``euroc_ds_shape`` to ``kernels``. Returns the launches of the
    double-sphere ``StreamingVO`` run and of the ATE tool's run."""
    import tempfile

    from vslam_tpu_torch import bench, synthetic
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.eval import ate
    from vslam_tpu_torch.io import calib as calib_mod
    from vslam_tpu_torch.loop import vocabulary as vocab_mod
    from vslam_tpu_torch.pipeline.slam import SlamSystem
    from vslam_tpu_torch.pipeline.streaming import StreamingVO
    from vslam_tpu_torch.tools import ate_table, bench_worlds

    # ---- StreamingVO at the benchmark's configuration through ds ----
    t0 = time.perf_counter()
    seq = synthetic.generate(num_frames=128, num_points=1200, width=752,
                             height=480, seed=2, speed=3.0, cam_type="ds")
    frames = [(torch.as_tensor(l).to(dev), torch.as_tensor(r).to(dev))
              for l, r in seq.images]
    t_world = time.perf_counter() - t0
    # eager: every K1 / K2 call of the timed frames is kept and checked
    vo = StreamingVO(seq.calib, bench.vo_config(),
                     max_frames=len(frames), device=dev, cuda_graphs=False)
    check(vo.cam_name == "ds", f"EuRoC ds: camera {vo.cam_name}")
    vo.run(frames[:WARMUP_FRAMES])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms = []
    with kernel_inputs() as vo_calls:
        for img_l, img_r in frames[WARMUP_FRAMES:]:
            t = time.perf_counter()
            vo.process_frame(img_l, img_r)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
    launches = read_launches()
    res = vo.results()
    n_timed = len(frames) - WARMUP_FRAMES
    kfs_timed = int(res["is_keyframe"][WARMUP_FRAMES:].sum())
    tracked_share = float(res["tracked_ok"][1:].mean())
    pinhole_share = pinhole["tracked_after_bootstrap"] / (
        pinhole["frames"] - 1)
    fids, pos, _ = vo.keyframe_trajectory()
    kf_ate = float(ate.align_svd(pos, seq.poses[fids, :3])[2])
    bar = max(2.0 * pinhole["kf_ate_m"], 0.05)
    r = dict(
        frames=int(res["frames"]), timed_frames=n_timed,
        keyframes=int(res["is_keyframe"].sum()), keyframes_timed=kfs_timed,
        tracked_share_after_bootstrap=tracked_share,
        pinhole_tracked_share_after_bootstrap=pinhole_share,
        kf_ate_m=kf_ate, kf_ate_bar_m=bar,
        pinhole_kf_ate_m=pinhole["kf_ate_m"],
        median_ms_per_frame=statistics.median(ms), max_ms_per_frame=max(ms),
        fps=1e3 * n_timed / sum(ms),
        pinhole_median_ms_per_frame=pinhole["median_ms_per_frame"],
        max_memory_allocated_bytes=int(torch.cuda.max_memory_allocated()),
        launches=launches, world_seconds=t_world, card=smi)
    print("EuRoC ds, StreamingVO: " + json.dumps(r), flush=True)
    traj = res["trajectory"]
    check(traj.shape == (len(frames), 7) and np.isfinite(traj).all(),
          "EuRoC ds: trajectory is not finite")
    check(tracked_share >= EUROC_TRACKED_FLOOR,
          f"EuRoC ds: tracked {tracked_share:.3f} of the frames after the "
          f"bootstrap (pinhole {pinhole_share:.3f})")
    check(kf_ate <= bar, f"EuRoC ds: keyframe ATE {kf_ate:.4f} m > "
                         f"{bar:.4f} m")
    check(launches["landmark_top2"] == n_timed,
          f"EuRoC ds: landmark_top2 launched {launches['landmark_top2']} "
          f"times in {n_timed} frames")
    check(kfs_timed > 0 and launches["hamming_top2"] == 2 * kfs_timed,
          f"EuRoC ds: hamming_top2 launched {launches['hamming_top2']} times "
          f"for {kfs_timed} keyframes")
    time_at_shape(vo_calls, kernels, "euroc_ds_shape",
                  "EuRoC ds run's")
    del vo, frames

    # ---- the ATE tool's --dataset-root mode on that world, from files ----
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        synthetic.write_mav0(seq, os.path.join(tmp, "EUROC_DS", "mav0"))
        calib_path = os.path.join(tmp, "calib.json")
        calib_mod.save_calibration(seq.calib, calib_path)
        cfg = bench.vo_config()
        voc = bench_worlds.train_vocabulary(bench_worlds.vocabulary_pool(
            seq.images, range(0, len(seq.images), 8), cfg.num_features, dev))
        voc_path = os.path.join(tmp, "voc.txt")
        vocab_mod.save_dbow2_text(voc, voc_path)
        cfg_path = os.path.join(tmp, "config.json")
        cfg.to_json(cfg_path)
        out_path = os.path.join(tmp, "EUROC_TABLE.md")
        t_files = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        rows = []
        with kernel_inputs() as tool_calls:
            rc = ate_table.main(["--dataset-root", tmp, "--cam-calib",
                                 calib_path, "--voc-path", voc_path,
                                 "--config", cfg_path, "--out", out_path],
                                rows)
        torch.cuda.synchronize()
        t_tool = time.perf_counter() - t0
        tool_launches = read_launches()
        check(rc == 0, f"EuRoC ATE table: return code {rc}")
        with open(out_path) as f:
            table = f.read()
    (row,) = rows
    cells = table_cells(table, "EUROC_DS")
    check(all(np.isfinite(c) for c in cells),
          f"EuRoC ATE table: a cell is not finite: {cells}")
    arms = {}
    for arm in ("slam", "vo"):
        a = row[arm]
        arms[arm] = dict(
            kf_ate_m=a["ate_m"], keyframes=a["keyframes"], loops=a["loops"],
            frames=a["frames"], tracked=a["tracked"], fps=a["fps"],
            median_ms_per_frame=statistics.median(a["frame_ms"]),
            max_ms_per_frame=max(a["frame_ms"]))
    r = dict(arms=arms, table_cells=cells, seconds=t_tool,
             files_and_vocabulary_seconds=t_files,
             vocabulary_words=voc.num_words,
             max_memory_allocated_bytes=int(torch.cuda.max_memory_allocated()),
             launches=tool_launches, card=smi)
    print("EuRoC ds, ATE tool: " + json.dumps(r), flush=True)
    n_frames = sum(a["frames"] for a in arms.values())
    n_kf = sum(a["keyframes"] for a in arms.values())
    check(tool_launches["landmark_top2"] >= n_frames,
          f"EuRoC ATE table: landmark_top2 launched "
          f"{tool_launches['landmark_top2']} times in {n_frames} frames")
    check(tool_launches["hamming_top2"] >= 2 * n_kf,
          f"EuRoC ATE table: hamming_top2 launched "
          f"{tool_launches['hamming_top2']} times for {n_kf} keyframes")
    r = check_kernel_inputs(
        {k: vo_calls[k] + tool_calls[k] for k in vo_calls}, "EuRoC ds")
    print("EuRoC ds, kernel inputs: " + json.dumps(r), flush=True)
    del vo_calls, tool_calls

    # ---- kb4 and eucm on the JAX test's world, both drivers ----
    for cam in ("kb4", "eucm"):
        small = synthetic.generate(num_frames=14, num_points=500, seed=7,
                                   cam_type=cam)
        for name in ("SlamSystem", "StreamingVO"):
            if name == "SlamSystem":
                drv = SlamSystem(small.calib, ds_model_config(SlamConfig),
                                 device=dev)
                for img_l, img_r in small.images:
                    drv.process_frame(img_l, img_r)
            else:
                drv = StreamingVO(small.calib, ds_model_config(SlamConfig),
                                  max_frames=32, device=dev)
                drv.run(small.images)
            fids, pos, _ = drv.keyframe_trajectory()
            rmse = (float(ate.align_svd(pos, small.poses[fids, :3])[2])
                    if len(fids) >= 3 else float("nan"))
            print(f"EuRoC models, {cam} {name}: keyframes {len(fids)}, "
                  f"keyframe ATE {rmse:.4f} m", flush=True)
            check(drv.cam_name == cam and len(fids) >= 3 and rmse < 0.12,
                  f"{cam} {name}: {len(fids)} keyframes, ATE {rmse}")
    return launches, tool_launches


# ---------------------------------------------------------------------------
# the measurement tools
# ---------------------------------------------------------------------------

def check_positive_times(record, where):
    """Every float of a flat record (the tools' times, rates and costs)
    finite and positive; a stage's device ms, where the profiler measured
    it, no more than its wall ms (where it saw no event, ``device_ms``
    gives CUDA events around back-to-back calls, host gaps included)."""
    for name, value in record.items():
        if isinstance(value, float):
            check(math.isfinite(value) and value > 0,
                  f"{where}: {name} = {value}")
        if not (isinstance(value, float) and name + "_device" in record):
            continue
        if record[name + "_device_ops"] is None:
            print(f"{where}: {name}'s device ms from CUDA events, not "
                  f"compared with its wall", flush=True)
            continue
        check(record[name + "_device"] <= value,
              f"{where}: {name} device {record[name + '_device']} ms > "
              f"wall {value} ms")


def phase_tools(dev, smi, world):
    """The five measurement tools in-process on the card (see the module
    docstring, phase 13); ``world`` is phase 7's. Returns the launches of
    the profiled run and of the ablation's run."""
    import tempfile

    from vslam_tpu_torch.loop import vocabulary as vocab_mod
    from vslam_tpu_torch.tools import (ablation_reloc, bench_gba_scale,
                                       bench_vocab, profile_kf_branch,
                                       profile_stages)

    def timed(fn):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, read_launches()

    with tempfile.TemporaryDirectory() as tmp:
        # ---- per-stage profile of the faithful driver ----
        with kernel_inputs() as stage_calls:
            stages, dt, stage_launches = timed(lambda: profile_stages.main(
                ["--frames", "20", "--reps", "5"]))
        print("measurement tools, profile_stages: " + json.dumps(dict(
            record=stages, launches=stage_launches, seconds=dt, card=smi)),
            flush=True)
        check_positive_times(stages, "profile_stages")
        check(stages["frames"] == 20,
              f"profile_stages: {stages['frames']} end-to-end frames")

        # ---- the keyframe branch, at the tool's defaults ----
        kf, dt, _ = timed(lambda: profile_kf_branch.main([]))
        print("measurement tools, profile_kf_branch: " + json.dumps(dict(
            record=kf, seconds=dt, card=smi)), flush=True)
        check_positive_times(kf, "profile_kf_branch")
        check(kf["keyframe branch (delta)"] > 0,
              f"profile_kf_branch: delta {kf['keyframe branch (delta)']}")

        # ---- the global BA at 512 and 1024 pairs (phase 9 solves 4096) --
        rows, dt, _ = timed(lambda: bench_gba_scale.main(
            ["--pairs", "512,1024", "--out", os.path.join(tmp, "gba.json")]))
        print("measurement tools, bench_gba_scale: " + json.dumps(dict(
            rows=rows, seconds=dt, card=smi)), flush=True)
        for row in rows:
            check_positive_times(row, f"bench_gba_scale {row['n_pairs']}")
            check(row["final_cost"] < 0.5 * row["initial_cost"]
                  and row["iterations"] >= 1,
                  f"bench_gba_scale {row['n_pairs']} pairs: cost "
                  f"{row['initial_cost']} -> {row['final_cost']} in "
                  f"{row['iterations']} iterations")

        # ---- the ORBvoc-scale vocabulary, its descent against the CPU's --
        # depth 5, not the tool's 6: the text save and parse of 1.1M
        # nodes took ~30 s of the script, which phase 14 needs
        (vocab, voc, words), dt, _ = timed(lambda: bench_vocab.bench(
            5, device=dev))
        descs, _ = bench_vocab.queries(voc)
        cpu_words = vocab_mod.DeviceVocabulary(voc, "cpu").words(
            torch.as_tensor(descs),
            torch.ones(len(descs), dtype=torch.bool)).numpy()
        print("measurement tools, bench_vocab: " + json.dumps(dict(
            record=vocab, seconds=dt, card=smi)), flush=True)
        check_positive_times(vocab, "bench_vocab")
        check(np.array_equal(words, cpu_words),
              f"bench_vocab: the card's descent differs from the CPU's on "
              f"{int((words != cpu_words).sum())} of {len(words)} "
              f"descriptors")
        del voc

        # ---- the ablation's full arm on phase 7's world, deterministic
        # as phases 6-8 (the other arms take the same kernels' paths) --
        with deterministic(), kernel_inputs() as ablation_calls:
            ablation, dt, ablation_launches = timed(
                lambda: ablation_reloc.main(
                    ["--variants", "full",
                     "--out", os.path.join(tmp, "ablation.json")],
                    world=world))
        print("measurement tools, ablation_reloc: " + json.dumps(dict(
            record=ablation, launches=ablation_launches, seconds=dt,
            card=smi)), flush=True)
        for row in ablation["rows"]:
            check(np.isfinite(row["ate_m"]),
                  f"ablation_reloc {row['variant']}: ATE {row['ate_m']}")

    for name, launches in (("profile_stages", stage_launches),
                           ("ablation_reloc", ablation_launches)):
        check(launches["landmark_top2"] > 0 and launches["hamming_top2"] > 0,
              f"{name}: launches {launches}")
    r = check_kernel_inputs(
        {k: stage_calls[k] + ablation_calls[k] for k in stage_calls},
        "measurement tools")
    print("measurement tools, kernel inputs: " + json.dumps(r), flush=True)
    return stage_launches, ablation_launches


# ---------------------------------------------------------------------------
# the benchmark program
# ---------------------------------------------------------------------------

def kept_emitter():
    """A benchmark ``Emitter`` that also keeps, in ``lines``, each line it
    prints."""
    from vslam_tpu_torch.bench import Emitter

    class Kept(Emitter):
        def __init__(self):
            super().__init__(900.0)
            self.lines = []

        def emit(self, **fields):
            super().emit(**fields)
            self.lines.append(json.dumps(self.out))   # the line it printed

    return Kept()


def bench_lines(em, where):
    """The lines a ``kept_emitter`` printed: each parses and holds at most
    ``LINE_CAP`` bytes, the last carries ``bench_complete``. Returns the
    last."""
    raw = em.lines
    check(raw, f"{where}: no line printed")
    for x in raw:
        check(len(x.encode()) <= em.LINE_CAP,
              f"{where}: a line of {len(x.encode())} bytes")
        json.loads(x)
    last = json.loads(raw[-1])
    check(last.get("bench_complete") is True,
          f"{where}: the last line lacks bench_complete")
    return last


def phase_bench(dev, smi, em):
    """The benchmark program's sub-benches in process on the card (see the
    module docstring, phase 14). ``em`` is the ``kept_emitter`` that holds
    phase 7's full-SLAM sub-bench. Returns the launches of each sub-bench's
    call."""
    from vslam_tpu_torch import bench

    def call(fn):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, read_launches()

    frames, calib, src = bench.load_workload(False, WARMUP_FRAMES + 120)
    vo, t_vo, vo_launches = call(lambda: bench.bench_single(
        em, frames, calib, False, src, vo_budget_s=240.0, max_runs=1,
        device=dev))
    ms, t_ms, ms_launches = call(lambda: bench.bench_multiseq(
        em, max_runs=1, device=dev))
    em.emit(bench_complete=True)
    line = bench_lines(em, "bench")
    em_f = kept_emitter()
    fa, t_fa, fa_launches = call(lambda: bench.bench_single(
        em_f, frames, calib, True, src, vo_budget_s=240.0, device=dev))
    em_f.emit(bench_complete=True)
    line_f = bench_lines(em_f, "bench --driver slam")

    res, ms_res = vo.results(), ms.results()
    fa_kfs = sum(1 for s in fa.stats if s["kind"] == "keyframe")
    summary = dict(
        seconds=dict(vo=t_vo, multiseq=t_ms, faithful=t_fa),
        euroc_vo_fps=line["value"], window_ba_ms=line["window_ba_ms"],
        faithful_fps=line_f["value"], faithful_keyframes=line_f["keyframes"],
        faithful_tracked=line_f["tracked_ok"],
        full_slam={k[len("full_slam_"):]: v for k, v in line.items()
                   if k.startswith("full_slam_")},
        multiseq_seq_frames_per_sec=line["multiseq_seq_frames_per_sec"],
        launches=dict(vo=vo_launches, faithful=fa_launches,
                      multiseq=ms_launches),
        card=smi)
    print("bench: " + json.dumps(summary), flush=True)

    def finite_positive(value, what):
        check(isinstance(value, (int, float)) and math.isfinite(value)
              and value > 0, f"bench: {what} = {value}")

    check(line["metric"] == "euroc_vo_fps", f"bench: metric {line['metric']}")
    finite_positive(line["value"], "euroc_vo_fps")
    check(line["tracked_ok"] == line["frames"] == 120,
          f"bench: {line['tracked_ok']} of {line['frames']} timed frames "
          f"tracked")
    check(line["keyframes"] >= 1, "bench: no keyframe in the timed frames")
    finite_positive(line["window_ba_ms"], "window_ba_ms")
    for name in ("fps", "fps_min", "vo_control_fps", "traj_len_m"):
        finite_positive(line["full_slam_" + name], "full_slam_" + name)
    for name in ("ate_m", "vo_control_ate_m", "drift_pct"):
        v = line["full_slam_" + name]
        check(math.isfinite(v), f"bench: full_slam_{name} = {v}")
    for name in ("ate_m", "vo_control_ate_m"):
        check(line["full_slam_" + name] < 2 * PANO_ORBIT_RADIUS_M,
              f"bench: full_slam_{name} {line['full_slam_' + name]} m, "
              f"beyond the orbit's diameter")
    finite_positive(line["multiseq_seq_frames_per_sec"],
                    "multiseq_seq_frames_per_sec")
    finite_positive(line_f["value"], "euroc_vo_fps (faithful driver)")
    check(line_f["keyframes"] >= 1, "bench --driver slam: no keyframe")

    vo_frames, vo_kfs = int(res["frames"]), int(res["is_keyframe"].sum())
    check(vo_launches["landmark_top2"] == vo_frames,
          f"bench VO: landmark_top2 launched "
          f"{vo_launches['landmark_top2']} times in {vo_frames} frames")
    check(vo_launches["hamming_top2"] == 2 * vo_kfs,
          f"bench VO: hamming_top2 launched {vo_launches['hamming_top2']} "
          f"times for {vo_kfs} keyframes")
    ms_frames = int(ms_res["frames"])
    ms_kfs = int(ms_res["is_keyframe"].sum())
    check(ms_launches["landmark_top2"] == ms_frames,
          f"bench multi-sequence: landmark_top2 launched "
          f"{ms_launches['landmark_top2']} times in {ms_frames} lockstep "
          f"frames")
    check(ms_launches["hamming_top2"] == 2 * ms_kfs > 0,
          f"bench multi-sequence: hamming_top2 launched "
          f"{ms_launches['hamming_top2']} times for {ms_kfs} keyframes")
    check(fa_launches["landmark_top2"] >= len(fa.stats)
          and fa_launches["hamming_top2"] >= 2 * fa_kfs,
          f"bench --driver slam: launches {fa_launches} in "
          f"{len(fa.stats)} frames, {fa_kfs} keyframes")
    return dict(bench_vo=vo_launches, bench_faithful=fa_launches,
                bench_multiseq=ms_launches)


# ---------------------------------------------------------------------------
# the driver entry points
# ---------------------------------------------------------------------------

# the EuRoC-scale batched step (entry.FULL_WIDTH_STEP) on 8 sequences
ENTRY_FULL_WIDTH_S = 8
ENTRY_FULL_WIDTH_CALLS = 5   # timed, after one untimed


def phase_entry(dev, smi, kernels):
    """The driver entry points on the card (see the module docstring,
    phase 15). Adds the landmark top-2's ``entry_full_width_shape`` to
    ``kernels``. Returns the phase's launches."""
    from vslam_tpu_torch import entry
    from vslam_tpu_torch.solvers import pnp

    # ---- entry(): the card against the CPU port on the same inputs ----
    fn, args = entry.entry(dev)
    fn_c, args_c = entry.entry("cpu")
    idx = pnp.sample_minimal(fn_c(*args_c).match_lm >= 0, 64, 6,
                             torch.Generator().manual_seed(0))
    res_c = fn_c(*args_c, sample_idx=idx)
    full = entry.FULL_WIDTH_STEP
    mesh = entry.data_mesh(ENTRY_FULL_WIDTH_S, dev)
    full_args = entry.multiseq_inputs(ENTRY_FULL_WIDTH_S, full, seed=5,
                                      device=mesh.axis_devices("data")[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with kernel_inputs() as calls:
        t0 = time.perf_counter()
        res_g = fn(*args)             # the bound generator's draws
        res = fn(*args, sample_idx=idx.to(dev))
        torch.cuda.synchronize()
        entry_ms = (time.perf_counter() - t0) * 1e3 / 2
        entry_peak = torch.cuda.max_memory_allocated()
        # ---- dryrun_multichip(8): cold, then warm ----
        dryruns = []
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = entry.dryrun_multichip(8, dev)
            dryruns.append(dict(
                seconds=time.perf_counter() - t0,
                **{k: r[k] for k in r if k.endswith("_ms")},
                initial_cost=float(r["ba"]["initial_cost"]),
                final_cost=float(r["ba"]["final_cost"]),
                loss=float(r["loss"]),
                poses_finite=bool(torch.isfinite(r["poses"]).all()),
                peak_memory_bytes=int(torch.cuda.max_memory_allocated())))
        # ---- the EuRoC-scale batched step (8 x 752x480) ----
        out = entry.multiseq_step(mesh, full_args, full)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        full_ms = []
        for _ in range(ENTRY_FULL_WIDTH_CALLS):
            t0 = time.perf_counter()
            out = entry.multiseq_step(mesh, full_args, full)
            torch.cuda.synchronize()
            full_ms.append((time.perf_counter() - t0) * 1e3)
        full_peak = torch.cuda.max_memory_allocated()
    launches = read_launches()

    def summary(r):
        return dict(num_matches=int(r.num_matches),
                    had_candidate=int(r.had_candidate.sum()),
                    features=int(r.feats.valid.sum()),
                    pose=[round(float(x), 6) for x in r.T_w_c.cpu()])

    pose_err = float((res.T_w_c.cpu() - res_c.T_w_c).abs().max())
    record = dict(
        entry=dict(card=summary(res), cpu=summary(res_c),
                   card_own_draws=summary(res_g), pose_max_abs_err=pose_err,
                   ms_per_call=entry_ms, peak_memory_bytes=int(entry_peak)),
        dryrun_multichip_8=dryruns,
        full_width=dict(S=ENTRY_FULL_WIDTH_S, **dataclasses.asdict(full),
                        median_ms=statistics.median(
            full_ms), ms=full_ms, peak_memory_bytes=int(full_peak),
            num_matches=[int(x) for x in out.num_matches.cpu()],
            poses_finite=bool(torch.isfinite(out.T_w_c).all())),
        launches=launches, card=smi)
    print("driver entry points: " + json.dumps(record), flush=True)

    for name in ("match_lm", "had_candidate", "num_matches", "pnp_ok"):
        check(torch.equal(getattr(res, name).cpu(), getattr(res_c, name)),
              f"entry(): the card's {name} differs from the CPU port's")
    check(torch.equal(res.feats.bits.cpu(), res_c.feats.bits),
          "entry(): the card's descriptors differ from the CPU port's")
    check(pose_err <= 1e-4, f"entry(): pose {pose_err} from the CPU port's")
    check(bool(torch.isfinite(res_g.T_w_c).all()),
          "entry(): the bound draws gave a non-finite pose")
    for d in dryruns:
        check(d["poses_finite"] and math.isfinite(d["loss"])
              and d["final_cost"] <= d["initial_cost"] + 1e-3,
              f"dryrun_multichip(8): {d}")
    check(record["full_width"]["poses_finite"],
          "the 8 x 752x480 batched step gave a non-finite pose")
    # one launch per call: the sequence axis is the kernel's grid y axis
    want = 2 + len(dryruns) + 1 + ENTRY_FULL_WIDTH_CALLS
    check(launches["landmark_top2"] == want
          and launches["hamming_top2"] == 0,
          f"driver entry points: launches {launches}, want landmark_top2 "
          f"{want}")
    checked = check_kernel_inputs(calls, "driver entry points")
    print(f"driver entry points, kernel inputs: {json.dumps(checked)}",
          flush=True)
    time_at_shape(calls, kernels, "entry_full_width_shape",
                  "8 x 752x480 batched step's")
    return launches


def sweep_learned_seeds(dev, seeds, smi):
    """``python3 chip_smoke.py --learned-seeds 0 1 2 ...``: phase 11's two
    learned-VO runs over initialization seeds, in deterministic mode, one
    JSON line per run: the measurement behind the pinned seed."""
    (small, small_frames), (full, full_frames) = learned_worlds()
    with deterministic():
        for seed in seeds:
            for name, (seq, frames, n) in (
                    ("small", (small, small_frames, LEARNED_SMALL_FEATURES)),
                    ("full", (full, full_frames, LEARNED_FULL_FEATURES))):
                model, (l0, l1), secs = train_superpoint(seq, frames, seed,
                                                         dev)
                r = learned_vo(seq, model, n, dev)
                r.update(world=name, init_seed=seed, first_loss=l0,
                         last_loss=l1, train_seconds=secs)
                r.pop("launches")
                r.pop("kernel_calls")
                print("learned seeds: " + json.dumps(r), flush=True)
    print(smi)


def sweep_faithful_seeds(dev, seeds, smi):
    """``python3 chip_smoke.py --faithful-seeds 0 1 2 ...``: the faithful
    driver on phase 7's world over RANSAC seeds, deterministic, the full
    arm beside its control (no loop closure, no relocalization); for the
    first seed also loop closure alone, relocalization alone and the full
    arm without the global BA. One JSON line per run: the keyframe ATE
    every 24 frames, at each closure and at the end, the loops with their
    frames, the global BA's costs, relocalizations, lost frames."""
    from vslam_tpu_torch.pipeline.slam import SlamSystem
    from vslam_tpu_torch.tools import bench_worlds

    n_frames = 288
    seq, voc, make_cfg = bench_worlds.full_slam_world(n_frames, 300, dev)
    images = [(torch.as_tensor(l).to(dev), torch.as_tensor(r).to(dev))
              for l, r in seq.images]

    def run(arm, seed, loop, reloc, gba=True):
        cfg = make_cfg(True, reloc=reloc, lc=loop, gba=loop and gba)
        cfg.seed = seed
        slam = SlamSystem(seq.calib, cfg, device=dev)
        slam.set_vocabulary(voc)
        ate_at, loops, gba_costs = {}, [], []
        t0 = time.perf_counter()
        for f in range(n_frames):
            info = slam.process_frame(*images[f])
            if slam._pending_gba is not None:
                st = slam._pending_gba.stats
                gba_costs.append([float(st["initial_cost"]),
                                  float(st["final_cost"])])
            if info.get("loops_closed"):
                cur, cand = slam.loop_edges[-1]
                loops.append(dict(
                    frame=f, against=int(slam.kf.frame_id[cand]),
                    kf_ate_after_m=round(keyframe_ate(slam, seq), 3)))
            if f % 24 == 23:
                ate_at[f] = round(keyframe_ate(slam, seq), 3)
        r = dict(arm=arm, seed=seed, kf_ate_m=keyframe_ate(slam, seq),
                 keyframes=int(slam.kf.valid.sum()), loops=loops,
                 gba_merges=slam.gba_merges, gba_costs=gba_costs,
                 reloc_ok=sum(ok for _, ok in slam.reloc_events),
                 reloc_attempts=len(slam.reloc_events),
                 lost_frames=[i["frame"] for i in slam.stats if not i["ok"]],
                 kf_ate_at_frame_m=ate_at,
                 seconds=time.perf_counter() - t0, card=smi)
        print("faithful seeds: " + json.dumps(r), flush=True)
        return r["kf_ate_m"]

    ratios = []
    with deterministic():
        for i, seed in enumerate(seeds):
            slam = run("slam", seed, True, True)
            control = run("control", seed, False, False)
            ratios.append(slam / control)
            if i == 0:
                run("loop closure only", seed, True, False)
                run("relocalization only", seed, False, True)
                run("slam without global BA", seed, True, True, gba=False)
    print("faithful seeds: SLAM / control keyframe ATE "
          + json.dumps([round(x, 3) for x in ratios]) + f"; within 1.15 x in "
          f"{sum(x <= 1.15 for x in ratios)} of {len(ratios)}", flush=True)
    print(smi)


def main():
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke test needs "
                         "a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    import vslam_tpu_torch
    from vslam_tpu_torch.ops import cuda_hamming

    check("jax" not in sys.modules, "the port imported jax")
    dev = vslam_tpu_torch.resolve_device("cuda")

    t0 = time.perf_counter()
    lib = cuda_hamming.build()
    print(f"built {lib} in {time.perf_counter() - t0:.1f} s", flush=True)

    if sys.argv[1:2] == ["--faithful-seeds"]:
        sweep_faithful_seeds(dev, [int(x) for x in sys.argv[2:]] or [0], smi)
        return
    if sys.argv[1:2] == ["--learned-seeds"]:
        sweep_learned_seeds(dev, [int(x) for x in sys.argv[2:]] or [0], smi)
        return
    if sys.argv[1:2] == ["--full-slam"]:
        with deterministic():
            phase_full_slam(dev, kept_emitter())
        return

    t_start = time.perf_counter()

    def lap(name):
        print(f"phase {name} done at {time.perf_counter() - t_start:.1f} s "
              f"after the build", flush=True)

    kernels = phase_kernels(dev)
    lap("3 (kernels)")
    launches, vo_summary = phase_main_path(dev)
    lap("4 (VO main path)")
    phase_small_world(dev)
    lap("5 (small world)")
    em = kept_emitter()
    with deterministic():
        drift_launches, _ = phase_injected_drift(dev)
        lap("6 (injected drift)")
        slam_launches, _, world = phase_full_slam(dev, em)
        lap("7 (full SLAM)")
        cli_runs = phase_cli(dev, world)
        lap("8 (command line)")
    phase_large_solvers(dev, smi)
    lap("9 (large-map solvers, sharded and free-intrinsics BA)")
    multiseq_launches, _ = phase_multiseq(dev, smi, vo_summary["fps"])
    lap("10 (multi-sequence)")
    learned_launches = phase_learned(dev, smi, kernels)
    lap("11 (learned frontend, reporting, calibration, relative pose)")
    euroc_launches, euroc_tool_launches = phase_euroc(dev, smi, kernels,
                                                      vo_summary)
    lap("12 (EuRoC: double-sphere, ATE tool, kb4 and eucm)")
    stage_launches, ablation_launches = phase_tools(dev, smi, world)
    lap("13 (measurement tools)")
    del world
    bench_launches = phase_bench(dev, smi, em)
    lap("14 (benchmark program)")
    entry_launches = phase_entry(dev, smi, kernels)
    lap("15 (driver entry points)")
    check("jax" not in sys.modules
          and not any(m.split(".")[0] == "vslam_tpu" for m in sys.modules),
          "the port imported jax or the JAX package")

    source = "vslam_tpu_torch/csrc/hamming_top2.cu"
    replaces = {"landmark_top2": "vslam_tpu/ops/pallas_hamming.py:76",
                "hamming_top2": "vslam_tpu/ops/pallas_hamming.py:30"}
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces[name],
             launches=launches[name],
             launches_injected_drift=drift_launches[name],
             launches_full_slam=slam_launches[name],
             launches_cli_slam=cli_runs["slam"]["launches"][name],
             launches_cli_streaming=cli_runs["streaming"]["launches"][name],
             launches_multiseq=multiseq_launches[name],
             launches_learned_vo=learned_launches[name],
             launches_euroc_ds=euroc_launches[name],
             launches_euroc_ds_tool=euroc_tool_launches[name],
             launches_profile_stages=stage_launches[name],
             launches_ablation=ablation_launches[name],
             **{f"launches_{k}": v[name] for k, v in bench_launches.items()},
             launches_entry=entry_launches[name],
             **kernels[name])
        for name in ("landmark_top2", "hamming_top2")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
