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
   N=M=1500) and at ragged and all-invalid shapes; at the main-path
   shapes, prints the device time per call (``torch.profiler``) of the
   kernel as the main path calls it (descriptor packing included), of the
   kernel alone, and of the plain version, and the time per call with the
   host's share (CUDA events around each call).
4. Runs the port's ``StreamingVO`` at the benchmark's configuration
   (752x480 stereo, 1500 features, 65536 landmarks, 1024 keyframes, 2048
   in-view landmarks, window BA at 24 cameras / 4096 points / 12288
   observations, 256 RANSAC hypotheses) on the benchmark's synthetic VO
   world for 128 frames (8 warm-up), with the launch counters reset just
   before the timed frames, and checks tracking, keyframe ATE and that both
   kernels ran on the main path.
5. Runs the port on the card and on the CPU on a small world and checks
   both against the accuracy bounds of the JAX package's streaming tests.

The last lines are one JSON object describing the kernels, the card's
``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Keyframe ATE of the JAX package's StreamingVO on the benchmark world
# (synthetic.generate(num_frames=128, num_points=1200, width=752,
# height=480, seed=2, speed=3.0)) at the streaming tests' configuration,
# run on the CPU. The port must stay within max(2x this, 0.05 m).
JAX_CPU_KF_ATE_M = 0.027797708416439467

WARMUP_FRAMES = 8


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bench_config(SlamConfig):
    return SlamConfig(
        enable_relocalization=False,
        enable_loop_closure=False,
        max_landmarks=65536,
        max_keyframes=1024,
    )


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


def device_ms(fn, iters=20, only=None):
    """Device milliseconds per call of ``fn``: the summed self device time
    of the kernels and copies it launches, from ``torch.profiler``
    (optionally only kernels whose name contains ``only``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        evt.self_device_time_total for evt in prof.key_averages()
        if evt.device_type == torch.autograd.DeviceType.CUDA
        and (only is None or only in evt.key))
    check(total_us > 0, f"the profiler saw no device time for {only or fn}")
    return total_us / iters / 1e3


def timings(kernel, packed_kernel, plain, args, packed_args, name):
    """Kernel and plain version timed three ways at the same inputs."""
    return dict(
        ms=device_ms(lambda: kernel(*args)),
        plain_ms=device_ms(lambda: plain(*args)),
        kernel_only_ms=device_ms(lambda: packed_kernel(*packed_args),
                                 only=f"{name}_kernel"),
        call_ms=call_ms(lambda: kernel(*args)),
        plain_call_ms=call_ms(lambda: plain(*args)))


def max_abs_err(got, want):
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               if g.numel() else 0 for g, w in zip(got, want))


def hamming_inputs(rng, n, m, dev, valid_frac=0.9, near=False):
    a = rng.randint(0, 2, (n, 256)).astype(np.uint8)
    b = rng.randint(0, 2, (m, 256)).astype(np.uint8)
    if near and m:
        # rows of B that are noisy copies of rows of A: distances well
        # under the match threshold, with ties
        src = rng.randint(0, max(n, 1), m)
        flip = rng.rand(m, 256) < rng.choice([0.02, 0.05, 0.1], (m, 1))
        b = np.where(flip, 1 - a[src], a[src]).astype(np.uint8)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return (t(a), t(b), t(rng.rand(n) < valid_frac),
            t(rng.rand(m) < valid_frac))


def landmark_inputs(rng, n, p, nb, dev, lm_frac=0.9, bank_frac=0.7):
    kp = rng.randint(0, 2, (n, 256)).astype(np.uint8)
    src = rng.randint(0, max(n, 1), (p, nb))
    flip = rng.rand(p, nb, 256) < 0.08
    bank = (np.where(flip, 1 - kp[src], kp[src]).astype(np.uint8)
            if n else rng.randint(0, 2, (p, nb, 256)).astype(np.uint8))
    kxy = (rng.rand(n, 2) * [752, 480]).astype(np.float32)
    # projected landmarks near their source keypoint, some outside the gate
    lxy = (kxy[src[:, 0]] if n else rng.rand(p, 2) * [752, 480]) + \
        rng.normal(0, 15, (p, 2))
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return (t(kp), t(rng.rand(n) < 0.95), t(kxy), t(bank),
            t(rng.rand(p, nb) < bank_frac), t(lxy.astype(np.float32)),
            t(rng.rand(p) < lm_frac), 20.0)


def phase_kernels(dev):
    from vslam_tpu_torch.ops import cuda_hamming, describe, hamming

    rng = np.random.RandomState(0)
    report = {}

    # ---- K2: descriptor top-2 ----
    cases = [(1500, 1500, 0.9, True), (1500, 1500, 0.9, False),
             (130, 600, 0.9, False), (1, 129, 0.5, True),
             (257, 0, 0.9, False), (64, 64, 0.0, False)]
    err = 0
    for n, m, vf, near in cases:
        args = hamming_inputs(rng, n, m, dev, vf, near)
        got = cuda_hamming.hamming_top2(*args)
        want = hamming.hamming_top2_plain(*args)
        e = max_abs_err(got, want)
        check(e == 0, f"hamming_top2 differs from its plain version at "
                      f"N={n} M={m} (max abs err {e})")
        err = max(err, e)
    # all-invalid candidates give the reference's 256 init
    a, b, va, _ = hamming_inputs(rng, 32, 64, dev)
    best = cuda_hamming.hamming_top2(a, b, va, torch.zeros_like(b[:, 0],
                                                                dtype=bool))[0]
    check(int(best.min()) == 256, "hamming_top2 all-invalid case")
    main = hamming_inputs(rng, 1500, 1500, dev, 0.95, True)
    packed = (describe.pack_bits(main[0]), describe.pack_bits(main[1]),
              *main[2:])
    report["hamming_top2"] = dict(max_abs_err=err, **timings(
        cuda_hamming.hamming_top2, cuda_hamming.hamming_top2_packed,
        hamming.hamming_top2_plain, main, packed, "hamming_top2"))

    # ---- K1: landmark top-2 ----
    cases = [(1500, 2048, 4, 0.9, 0.7), (1500, 2048, 4, 1.0, 1.0),
             (100, 300, 4, 0.9, 0.8), (129, 513, 3, 0.5, 0.5),
             (7, 0, 4, 0.9, 0.7), (64, 256, 4, 0.0, 0.7),
             (64, 256, 4, 0.9, 0.0)]
    err = 0
    for n, p, nb, lf, bf in cases:
        args = landmark_inputs(rng, n, p, nb, dev, lf, bf)
        got = cuda_hamming.landmark_top2(*args)
        want = hamming.landmark_top2_plain(*args)
        e = max_abs_err(got, want)
        check(e == 0, f"landmark_top2 differs from its plain version at "
                      f"N={n} P={p} B={nb} (max abs err {e})")
        err = max(err, e)
    main = landmark_inputs(rng, 1500, 2048, 4, dev)
    packed = (describe.pack_bits(main[0]), *main[1:3],
              describe.pack_bits(main[3]), *main[4:])
    report["landmark_top2"] = dict(max_abs_err=err, **timings(
        cuda_hamming.landmark_top2, cuda_hamming.landmark_top2_packed,
        hamming.landmark_top2_plain, main, packed, "landmark_top2"))
    torch.cuda.synchronize()
    for name, r in report.items():
        print(f"kernel {name}: exact vs plain at main-path shapes; device "
              f"{r['ms']:.4f} ms per call with packing, "
              f"{r['kernel_only_ms']:.4f} ms kernel alone (plain "
              f"{r['plain_ms']:.4f} ms); per call with host "
              f"{r['call_ms']:.4f} ms (plain {r['plain_call_ms']:.4f} ms)",
              flush=True)
    return report


def phase_main_path(dev):
    from vslam_tpu_torch import synthetic
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.eval import ate
    from vslam_tpu_torch.ops import cuda_hamming
    from vslam_tpu_torch.pipeline.streaming import StreamingVO

    t0 = time.perf_counter()
    seq = synthetic.generate(num_frames=128, num_points=1200, width=752,
                             height=480, seed=2, speed=3.0)
    print(f"world: {len(seq.images)} frames 752x480 generated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    frames = [(torch.as_tensor(l).to(dev), torch.as_tensor(r).to(dev))
              for l, r in seq.images]
    vo = StreamingVO(seq.calib, bench_config(SlamConfig),
                     max_frames=len(frames), device=dev)
    vo.run(frames[:WARMUP_FRAMES])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in cuda_hamming.LAUNCHES:
        cuda_hamming.LAUNCHES[name] = 0
    ms = []
    for img_l, img_r in frames[WARMUP_FRAMES:]:
        t = time.perf_counter()
        vo.process_frame(img_l, img_r)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    launches = dict(cuda_hamming.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    res = vo.results()
    n_timed = len(frames) - WARMUP_FRAMES
    kfs_timed = int(res["is_keyframe"][WARMUP_FRAMES:].sum())
    tracked_timed = int(res["tracked_ok"][WARMUP_FRAMES:].sum())
    fids, pos, _ = vo.keyframe_trajectory()
    kf_ate = ate.align_svd(pos, seq.poses[fids, :3])[2]
    full_ate = ate.align_svd(res["trajectory"][:, :3],
                             seq.poses[:len(frames), :3])[2]
    kf_ms = [t for t, k in zip(ms, res["is_keyframe"][WARMUP_FRAMES:]) if k]
    tr_ms = [t for t, k in zip(ms, res["is_keyframe"][WARMUP_FRAMES:])
             if not k]
    summary = dict(
        frames=int(res["frames"]), timed_frames=n_timed,
        keyframes=int(res["is_keyframe"].sum()),
        keyframes_timed=kfs_timed, tracked_timed=tracked_timed,
        tracked_after_bootstrap=int(res["tracked_ok"][1:].sum()),
        kf_ate_m=float(kf_ate), full_ate_m=float(full_ate),
        median_ms_per_frame=statistics.median(ms),
        median_ms_tracking_frame=statistics.median(tr_ms) if tr_ms else None,
        median_ms_keyframe=statistics.median(kf_ms) if kf_ms else None,
        max_ms_per_frame=max(ms),
        max_memory_allocated_bytes=int(peak),
        launches=launches,
        window_obs_dropped_max=int(res["window_obs_dropped"].max()))
    print("main path: " + json.dumps(summary), flush=True)

    traj = res["trajectory"]
    check(traj.shape == (len(frames), 7) and np.isfinite(traj).all(),
          "trajectory is not finite")
    check(bool(res["tracked_ok"][1:].all()),
          f"tracking lost after bootstrap: "
          f"{np.flatnonzero(~res['tracked_ok'][1:]) + 1}")
    check(launches["landmark_top2"] == n_timed,
          f"landmark_top2 launched {launches['landmark_top2']} times in "
          f"{n_timed} frames")
    check(launches["hamming_top2"] == 2 * kfs_timed,
          f"hamming_top2 launched {launches['hamming_top2']} times for "
          f"{kfs_timed} keyframes")
    check(kfs_timed > 0, "no keyframe in the timed frames")
    bound = max(2.0 * JAX_CPU_KF_ATE_M, 0.05)
    check(kf_ate <= bound, f"keyframe ATE {kf_ate:.4f} m > {bound:.4f} m")
    return launches, summary


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

    kernels = phase_kernels(dev)
    launches, _ = phase_main_path(dev)
    phase_small_world(dev)
    check("jax" not in sys.modules, "the port imported jax")

    source = "vslam_tpu_torch/csrc/hamming_top2.cu"
    replaces = {"landmark_top2": "vslam_tpu/ops/pallas_hamming.py:76",
                "hamming_top2": "vslam_tpu/ops/pallas_hamming.py:30"}
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces[name],
             launches=launches[name], **kernels[name])
        for name in ("landmark_top2", "hamming_top2")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
