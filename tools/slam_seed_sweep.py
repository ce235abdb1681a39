"""Seed sweeps of SLAM scenarios, for the JAX package or the port.

    python tools/slam_seed_sweep.py --backend torch --device cuda --seeds 0 1 2
    JAX_PLATFORMS=cpu python tools/slam_seed_sweep.py --backend jax --seeds 0 1
    python tools/slam_seed_sweep.py --scenario faithful --backend torch \
        --device cpu --seeds 0 1 2 3 4 5

``--scenario injected`` (the default) is the injected-drift scenario of
tests/test_streaming_slam.py (``chip_smoke.py`` phase 6).

For each RANSAC seed (``SlamConfig.seed``) it runs three arms on the pano
revisit world (``generate_pano_loop(num_frames=256, revolutions=1.75,
seed=2)``, the test's ``pano_config``): clean VO, VO with the drift crept
into the live gauge over frames 110-150, and StreamingSLAM (GBA after
loop on) with the same injection. It prints one JSON line per run
(keyframe ATE, loops with their frames, GBA merges, tracked share) and a
summary line with the bars of the JAX test evaluated per seed. The world
is chaotic: a seed's outcome says little, the spread over seeds says how
far a single run can be trusted. The torch backend imports no JAX.

``--scenario faithful`` runs the faithful driver (``SlamSystem``) with loop
closure, relocalization and the global BA against its ``--no-loop
--no-reloc`` control, at ``chip_smoke.py`` phase 8's configuration
(``bench.full_slam_world``'s: 300 features, 4 observations per landmark
in the window BA) on a reduced pano world,
``generate_pano_loop(num_frames=288, width=320, height=240,
revolutions=1.75, seed=2)``; each package trains its vocabulary (k=10,
depth 4) on its own features of every 12th frame. One JSON line per run
(keyframe ATE, loops with their frames, GBA merges, relocalizations,
lost frames) and a summary of the SLAM / control ratios per seed.

``--scenario bench`` runs the bench's full SLAM (``bench.bench_full_slam``'s
run: ``StreamingSLAM`` on ``full_slam_world``, 288 frames at 752x480,
``poll_every=32`` (the JAX package's with ``chunk=8``), the first 32
frames then a poll, then the rest and a last merge of a pending global
BA). One JSON line per seed: loops with
their frames, GBA merges, relocalization attempts and successes (with
each attempt's diagnostics: candidates, best inliers, motion gate and the
best gate error), lost frames, keyframe ATE, the loop detector's counters and the rejected
candidates (current and candidate keyframe's frames, inliers, visible; a
negative visible count is an identity-gain rejection). ``--loop-trace
FIRST LAST`` adds the loop detector's queries in those frames
(``trace_loop_queries``): a loop is accepted only where four keyframe
queries in a row have candidates whose covisibility groups overlap.
``--replay-reloc`` adds every relocalization attempt solved by both
packages on its state with the same draws (``replay_relocalization``;
imports both packages). ``--schedule lagged`` runs the port on
``bench.py``'s lagged poll schedule (``lagged_slam``). ``--summarize FILE
...`` reads such lines back and prints the rates of each package and the
tests between them (``summarize``).

``--scenario camera`` runs ``StreamingVO`` at the bench's VO configuration
on ``chip_smoke.py`` phase 12's world (``synthetic.generate(num_frames=128,
num_points=1200, width=752, height=480, seed=2, speed=3.0)``) through the
double-sphere and the pinhole camera: one JSON line per camera and seed
(keyframe ATE, keyframes, tracked share) and a summary of the ds / pinhole
ATE ratio per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def torch_backend(device):
    import torch

    import chip_smoke as cs
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.pipeline.streaming import StreamingSLAM, StreamingVO
    from vslam_tpu_torch.synthetic_pano import generate_pano_loop

    dev = torch.device(device)
    seq = generate_pano_loop(num_frames=256, revolutions=1.75, seed=2)
    images = [(torch.as_tensor(l).to(dev), torch.as_tensor(r).to(dev))
              for l, r in seq.images]
    voc = cs.train_vocabulary(seq.images, range(0, 256, 8), 600, dev)

    def make(arm, seed):
        cfg = cs.pano_config(SlamConfig)
        cfg.seed = seed
        if arm == "slam":
            cfg.enable_gba_after_loop = True
            return StreamingSLAM(seq.calib, cfg, voc, max_frames=288,
                                 poll_every=16, device=dev)
        cfg.enable_loop_closure = False
        return StreamingVO(seq.calib, cfg, max_frames=288, device=dev)

    def run(drv, inject):
        if inject:
            cs.run_with_injection(drv, images, dev)
        else:
            drv.run(images)

    return seq, make, run, lambda drv: cs.keyframe_ate(drv, seq)


def jax_backend():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import jax

    import test_streaming_slam as T
    from vslam_tpu.pipeline.streaming import StreamingSLAM, StreamingVO

    seq, voc = T.pano.__wrapped__()

    def make(arm, seed):
        cfg = T.pano_config()
        cfg.seed = seed
        if arm == "slam":
            cfg.enable_gba_after_loop = True
            return StreamingSLAM(seq.calib, cfg, voc, max_frames=288,
                                 poll_every=16)
        cfg.enable_loop_closure = False
        return StreamingVO(seq.calib, cfg, max_frames=288)

    def run(drv, inject):
        if inject:
            T._run_with_injection(drv, seq)
        else:
            drv.run(seq.images)
            jax.block_until_ready(drv.state.frame)

    return seq, make, run, lambda drv: float(T._keyframe_ate(drv, seq))


FAITHFUL_WORLD = dict(num_frames=288, width=320, height=240,
                      revolutions=1.75, seed=2)


def faithful_torch(device):
    import torch

    import chip_smoke as cs
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.pipeline.slam import SlamSystem
    from vslam_tpu_torch.synthetic_pano import generate_pano_loop

    dev = torch.device(device)
    seq = generate_pano_loop(**FAITHFUL_WORLD)
    images = [(torch.as_tensor(l).to(dev), torch.as_tensor(r).to(dev))
              for l, r in seq.images]
    n = len(images)
    voc = cs.train_vocabulary(seq.images, range(0, n, n // 24), 300, dev)

    def make(cfg):
        slam = SlamSystem(seq.calib, cfg, device=dev)
        slam.set_vocabulary(voc)
        return slam

    return (lambda: cs.full_slam_config(SlamConfig, True), make, images,
            lambda drv: cs.keyframe_ate(drv, seq))


def faithful_jax():
    import jax.numpy as jnp

    import chip_smoke as cs
    from vslam_tpu.config import SlamConfig
    from vslam_tpu.eval import ate
    from vslam_tpu.frontend.features import extract_features
    from vslam_tpu.loop import vocabulary as vocab_mod
    from vslam_tpu.pipeline.slam import SlamSystem
    from vslam_tpu.synthetic_pano import generate_pano_loop

    seq = generate_pano_loop(**FAITHFUL_WORLD)
    n = len(seq.images)
    pool = []
    for f in range(0, n, n // 24):
        ft = extract_features(jnp.asarray(seq.images[f][0]),
                              num_features=300, quality_level=0.001)
        pool.append(np.asarray(ft.bits)[np.asarray(ft.valid)])
    voc = vocab_mod.train(np.concatenate(pool), k=10, depth=4, seed=0)
    vocab_mod.set_idf_weights(voc, pool)

    def make(cfg):
        slam = SlamSystem(seq.calib, cfg)
        slam.set_vocabulary(voc)
        return slam

    def kf_ate(drv):
        fids, pos, _ = drv.keyframe_trajectory()
        return float(ate.align_svd(pos, seq.poses[fids, :3])[2])

    return (lambda: cs.full_slam_config(SlamConfig, True), make,
            seq.images, kf_ate)


def sweep_faithful(args, where):
    """The faithful driver against its control over ``args.seeds``."""
    if args.backend == "torch":
        config, make, images, kf_ate = faithful_torch(args.device)
    else:
        config, make, images, kf_ate = faithful_jax()
    ratios = {}
    for seed in args.seeds:
        ate_of = {}
        for arm in ("slam", "control"):
            cfg = config()
            cfg.seed = seed
            if arm == "control":
                cfg.enable_loop_closure = False
                cfg.enable_relocalization = False
                cfg.enable_gba_after_loop = False
            drv = make(cfg)
            t0 = time.perf_counter()
            for img_l, img_r in images:
                drv.process_frame(img_l, img_r)
            ate_of[arm] = kf_ate(drv)
            fid = drv.kf.frame_id
            fid = np.asarray(fid.cpu() if hasattr(fid, "cpu") else fid)
            events = getattr(drv, "reloc_events", None)  # the port's only
            row = dict(
                scenario="faithful", backend=args.backend, device=where,
                seed=seed, arm=arm, kf_ate_m=ate_of[arm],
                keyframes=len(drv.slot_of_frame),
                loop_frames=[[int(fid[a]), int(fid[b])]
                             for a, b in drv.loop_edges],
                gba_merges=int(drv.gba_merges),
                reloc_ok=None if events is None else
                sum(bool(ok) for _, ok in events),
                reloc_attempts=None if events is None else len(events),
                lost_frames=int(sum(not s["ok"] for s in drv.stats)),
                seconds=time.perf_counter() - t0)
            print(json.dumps(row), flush=True)
        ratios[seed] = ate_of["slam"] / ate_of["control"]
    r = np.asarray(list(ratios.values()))
    print(json.dumps(dict(
        scenario="faithful", backend=args.backend, device=where,
        slam_over_control={str(k): round(v, 3) for k, v in ratios.items()},
        median=float(np.median(r)), min=float(r.min()), max=float(r.max()),
        within_1_15=int((r <= 1.15).sum()), seeds=len(r))), flush=True)


LAG_CHUNK = 8   # bench.bench_full_slam's chunk


def lagged_slam():
    """The port's ``StreamingSLAM`` reading its keyframe events and loss
    log on ``bench.bench_full_slam``'s schedule instead of its own: at
    every ``LAG_CHUNK``-frame boundary it takes what the previous boundary
    had logged, and polls the current state at once where that showed a
    sustained loss (the JAX driver's lagged poll with its consume stride
    at 1, ``vslam_tpu/pipeline/streaming.py:846-895``), then at every
    boundary while lost. The port's own ``run`` reads the loss log after
    every frame."""
    from vslam_tpu_torch.pipeline.streaming import StreamingSLAM

    class LaggedSLAM(StreamingSLAM):
        _lag = None

        def _poll_at(self, n, stale=False):
            """``poll`` of the first ``n`` frames' events and loss log; a
            ``stale`` one attempts no recovery but returns True where it
            would have (the caller then polls the current state)."""
            ok_log = self.state.log_ok[:n].cpu().numpy()
            while (self._ev_consumed < len(self.events)
                   and self.events[self._ev_consumed].frame < n):
                e = self.events[self._ev_consumed]
                self._ev_consumed += 1
                if int(e.slot) >= 0 and int(e.slot) not in self.frame_of_slot:
                    self._handle_keyframe(e.frame, int(e.slot),
                                          e.words.cpu().numpy(),
                                          e.covis.cpu().numpy())
            R = self.cfg.reloc_lost_frames
            if not stale and self.cfg.enable_relocalization:
                self._lost_mode = bool(
                    n > 0 and not ok_log[max(0, n - R):n].any())
            if n > 0 and ok_log[n - 1]:
                self._reloc_failures = 0
                self._reloc_next_attempt = 0
            if (self.cfg.enable_relocalization and self.detector.db.bow_of
                    and n >= R and not ok_log[n - R:n].any()
                    and n >= self._reloc_next_attempt):
                if stale:
                    self._merge_gba_if_ready()
                    return True
                oks = np.nonzero(ok_log[:n])[0]
                self._try_relocalize_stream(
                    n, int(n - 1 - oks[-1]) if len(oks) else n)
            self._merge_gba_if_ready()
            return False

        def _now(self):
            return min(self.state.frame, self.max_frames)

        def run(self, frames):
            C = LAG_CHUNK
            groups = len(frames) // C
            for g in range(groups):
                for img_l, img_r in frames[g * C:(g + 1) * C]:
                    self.process_frame(img_l, img_r)
                prev, self._lag = self._lag, self._now()
                if (prev is not None and not self._lost_mode
                        and self._poll_at(prev, stale=True)):
                    self._poll_at(self._now())
                if self._lost_mode:
                    self._poll_at(self._now())
            for img_l, img_r in frames[groups * C:]:
                self.process_frame(img_l, img_r)
            self.poll()
            return len(frames)

        def poll(self):
            if self._lag is not None:
                self._poll_at(self._lag, stale=True)
                self._lag = None
            self._poll_at(self._now())

    return LaggedSLAM


def bench_world(backend, device, schedule="frame"):
    """(seq, make(seed), run(driver)) of the bench's full-SLAM run;
    ``schedule="lagged"`` gives the port ``lagged_slam``'s driver."""
    if backend == "torch":
        from vslam_tpu_torch.pipeline.streaming import StreamingSLAM
        from vslam_tpu_torch.tools.bench_worlds import full_slam_world

        if schedule == "lagged":
            StreamingSLAM = lagged_slam()   # noqa: N806

        seq, voc, make_cfg = full_slam_world(288, 300, device)
        frames, kw = seq.images, dict(device=device)
    else:
        import bench
        from vslam_tpu.pipeline.streaming import StreamingSLAM

        seq, frames, voc, make_cfg = bench.full_slam_world(288, 300)
        # bench.bench_full_slam's dispatch: 8 frames a step, the loss log
        # read at every chunk boundary (the port reacts after every frame)
        kw = dict(chunk=8)

    def make(seed):
        cfg = make_cfg(True)
        cfg.seed = seed
        return StreamingSLAM(seq.calib, cfg, voc, max_frames=296,
                             poll_every=32, **kw)

    def run(drv):
        drv.run(frames[:32])
        drv.poll()
        drv.run(frames[32:])
        if backend == "torch":
            drv._merge_gba_if_ready()
        else:
            drv._merge_gba_if_ready(force=drv._pending_gba is not None)
        drv.results()   # waits for the stream

    return seq, make, run


def trace_loop_queries(drv):
    """Wraps ``drv``'s loop detector so that every keyframe query appends
    to the returned list: its frame, the minimum score over its strongly
    covisible keyframes (``min_score``, 1.0 where it has none), their
    count and the largest covisibility weight, the three best L1 scores over the database's keyframes outside
    its covisibility graph (score, frame, shared words; ``max_shared`` is
    the most shared words of any), the candidates, the consistent ones and
    the consistency groups after the query (frames, count), by frame."""
    from vslam_tpu_torch.loop.vocabulary import l1_score

    det = drv.detector
    inner_candidates, inner_detect = det.detect_candidates, det.detect
    log = []

    def frame(slot):
        return int(drv.frame_of_slot.get(slot, -1))

    def detect_candidates(new_slot, new_bow, covis, graph, min_score,
                          essential_threshold=30):
        out = inner_candidates(new_slot, new_bow, covis, graph, min_score,
                               essential_threshold)
        connected = set(graph.get(new_slot, ()))
        counts = det.db.shared_word_counts(new_bow, exclude=connected)
        best = sorted(((l1_score(new_bow, det.db.bow_of[s]), s)
                       for s in counts), reverse=True)[:3]
        log.append(dict(
            frame=frame(new_slot), min_score=round(min_score, 4),
            strong=sum(w > 2 * drv.cfg.num_cov_threshold
                       for w in covis.values()),
            covis_max=max(covis.values(), default=0),
            connected=len(connected),
            best=[[round(sc, 4), frame(s), int(counts[s])]
                  for sc, s in best],
            max_shared=max(counts.values(), default=0),
            candidates=[frame(c) for c in out]))
        return out

    def detect(*a, **k):
        n = len(log)
        out = inner_detect(*a, **k)
        if len(log) > n:
            log[-1]["consistent"] = [frame(c) for c in out]
            log[-1]["groups"] = [[sorted(frame(s) for s in g), k]
                                 for g, k in det.consistent_groups]
        return out

    det.detect_candidates, det.detect = detect_candidates, detect
    return log


def replay_relocalization(backend):
    """Wraps the running package's ``relocalize`` so that every attempt is
    also solved by both packages' ``relocalize`` on that attempt's state
    (fresh detectors over its database), with the same JAX draws: the
    attempt's own key in a JAX run, key 1000 + i in a port run. The run
    goes on with its own result. Returns the list each attempt appends to:
    both diagnostics, and how many of the DLT hypotheses
    (``pnp._dlt_pose``) of the JAX replay's PnP calls come out non-finite
    (their Cholesky factorization failed; ``ransac_pnp`` zeroes them) in
    JAX only, in the port only and in both, of how many."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import torch

    from vslam_tpu.core import state as jstate
    from vslam_tpu.loop import detector as jdet
    from vslam_tpu.loop import relocalize as jreloc
    from vslam_tpu.solvers import pnp as jpnp
    from vslam_tpu_torch import interop
    from vslam_tpu_torch.core import state as tstate
    from vslam_tpu_torch.loop import detector as tdet
    from vslam_tpu_torch.loop import relocalize as treloc
    from vslam_tpu_torch.solvers import pnp as tpnp

    log, calls = [], []
    inner_j, inner_t, jax_pnp = (jreloc.relocalize, treloc.relocalize,
                                 jpnp.ransac_pnp)

    def recording_pnp(key, points, bearings, valid, threshold,
                      num_hypotheses=256, **kw):
        calls.append((key, np.asarray(points), np.asarray(bearings),
                      np.asarray(valid), num_hypotheses))
        return jax_pnp(key, points, bearings, valid, threshold,
                       num_hypotheses=num_hypotheses, **kw)

    class Draws:
        """The port's sampler handing out the JAX replay's draws."""

        def __init__(self, key):
            self.key = key

        def __call__(self, valid, num_hypotheses):
            self.key, k = jax.random.split(self.key)
            return torch.as_tensor(np.array(jpnp._sample_minimal(
                k, jnp.asarray(valid.cpu().numpy()), num_hypotheses, 6)))

    def nonfinite():
        n = np.zeros(4, int)
        for key, P, B, V, H in calls:
            idx = np.asarray(jpnp._sample_minimal(key, jnp.asarray(V), H, 6))
            Rj, _ = jax.vmap(jpnp._dlt_pose)(jnp.asarray(P[idx]),
                                             jnp.asarray(B[idx]))
            Rt, _ = tpnp._dlt_pose(torch.as_tensor(P[idx]),
                                   torch.as_tensor(B[idx]))
            fj = ~np.isfinite(np.asarray(Rj)).reshape(H, -1).all(1)
            ft = ~torch.isfinite(Rt).reshape(H, -1).all(1).numpy()
            n += [(fj & ~ft).sum(), (ft & ~fj).sum(), (fj & ft).sum(), H]
        return dict(zip(("jax_only", "port_only", "both", "of"),
                        n.tolist()))

    def both(kf, lm, bow_of, arrays, bow, graph, cam, mt, thr, key, kw):
        """arrays: bits, valid, corners, cur_pose, vel, intr0 (numpy)."""
        kf_j = jstate.KeyframeState(**{k: jnp.asarray(v)
                                       for k, v in kf.items()})
        lm_j = jstate.LandmarkState(**{k: jnp.asarray(v)
                                       for k, v in lm.items()})
        kf_t = interop.from_arrays(tstate.KeyframeState, kf, "cpu")
        lm_t = interop.from_arrays(tstate.LandmarkState, lm, "cpu")
        dj, dt = jdet.LoopDetector(), tdet.LoopDetector()
        for slot, b in bow_of.items():
            dj.db.insert(slot, b)
            dt.db.insert(slot, b)
        calls.clear()
        jpnp.ransac_pnp = recording_pnp
        try:
            okj, _, _, diag_j = inner_j(
                kf_j, lm_j, dj, *[jnp.asarray(a) for a in arrays[:3]], bow,
                graph, *[jnp.asarray(a) for a in arrays[3:]], cam, mt, thr,
                key, **kw)
        finally:
            jpnp.ransac_pnp = jax_pnp
        okt, _, _, diag_t = inner_t(
            kf_t, lm_t, dt, *[torch.as_tensor(a) for a in arrays[:3]], bow,
            graph, *[torch.as_tensor(a) for a in arrays[3:]], cam, mt, thr,
            sampler=Draws(key), **kw)
        keys = ("candidates", "best_n", "best_gate_err", "gate")
        log.append(dict(
            jax=dict(ok=bool(okj), **{k: diag_j[k] for k in keys}),
            port=dict(ok=bool(okt), **{k: diag_t[k] for k in keys}),
            nonfinite_hypotheses=nonfinite()))

    if backend == "jax":
        def wrapped(kf, lm, detector, bits, valid, corners, bow, graph, cur,
                    vel, intr0, cam, mt, thr, key, **kw):
            both({k: np.asarray(v) for k, v in kf._asdict().items()},
                 {k: np.asarray(v) for k, v in lm._asdict().items()},
                 detector.db.bow_of,
                 [np.array(a) for a in (bits, valid, corners, cur, vel,
                                        intr0)],
                 bow, graph, cam, mt, thr, key, kw)
            return inner_j(kf, lm, detector, bits, valid, corners, bow,
                           graph, cur, vel, intr0, cam, mt, thr, key, **kw)

        jreloc.relocalize = wrapped
    else:
        def host(x):
            return x.detach().cpu().numpy()

        def wrapped(kf, lm, detector, bits, valid, corners, bow, graph, cur,
                    vel, intr0, cam, mt, thr, generator=None, **kw):
            both({f.name: host(getattr(kf, f.name))
                  for f in dataclasses.fields(kf)},
                 {f.name: host(getattr(lm, f.name))
                  for f in dataclasses.fields(lm)},
                 detector.db.bow_of,
                 [host(a) for a in (bits, valid, corners, cur, vel, intr0)],
                 bow, graph, cam, mt, thr,
                 jax.random.PRNGKey(1000 + len(log)), kw)
            return inner_t(kf, lm, detector, bits, valid, corners, bow,
                           graph, cur, vel, intr0, cam, mt, thr, generator,
                           **kw)

        treloc.relocalize = wrapped
    return log


def sweep_bench(args, where):
    """The bench's full SLAM over ``args.seeds``; with ``--loop-trace``
    each line also holds ``trace_loop_queries``'s records of the queries
    in frames ``args.loop_trace``."""
    from vslam_tpu_torch.eval import ate

    seq, make, run = bench_world(args.backend, args.device, args.schedule)
    replays = replay_relocalization(args.backend) if args.replay_reloc \
        else None
    for seed in args.seeds:
        drv = make(seed)
        queries = trace_loop_queries(drv) if args.loop_trace else None
        if replays is not None:
            replays.clear()
        t0 = time.perf_counter()
        run(drv)
        fids, pos, _ = drv.keyframe_trajectory()
        ok = np.asarray(drv.results()["tracked_ok"])
        print(json.dumps(dict(
            scenario="bench", backend=args.backend, device=where, seed=seed,
            kf_ate_m=float(ate.align_svd(pos, seq.poses[fids, :3])[2]),
            keyframes=int(len(fids)),
            loop_frames=[[int(drv.frame_of_slot[a]),
                          int(drv.frame_of_slot[b])]
                         for a, b in drv.loop_edges],
            gba_merges=int(drv.gba_merges),
            reloc_attempts=len(drv.reloc_events),
            reloc_ok=sum(bool(o) for _, o in drv.reloc_events),
            reloc_frames=[int(f) for f, _ in drv.reloc_events],
            reloc_diags=drv.reloc_diags,
            lost_frames=int((~ok[1:]).sum()),
            loop_stats=dict(drv.loop_stats),
            rejected_loops=[[int(drv.frame_of_slot[a]),
                             int(drv.frame_of_slot[b]), int(n), int(v)]
                            for a, b, n, v in drv.rejected_loops],
            **({} if queries is None else dict(loop_queries=[
                q for q in queries
                if args.loop_trace[0] <= q["frame"] <= args.loop_trace[1]
            ])),
            **({} if replays is None else dict(reloc_replays=list(replays))),
            schedule="chunk8" if args.backend == "jax" else args.schedule,
            seconds=time.perf_counter() - t0)), flush=True)


REVISIT = (160, 215)   # the bench world's first revisit, in frames


def summarize(paths):
    """One JSON line per (backend, schedule) over the ``--scenario bench``
    lines in ``paths``: runs, runs that close a loop, those that close in
    the first revisit (``REVISIT``), the median closure frame,
    relocalization attempts and accepted ones (where the lines carry the
    attempts' diagnostics: those whose best PnP had under 10 inliers, those
    over the motion gate, and how many frames lost each came), and (from
    ``--loop-trace``)
    the loop queries in the first revisit: per run, the share with
    candidates, the share with candidates after a query with candidates,
    the share with no strongly covisible keyframe, the median minimum and
    best scores; from ``--replay-reloc``, the attempts whose two replays
    gave the same result, each package's accepted ones and the non-finite
    DLT hypotheses. Then, for each port schedule against the JAX runs, the
    two-sided Fisher test of first-revisit closures and of accepted
    relocalizations, and the Mann-Whitney test of the closure frames."""
    from scipy import stats

    groups = {}
    for path in paths:
        with open(path) as fh:
            for line in fh:
                d = json.loads(line) if line.startswith("{") else {}
                if d.get("scenario") == "bench" and "seed" in d:
                    key = (d["backend"], "chunk8" if d["backend"] == "jax"
                           else d.get("schedule", "frame"))
                    groups.setdefault(key, {})[d["seed"]] = d
    out = {}
    lo, hi = REVISIT
    for (backend, schedule), runs in sorted(groups.items()):
        first = [d["loop_frames"][0][0] for d in runs.values()
                 if d["loop_frames"]]
        rec = dict(backend=backend, schedule=schedule, runs=len(runs),
                   closed=len(first),
                   closed_in_first_revisit=sum(f < hi for f in first),
                   median_closure_frame=float(np.median(first)),
                   closure_frames=sorted(first),
                   reloc_attempts=sum(d["reloc_attempts"]
                                      for d in runs.values()),
                   reloc_accepted=sum(d["reloc_ok"] for d in runs.values()))
        diags = [x for d in runs.values() for x in d.get("reloc_diags", ())]
        if diags:
            rec["reloc_diagnosed"] = dict(
                attempts=len(diags),
                no_pose=sum(x["best_n"] < 10 for x in diags),
                over_gate=sum(x["best_gate_err"] is not None
                              and "T_wc" not in x for x in diags),
                frames_lost=sorted(x["frames_lost"] for x in diags))
        traced = [d for d in runs.values() if "loop_queries" in d]
        if traced:
            seqs = [[q for q in d["loop_queries"] if lo <= q["frame"] < hi]
                    for d in traced]
            qs = [q for seq in seqs for q in seq]
            pairs = [(a, b) for seq in seqs for a, b in zip(seq, seq[1:])
                     if a["candidates"]]
            rec["first_revisit_queries"] = dict(
                per_run=len(qs) / len(traced),
                with_candidates=float(np.mean([bool(q["candidates"])
                                               for q in qs])),
                with_candidates_after_candidates=float(np.mean(
                    [bool(b["candidates"]) for _, b in pairs])),
                no_strong_neighbour=float(np.mean([q["strong"] == 0
                                                   for q in qs])),
                median_min_score=float(np.median(
                    [q["min_score"] for q in qs if q["min_score"] < 1])),
                median_best_score=float(np.median(
                    [q["best"][0][0] for q in qs if q["best"]])))
        replays = [r for d in runs.values() for r in d.get("reloc_replays",
                                                            ())]
        if replays:
            def same(a, b):
                ea, eb = a["best_gate_err"], b["best_gate_err"]
                return (a["ok"] == b["ok"] and a["best_n"] == b["best_n"]
                        and a["candidates"] == b["candidates"]
                        and (ea is None) == (eb is None)
                        and (ea is None or abs(ea - eb) <= 2e-3))

            rec["reloc_replays"] = dict(
                attempts=len(replays),
                same_result=sum(same(r["jax"], r["port"]) for r in replays),
                accepted_jax=sum(r["jax"]["ok"] for r in replays),
                accepted_port=sum(r["port"]["ok"] for r in replays),
                **{k: sum(r["nonfinite_hypotheses"][k] for r in replays)
                   for k in ("jax_only", "port_only", "both", "of")})
        out[backend, schedule] = rec
        print(json.dumps(rec), flush=True)
    ref = next((r for (b, _), r in out.items() if b == "jax"), None)
    for (backend, schedule), rec in out.items():
        if backend != "torch" or ref is None:
            continue
        print(json.dumps(dict(
            port_schedule=schedule,
            fisher_first_revisit_p=stats.fisher_exact(
                [[ref["closed_in_first_revisit"],
                  ref["runs"] - ref["closed_in_first_revisit"]],
                 [rec["closed_in_first_revisit"],
                  rec["runs"] - rec["closed_in_first_revisit"]]])[1],
            fisher_reloc_accepted_p=stats.fisher_exact(
                [[ref["reloc_accepted"],
                  ref["reloc_attempts"] - ref["reloc_accepted"]],
                 [rec["reloc_accepted"],
                  rec["reloc_attempts"] - rec["reloc_accepted"]]])[1],
            mannwhitney_closure_frame_p=float(stats.mannwhitneyu(
                ref["closure_frames"], rec["closure_frames"]).pvalue))),
            flush=True)


CAMERA_WORLD = dict(num_frames=128, num_points=1200, width=752, height=480,
                    seed=2, speed=3.0)


def sweep_camera(args, where):
    """The bench's VO through ds and pinhole over ``args.seeds``."""
    if args.backend == "torch":
        from vslam_tpu_torch import synthetic
        from vslam_tpu_torch.bench import vo_config
        from vslam_tpu_torch.pipeline.streaming import StreamingVO

        kw = dict(device=args.device)
    else:
        from vslam_tpu import synthetic
        from vslam_tpu.config import SlamConfig
        from vslam_tpu.pipeline.streaming import StreamingVO

        def vo_config():   # bench.bench_single's
            return SlamConfig(enable_relocalization=False,
                              enable_loop_closure=False,
                              max_landmarks=65536, max_keyframes=1024)

        kw = {}
    from vslam_tpu_torch.eval import ate

    ates = {}
    for cam in ("ds", "pinhole"):
        seq = synthetic.generate(cam_type=cam, **CAMERA_WORLD)
        for seed in args.seeds:
            cfg = vo_config()
            cfg.seed = seed
            vo = StreamingVO(seq.calib, cfg, max_frames=len(seq.images),
                             **kw)
            t0 = time.perf_counter()
            vo.run(seq.images)
            res = vo.results()
            fids, pos, _ = vo.keyframe_trajectory()
            ates[cam, seed] = float(
                ate.align_svd(pos, seq.poses[fids, :3])[2])
            print(json.dumps(dict(
                scenario="camera", backend=args.backend, device=where,
                camera=cam, seed=seed, kf_ate_m=ates[cam, seed],
                keyframes=int(len(fids)),
                tracked_share=float(np.mean(res["tracked_ok"][1:])),
                seconds=time.perf_counter() - t0)), flush=True)
    r = np.asarray([ates["ds", s] / ates["pinhole", s] for s in args.seeds])
    print(json.dumps(dict(
        scenario="camera", backend=args.backend, device=where,
        ds_over_pinhole={str(s): round(float(v), 3)
                         for s, v in zip(args.seeds, r)},
        median=float(np.median(r)), min=float(r.min()), max=float(r.max()))),
        flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", choices=("torch", "jax"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--scenario",
                    choices=("injected", "faithful", "bench", "camera"),
                    default="injected")
    ap.add_argument("--loop-trace", type=int, nargs=2, metavar=("FIRST",
                                                                 "LAST"),
                    help="bench scenario: record the loop detector's "
                         "queries in these frames")
    ap.add_argument("--schedule", choices=("frame", "lagged"),
                    default="frame",
                    help="bench scenario, port: the driver's own poll "
                         "schedule, or bench.py's lagged chunk schedule")
    ap.add_argument("--replay-reloc", action="store_true",
                    help="bench scenario: replay every relocalization "
                         "attempt through both packages")
    ap.add_argument("--summarize", nargs="+", metavar="FILE",
                    help="summarize bench-scenario output files and exit")
    args = ap.parse_args()
    if args.summarize:
        summarize(args.summarize)
        return
    if args.backend is None:
        ap.error("--backend is required")
    if args.backend == "torch":
        where = args.device
    else:
        where = "jax-" + os.environ.get("JAX_PLATFORMS", "default")
    if where == "cuda":
        import torch

        where = torch.cuda.get_device_name(0)
    if args.scenario != "injected":
        {"faithful": sweep_faithful, "bench": sweep_bench,
         "camera": sweep_camera}[args.scenario](args, where)
        return
    if args.backend == "torch":
        seq, make, run, kf_ate = torch_backend(args.device)
    else:
        seq, make, run, kf_ate = jax_backend()
    rows = []
    for seed in args.seeds:
        for arm in ("clean", "injected", "slam"):
            drv = make(arm, seed)
            t0 = time.perf_counter()
            run(drv, inject=arm != "clean")
            row = dict(backend=args.backend, device=where, seed=seed,
                       arm=arm, kf_ate_m=kf_ate(drv),
                       tracked=float(np.mean(drv.results()["tracked_ok"][3:])),
                       seconds=time.perf_counter() - t0)
            if arm == "slam":
                row.update(
                    loops=[[int(a), int(b)] for a, b in drv.loop_edges],
                    loop_frames=[[int(drv.frame_of_slot[a]),
                                  int(drv.frame_of_slot[b])]
                                 for a, b in drv.loop_edges],
                    gba_merges=int(drv.gba_merges))
            rows.append(row)
            print(json.dumps(row), flush=True)
    by = {(r["seed"], r["arm"]): r for r in rows}
    bars = []
    for seed in args.seeds:
        floor, vo, slam = (by[(seed, a)]["kf_ate_m"]
                           for a in ("clean", "injected", "slam"))
        s = by[(seed, "slam")]
        gaps = [a - b for a, b in s["loop_frames"]]
        break_vo = max(vo ** 2 - floor ** 2, 0.0)
        break_slam = max(slam ** 2 - floor ** 2, 0.0)
        bars.append(dict(
            seed=seed, loop_across_break=bool(gaps and gaps[0] > 20),
            injection_separates=break_vo > 0,
            removed_over_20pct=bool(break_vo > 0
                                    and 1 - break_slam / break_vo > 0.2),
            slam_below_vo=slam < vo, slam_below_5m=slam < 5.0,
            tracked_over_90pct=s["tracked"] > 0.9,
            gba_merge=s["gba_merges"] >= 1))
    print(json.dumps({"bars_by_seed": bars}), flush=True)


if __name__ == "__main__":
    main()
