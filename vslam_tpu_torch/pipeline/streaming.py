"""StreamingVO and StreamingSLAM: stereo VO one frame per step, and full
SLAM on top of it at polls.

Port of ``StreamingVO`` and ``StreamingSLAM`` in
``vslam_tpu/pipeline/streaming.py``. ``StreamingVO`` is the VO
configuration of the reference: per frame, detect + describe the left
image, project and compact the landmarks, guided landmark matching,
batched RANSAC PnP and the motion model; on keyframes, right-image
features, stereo matching with the epipolar filter, keyframe insertion,
window eviction, landmark culling and the synchronous windowed Schur BA
(and, with a vocabulary, the keyframe's BoW words and a keyframe event);
after each frame, the velocity-decay guard and the next frame's keyframe
decision. ``StreamingSLAM`` adds place recognition, loop closure, global
BA and relocalization, run on the host at polls (see its docstring).

The step. The reference compiles the whole per-frame step once
(``jax.jit(step, donate_argnums=(0,))``), with the keyframe branch a
``lax.cond``, so a frame is one dispatch with no host read. The port
splits the step into three bodies that read nothing back to the host:
T (tracking, the coasted pose and the keyframe decision ``do_kf``), A
(the tracking frame's advance: velocity decay, the next keyframe request,
the logs) and K (the keyframe branch, then the same advance). A frame
runs T, reads ``do_kf`` back (its one host read), then runs K or A. The
state lives in fixed buffers that the bodies update in place (the
counterpart of ``donate_argnums``); a device frame counter, filled from
the host's before each frame, indexes the logs, whose writes past
``max_frames`` are dropped as the reference's ``mode="drop"`` drops them.

Spans (``spans``, on by default): every body stamps its stage boundaries
(``utils/profiling.BODY_STAGES``; on the card a one-thread kernel captured
into its graph, writing the device's clock into pinned host memory the
device maps), ``process_frame`` times its host spans (the image inputs,
each body's launch and its address check, the ``do_kf`` read), body K
counts the window BA's live LM bodies, and set-up times each body's first
run; ``self.spans`` (``profiling.SpanRecorder``, also
``profiling.latest_spans()``) holds them on the host clock, per frame.

On a CUDA device each body is captured as a CUDA graph and replayed
(``cuda_graphs``, on by default there): a body runs eagerly at its first
call, on a side stream (the warm-up, doing that frame's work), is
captured right after it, and is replayed at every later call; so T and
K are captured at the first frame (a keyframe) and A at the second. A
graph reads its
inputs (the images, copied into fixed buffers, and T's outputs) and the
state's buffers at the addresses it was captured with: a replay checks
that every state buffer is where it was and raises if one moved (host
code writes the state in place, ``write_state``). The RANSAC generator is
registered with each graph, so a replay draws what an eager step from the
same generator state draws. The Hamming kernels' launch counts
(``ops.cuda_hamming.LAUNCHES``) are taken at capture and added on every
replay. The device-tunable gate scalars (``config.DEVICE_TUNABLE``) are
plain Python floats rounded to float32, the precision the reference
carries them in; a graph holds them as captured, so ``set_param`` drops
the graphs and the next frame captures them anew. The graphs of a set
share one memory pool, which the set's first capture makes: they replay
one at a time, body T's outputs stay allocated while K and A read them,
and K's outputs are copied out before the next frame replays T. On the
CPU (and with ``cuda_graphs=False``) the same bodies run eagerly.

RANSAC draws come from an explicit ``torch.Generator`` seeded from
``config.seed`` (torch cannot reproduce ``jax.random``'s bits).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import (DEVICE_TUNABLE, DEVICE_TUNE_TRANSFORM, HOST_TUNABLE,
                      TUNE_INDEX, SlamConfig)
from ..core import state as state_mod
from ..core.state import KeyframeState, LandmarkState, TensorState
from ..frontend.features import extract_features
from ..geometry import lie
from ..io.calib import Calibration
from ..loop import vocabulary as vocab_mod
from ..ops import cuda_graphs, cuda_hamming
from ..ops.compact import masked_put_
from ..solvers import ba, pnp
from ..utils import profiling
from . import ba_global, ba_window, keyframe as kf_mod, tracking


@dataclasses.dataclass
class StreamState(TensorState):
    kf: KeyframeState
    lm: LandmarkState
    cur_pose: torch.Tensor      # [7]
    last_pose: torch.Tensor     # [7]
    vel: torch.Tensor           # [7]
    take_kf: torch.Tensor       # [] bool keyframe decision for this frame
    last_kf_slot: torch.Tensor  # [] int32
    frame: int                  # frames processed so far (host counter)
    intr0: torch.Tensor         # [8]
    intr1: torch.Tensor         # [8]
    T_0_1: torch.Tensor         # [7]
    traj: torch.Tensor          # [F, 7] per-frame pose log
    log_inliers: torch.Tensor   # [F] int32
    log_kf: torch.Tensor        # [F] bool
    log_ok: torch.Tensor        # [F] bool
    log_slot: torch.Tensor      # [F] int32 KF slot taken this frame (-1)
    log_wdrop: torch.Tensor     # [F] int32 window-BA obs dropped at the cap
    lost_run: torch.Tensor      # [] int32 consecutive lost frames
    # the newest frame's features (relocalization only, else None)
    cur_bits: Optional[torch.Tensor] = None     # [N, 256] uint8
    cur_corners: Optional[torch.Tensor] = None  # [N, 2] float32
    cur_valid: Optional[torch.Tensor] = None    # [N] bool


@dataclasses.dataclass
class KeyframeEvent:
    """A keyframe as place recognition consumes it: the frame, the slot it
    took (-1 for an insert past the keyframe capacity, which the poll
    skips), its BoW words [N] int32 and its covisibility row [K] int32 at
    insertion (device tensors until the poll reads them)."""
    frame: int
    slot: torch.Tensor
    words: torch.Tensor
    covis: torch.Tensor


@dataclasses.dataclass
class _Tracked:
    """Body T's outputs: the tracking result, the frame's pose (the
    estimate, or the motion model's where tracking failed) and the
    keyframe decision."""
    res: tracking.TrackResult
    pose: torch.Tensor
    do_kf: torch.Tensor


@dataclasses.dataclass
class _Graph:
    """One captured body: the graph, its outputs (tensors the graph owns
    and rewrites on every replay), the kernel launches of one replay, and
    the state buffers' addresses at capture."""
    graph: object
    out: object
    launches: dict
    ptrs: dict


def _tensor_fields(obj, prefix: str = "") -> dict:
    """{dotted field path: tensor} of a state dataclass, nested ones too
    (fields that hold None or a host integer are left out)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_tensor_fields(v, prefix + f.name + "."))
        elif torch.is_tensor(v):
            out[prefix + f.name] = v
    return out


def _with_tensors(obj, table: dict, prefix: str = ""):
    """``obj`` with every tensor field taken from ``table`` (by path)."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            changes[f.name] = _with_tensors(v, table, prefix + f.name + ".")
        elif torch.is_tensor(v):
            changes[f.name] = table[prefix + f.name]
    return dataclasses.replace(obj, **changes)


def _launch_span(name: str) -> str:
    """The host span of a body's launch: ``launch.<body>`` (a graph
    named ``<body>.<index>`` is one of several of that body)."""
    return "launch." + name.split(".")[0]


class GraphBodies:
    """Running a driver's step bodies eagerly or as CUDA graphs (module
    docstring), shared by ``StreamingVO`` and
    ``parallel/multiseq_runner.MultiSeqVO``. The driver holds ``state``
    (its tensors are the buffers the graphs read and write), ``device``,
    ``generator`` (registered with every graph), ``spans``,
    ``cuda_graphs``, ``_graphs`` ({name: _Graph}), ``_warmed``,
    ``_inputs``, ``_staging`` and ``capture_stats``. A body takes its
    arguments, returns (the new state or None, its outputs), and reads
    nothing back to the host; an argument that is a ``_Tracked`` is body
    ``_TRACK``'s output, which a graph reads where that body's graph
    writes it."""

    _TRACK = "track"

    def write_state(self, **fields):
        """Set state fields in place: every tensor given (or every tensor
        field of a ``KeyframeState`` / ``LandmarkState`` given) is copied
        into the state's own buffer, where the captured graphs read it.
        Host fields (``frame``) are set. Host code that changes the state
        between frames (closure, relocalization, global BA) goes through
        here; replacing ``self.state``'s tensors instead makes the next
        replay raise."""
        self._copy_into(_tensor_fields(self.state),
                        self.state.replace(**fields))

    def _copy_into(self, base: dict, new):
        """Copy ``new``'s tensors into the buffers ``base`` (by path) where
        they are not those buffers, and keep the buffers in the state."""
        for path, t in _tensor_fields(new).items():
            if t is not base[path]:
                base[path].copy_(t)
        self.state = _with_tensors(new, base)

    def _image(self, img):
        if not torch.is_tensor(img):
            img = torch.from_numpy(np.ascontiguousarray(img))
        return img.to(self.device)

    def _input(self, which: str, img, staging: str = None):
        """The image as the step reads it: on the eager path the image on
        the device; with graphs, copied into the fixed buffer ``which``.
        A host image goes through a pinned copy (pinned buffer
        ``staging``, by default ``which``) without blocking: the pinned
        buffer's previous copy has completed by then, as the keyframe
        decision read after every body T waits for the frame's work."""
        if not self.cuda_graphs:
            return self._image(img)
        src = (img if torch.is_tensor(img)
               else torch.from_numpy(np.ascontiguousarray(img)))
        buf = self._inputs.get(which)
        if buf is None:
            buf = self._inputs[which] = torch.empty(
                src.shape, dtype=src.dtype, device=self.device)
        if src.shape != buf.shape or src.dtype != buf.dtype:
            raise ValueError(f"{which} image {tuple(src.shape)} {src.dtype}; "
                             f"the graphs were built for {tuple(buf.shape)} "
                             f"{buf.dtype}")
        if src.device.type == "cpu":
            staging = staging or which
            pin = self._staging.get(staging)
            if pin is None:
                pin = self._staging[staging] = torch.empty(
                    src.shape, dtype=src.dtype, pin_memory=True)
            pin.copy_(src)
            src = pin
        buf.copy_(src, non_blocking=True)
        return buf

    # ---------------------------------------------------------------
    # running the bodies: eagerly, or as CUDA graphs
    # ---------------------------------------------------------------

    def _run_body(self, body, args):
        """Run a body and copy the state it returns into the buffers."""
        base = _tensor_fields(self.state)
        new, out = body(*args)
        self._copy_into(base, new if new is not None else self.state)
        return out

    def _step(self, name: str, body, *args):
        with self.spans.span(_launch_span(name)):
            return self._launch(name, body, args)

    def _launch(self, name: str, body, args):
        if not self.cuda_graphs:
            return self._run_body(body, args)
        g = self._graphs.get(name)
        if g is not None:
            return self._replay(name, g)
        # a graph reads body T's outputs where T's graph writes them
        # (T is captured first: it runs first in every frame)
        graph_args = tuple(self._graphs[self._TRACK].out
                           if isinstance(a, _Tracked) else a for a in args)
        if name in self._warmed:   # graphs dropped: capture, then replay
            g = self._graphs[name] = self._capture(name, body, graph_args)
            return self._replay(name, g)
        with self.spans.setup("first_run." + name):
            out = self._warm_up(body, args)
            torch.cuda.synchronize(self.device)
        self._warmed.add(name)
        self._graphs[name] = self._capture(name, body, graph_args)
        return out

    def _warm_up(self, body, args):
        """A body's first run: eager, on a side stream (as
        ``torch.cuda.graphs`` prescribes before a capture), doing the
        frame's work."""
        cur = torch.cuda.current_stream(self.device)
        # the stream the window BA's IF bodies are captured on: its cuBLAS
        # workspace is then made here, outside the graphs' pools
        side = cuda_graphs.side_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._run_body(body, args)
        cur.wait_stream(side)
        return out

    def _capture(self, name: str, body, args) -> _Graph:
        """Capture a body as a CUDA graph (nothing runs); raises if the
        capture fails. The capture's kernel launches are counted per
        replay, not here."""
        torch.cuda.synchronize(self.device)
        if not self.capture_stats:   # the spans' first clock calibration
            self.spans.calibrate()
        torch.cuda.empty_cache()
        if not self._graphs:   # the first graph of a set makes its pool
            self._pool = torch.cuda.graph_pool_handle()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        ptrs = {p: t.data_ptr() for p, t in _tensor_fields(self.state).items()}
        before = dict(cuda_hamming.LAUNCHES)
        try:
            # thread_local: other threads (an image decoder, say) may use
            # the card while the step is captured
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                out = self._run_body(body, args)
        except Exception as e:
            raise RuntimeError(f"capture of the step's {name} body failed "
                               f"(there is no eager fallback)") from e
        finally:
            launches = {k: cuda_hamming.LAUNCHES[k] - n
                        for k, n in before.items()}
            cuda_hamming.LAUNCHES.update(before)
        torch.cuda.synchronize(self.device)
        self.capture_stats[name] = dict(
            seconds=time.perf_counter() - t0,
            pool_reserved_bytes=(torch.cuda.memory_reserved(self.device)
                                 - reserved))
        return _Graph(graph, out, launches, ptrs)

    def _replay(self, name: str, g: _Graph):
        with self.spans.span("replay.check", _launch_span(name)):
            for path, t in _tensor_fields(self.state).items():
                if g.ptrs.get(path) != t.data_ptr():
                    raise RuntimeError(
                        f"the {name} graph was captured with state buffer "
                        f"{path} at another address: host code replaced "
                        f"the tensor instead of writing it in place "
                        f"(write_state)")
        g.graph.replay()
        for k, n in g.launches.items():
            cuda_hamming.LAUNCHES[k] += n
        return g.out


class StreamingVO(GraphBodies):
    """Stereo VO runner on one device (see module docstring): the card
    unless the caller asks for another (``device="cpu"``); raises where
    there is no card and none was asked for.

    ``vocabulary`` (a ``loop.vocabulary.Vocabulary``) turns on place
    recognition's per-keyframe work: the BoW words of each keyframe's left
    features and a ``KeyframeEvent`` appended to ``self.events``.
    ``store_features`` keeps the newest frame's features in the state for
    relocalization (and then a lost frame does not become a keyframe).
    Without either it runs plain VO. ``feature_fn`` (an image -> ``Features``
    callable with ``cfg.num_features`` slots, e.g.
    ``models.learned_frontend.make_feature_fn``) replaces the built-in
    extraction of the left image every frame and of the right image on
    keyframes.

    ``cuda_graphs``: None (the default) replays the step's bodies as CUDA
    graphs on a CUDA device and runs them eagerly on the CPU; False runs
    them eagerly anywhere; True on the CPU raises ``ValueError``. A driver
    with a ``feature_fn`` runs eagerly: its None means False, and True
    raises (the learned frontend's step is not captured yet). A capture
    that fails raises; nothing falls back to the eager step.
    ``capture_stats`` holds each capture's seconds and the device memory
    the pool grew by in it.

    ``spans`` (on by default) records the per-frame spans and counters
    (module docstring) in ``self.spans``; ``False`` takes no stamp at all
    (``self.spans`` is then ``profiling.NO_SPANS``).
    """

    def __init__(self, calib: Calibration,
                 config: Optional[SlamConfig] = None,
                 max_frames: int = 8192, vocabulary=None,
                 store_features: bool = False, device="cuda",
                 feature_fn=None, cuda_graphs: Optional[bool] = None,
                 spans: bool = True):
        self.cfg = config or SlamConfig()
        self.calib = calib
        self.cam_name = calib.cam_types[0]
        self.max_frames = max_frames
        self.device = resolve_device(device)
        self.voc = vocabulary
        self.dvoc = (vocab_mod.DeviceVocabulary(vocabulary, self.device)
                     if vocabulary is not None else None)
        self.store_features = store_features
        self.feature_fn = feature_fn
        self.cuda_graphs = self._graphs_wanted(cuda_graphs)
        self.generator = torch.Generator(device=self.device)
        self._inputs = {}    # image buffers the graphs read
        self._staging = {}   # pinned host copies of host images
        self._warmed = set()
        self.capture_stats = {}
        self.spans = (profiling.SpanRecorder(max_frames, self.device)
                      if spans else profiling.NO_SPANS)
        if self.device.type == "cuda":
            self._flag_host = torch.zeros((), dtype=torch.bool,
                                          pin_memory=True)
            self._flag_event = torch.cuda.Event()
        self.reset()

    def _graphs_wanted(self, flag) -> bool:
        if flag is None:
            return self.device.type == "cuda" and self.feature_fn is None
        if flag and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs=True needs a CUDA device; this "
                             f"driver runs on {self.device}")
        if flag and self.feature_fn is not None:
            raise ValueError("cuda_graphs=True with a feature_fn: the "
                             "learned frontend's step runs eagerly")
        return bool(flag)

    def reset(self):
        cfg = self.cfg
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        T_i_c0 = torch.as_tensor(np.asarray(self.calib.T_i_c[0]), **f32)
        T_i_c1 = torch.as_tensor(np.asarray(self.calib.T_i_c[1]), **f32)
        F = self.max_frames
        ident = lie.identity_pose(torch.float32, dev)
        self.state = StreamState(
            kf=state_mod.init_keyframes(cfg.max_keyframes, cfg.num_features,
                                        device=dev),
            lm=state_mod.init_landmarks(cfg.max_landmarks,
                                        B=cfg.lm_desc_bank, device=dev),
            cur_pose=ident.clone(),
            last_pose=ident.clone(),
            vel=ident.clone(),
            take_kf=torch.ones((), dtype=torch.bool, device=dev),
            last_kf_slot=torch.full((), -1, **i32),
            frame=0,
            intr0=torch.as_tensor(np.asarray(self.calib.intrinsics[0]), **f32),
            intr1=torch.as_tensor(np.asarray(self.calib.intrinsics[1]), **f32),
            T_0_1=lie.se3_mul(lie.se3_inv(T_i_c0), T_i_c1),
            traj=torch.zeros((F, 7), **f32),
            log_inliers=torch.zeros((F,), **i32),
            log_kf=torch.zeros((F,), dtype=torch.bool, device=dev),
            log_ok=torch.zeros((F,), dtype=torch.bool, device=dev),
            log_slot=torch.full((F,), -1, **i32),
            log_wdrop=torch.zeros((F,), **i32),
            lost_run=torch.zeros((), **i32),
        )
        if self.store_features:
            N = cfg.num_features
            self.state = self.state.replace(
                cur_bits=torch.zeros((N, 256), dtype=torch.uint8, device=dev),
                cur_corners=torch.full((N, 2), -1.0, **f32),
                cur_valid=torch.zeros((N,), dtype=torch.bool, device=dev))
        # the frame counter on the device, filled from state.frame
        self._frame_dev = torch.zeros((), **i32)
        self.spans.clear()
        if self.spans:
            self.spans.frame_dev = self._frame_dev
        self._graphs = {}   # new buffers: the old graphs' addresses are gone
        self.events = []   # KeyframeEvent per keyframe (with a vocabulary)
        self.tune = {name: float(np.float32(v))
                     for name, v in zip(DEVICE_TUNABLE, cfg.tune_vector())}
        self.generator.manual_seed(cfg.seed)

    def set_param(self, name: str, value) -> None:
        """Change a runtime parameter mid-run (pangolin::Var analogue).

        ``DEVICE_TUNABLE`` names update the gate scalars the step reads
        (rounded to float32, as the reference carries them) from the next
        frame on, which drops the captured graphs (they hold the old
        values); ``HOST_TUNABLE`` names set the config field, which the
        host-side orchestration (polls, loop closure, relocalization) reads
        per call. Anything else sizes buffers and raises ``ValueError``.
        """
        if name in TUNE_INDEX:
            xf = DEVICE_TUNE_TRANSFORM.get(name, lambda v: v)
            self.tune[name] = float(np.float32(xf(float(value))))
            setattr(self.cfg, name, value)  # host-side readers see it too
            if name == "pnp_inlier_thresh_px":
                self.pnp_threshold = xf(float(value))
            self._graphs = {}
        elif name in HOST_TUNABLE:
            setattr(self.cfg, name, value)
        else:
            raise ValueError(
                f"{name!r} is not live-tunable (it sizes the state's "
                f"buffers); rebuild the driver with a new SlamConfig. "
                f"Tunable: {sorted(TUNE_INDEX) + sorted(HOST_TUNABLE)}")

    def _read(self, flag) -> bool:
        """The one host read of a frame: ``flag`` through a pinned scalar
        on the card."""
        if self.device.type != "cuda":
            return bool(flag)
        self._flag_host.copy_(flag, non_blocking=True)
        self._flag_event.record()
        self._flag_event.synchronize()
        return bool(self._flag_host)

    # ---------------------------------------------------------------
    # the step's bodies: no host read in any of them
    # ---------------------------------------------------------------

    def _track(self, img_l):
        """Body T: track the left image, coast on the motion model where
        tracking fails, decide on a keyframe."""
        cfg, P, st = self.cfg, self.tune, self.state
        self.spans.stamp("track", "start")
        predicted = lie.se3_mul(st.cur_pose, st.vel)
        res = tracking.track_frame(
            img_l, st.lm, predicted, st.last_pose, st.vel, st.intr0,
            cam_name=self.cam_name, num_features=cfg.num_features,
            inview_cap=cfg.max_inview_landmarks, width=self.calib.width,
            height=self.calib.height, z_threshold=P["cam_z_threshold"],
            match_max_dist_2d=P["match_max_dist_2d"],
            match_threshold=P["match_max_dist"],
            match_ratio=P["match_next_best"],
            pnp_threshold=P["pnp_inlier_thresh_px"],
            num_hypotheses=cfg.ransac_hypotheses,
            min_matches=P["ransac_min_matches"],
            quality_level=P["quality_level"], min_distance=cfg.min_distance,
            rotate_features=cfg.rotate_features, num_octaves=cfg.num_octaves,
            generator=self.generator,
            feats=(self.feature_fn(img_l) if self.feature_fn is not None
                   else None),
            stamp=(functools.partial(self.spans.stamp, "track")
                   if self.spans else None))
        ok = res.pnp_ok
        # on failure coast on the motion model
        pose = torch.where(ok, res.T_w_c, predicted)

        if self.store_features or cfg.kf_require_tracked:
            # a lost frame does not become a keyframe, except to bootstrap
            # an empty map or after a sustained loss (with relocalization
            # on, so that recovery gets the first chance at a clean pose)
            reb = P["lost_rebootstrap_frames"]
            bootstrap = st.kf.next_slot == 0
            rebootstrap = ((reb > 0) & (st.lost_run >= reb)
                           & (res.feats.valid.sum()
                              >= P["reloc_min_features"]))
            do_kf = st.take_kf & (ok | bootstrap | rebootstrap)
        else:
            do_kf = st.take_kf
        self.spans.stamp("track", "decide")
        return None, _Tracked(res=res, pose=pose, do_kf=do_kf)

    def _advance_body(self, t: _Tracked):
        """Body A: a tracking frame's advance."""
        self.spans.stamp("advance", "start")
        st = self.state
        wdrop = torch.zeros((), dtype=torch.int32, device=self.device)
        new = self._advance(t, st.kf, st.lm, t.pose, st.last_kf_slot, wdrop)
        self.spans.stamp("advance", "end")
        return new, None

    def _keyframe_body(self, t: _Tracked, img_r):
        """Body K: the keyframe branch, then the advance. Its outputs are
        the keyframe event's slot, words and covisibility row (None
        without a vocabulary)."""
        self.spans.stamp("keyframe", "start")
        kf, lm, pose, slot, wdrop, event = self._keyframe(t, img_r)
        new = self._advance(t, kf, lm, pose, slot, wdrop)
        self.spans.stamp("keyframe", "advance")
        return new, event

    def _keyframe(self, t: _Tracked, img_r):
        """The keyframe branch: stereo matching, insertion, eviction,
        culling and window BA. Returns (kf, lm, keyframe pose, last slot,
        window obs dropped, event)."""
        cfg, P, st, res = self.cfg, self.tune, self.state, t.res
        stamp = functools.partial(self.spans.stamp, "keyframe")
        K = st.kf.frame_id.shape[0]
        if self.feature_fn is not None:
            feats_r = self.feature_fn(img_r)
        else:
            feats_r = extract_features(
                img_r, num_features=cfg.num_features,
                quality_level=P["quality_level"],
                min_distance=cfg.min_distance,
                rotate_features=cfg.rotate_features,
                num_octaves=cfg.num_octaves)
        stamp("extract_right")
        stereo_j, stereo_inl = kf_mod.stereo_match(
            res.feats, feats_r, st.T_0_1, st.intr0, st.intr1,
            cam_name=self.cam_name, threshold=P["match_max_dist"],
            ratio=P["match_next_best"],
            epipolar_threshold=P["epipolar_error_threshold"])
        stamp("k2")
        suppress = (res.had_candidate if cfg.suppress_duplicate_landmarks
                    else None)
        out = kf_mod.insert_keyframe(
            st.kf, st.lm, self._frame_dev, st.last_kf_slot, t.pose, st.T_0_1,
            res.feats, feats_r, stereo_j, stereo_inl, res.match_lm,
            res.inlier, st.intr0, st.intr1, cam_name=self.cam_name,
            suppress_new=suppress)
        stamp("insert")

        # window eviction: keep the newest max_num_kfs active pairs
        kf2, lm2 = kf_mod.evict_to_newest(out.kf, out.lm, cfg.max_num_kfs)
        if cfg.enable_lm_culling:
            kf2, lm2 = kf_mod.cull_under_pressure(
                kf2, lm2, cfg.lm_cull_pressure, cfg.lm_cull_min_obs)
        stamp("evict_cull")

        # synchronous windowed Schur BA; the keyframe pose is post-BA
        wp = ba_window.build_window_problem(
            kf2, lm2, st.intr0, st.intr1, W2=cfg.window_cams // 2,
            Lw=cfg.window_points, O=cfg.window_obs,
            obs_per_lm=cfg.ba_obs_per_lm)
        stamp("ba_build")
        poses, points, stats = ba.solve_ba_schur(
            wp.prob, cam_name=self.cam_name, huber=P["ba_huber_px"],
            max_iters=cfg.ba_max_iters)
        # the LM bodies that did work, of the bodies captured (a replay
        # skips the others)
        self.spans.count("lm_live", stats["iterations"])
        self.spans.count("lm_run", cfg.ba_max_iters)
        stamp("ba_solve")
        kf3, lm3 = ba_window.merge_window_result(kf2, lm2, wp, poses, points)
        stamp("ba_merge")
        in_cap = out.slot < K
        s = torch.clamp(out.slot, max=K - 1).to(torch.int64).reshape(1)
        pose_kf = torch.where(in_cap, kf3.pose_l.index_select(0, s)[0],
                              t.pose)
        slot = torch.where(in_cap, out.slot, st.last_kf_slot).to(torch.int32)
        event = None
        if self.dvoc is not None:
            # an insert past the keyframe capacity logs slot -1: its slot
            # would be stale
            event = (torch.where(in_cap, slot, torch.full_like(slot, -1)),
                     self.dvoc.words(res.feats.bits, res.feats.valid),
                     out.covis_weight)
        return kf3, lm3, pose_kf, slot, wp.obs_dropped, event

    def _advance(self, t: _Tracked, kf, lm, pose2, last_slot, wdrop):
        """The advance, the velocity-decay guard, the next frame's keyframe
        request and the logs (written in place, dropped past
        ``max_frames``). Returns the new state."""
        cfg, P, st = self.cfg, self.tune, self.state
        ok, do_kf, res = t.res.pnp_ok, t.do_kf, t.res
        vel = lie.se3_mul(lie.se3_inv(st.last_pose), pose2)
        n_inl = torch.where(ok, res.num_inliers,
                            torch.zeros_like(res.num_inliers))
        if cfg.enable_vel_decay:
            weak = ~ok | (n_inl < P["vel_decay_inlier_floor"])
            vel = torch.where(
                weak, lie.se3_exp(P["vel_decay_factor"] * lie.se3_log(vel)),
                vel)

        # next-frame keyframe decision: a keyframe step resets it, a
        # tracking step re-arms it on low inliers
        take_next = ~do_kf & (st.take_kf | (n_inl < P["new_kf_min_inliers"]))

        feat_fields = {}
        if self.store_features:
            feat_fields = dict(cur_bits=res.feats.bits,
                               cur_corners=res.feats.corners,
                               cur_valid=res.feats.valid)
        f = self._frame_dev
        row = (torch.clamp(f, max=self.max_frames - 1).to(torch.int64)
               .reshape(1),)
        in_log = (f < self.max_frames).reshape(1)
        kf_slot = torch.where(do_kf, last_slot, torch.full_like(last_slot, -1))
        for log, val in ((st.traj, pose2[None]),
                         (st.log_inliers, n_inl.to(torch.int32)),
                         (st.log_kf, do_kf), (st.log_ok, ok),
                         (st.log_slot, kf_slot), (st.log_wdrop, wdrop)):
            masked_put_(log, row, val, in_log)
        return st.replace(
            **feat_fields,
            kf=kf, lm=lm, cur_pose=pose2, last_pose=pose2, vel=vel,
            # a keyframe insert restarts the loss count too
            lost_run=torch.where(ok | do_kf, torch.zeros_like(st.lost_run),
                                 st.lost_run + 1).to(torch.int32),
            take_kf=take_next, last_kf_slot=last_slot)

    def process_frame(self, img_l, img_r):
        """Track one stereo pair (uint8 [H, W] arrays or tensors): body T,
        the keyframe decision read back, then body K or body A (module
        docstring)."""
        frame, sp = self.state.frame, self.spans
        with sp.frame(frame):
            self._frame_dev.fill_(frame)
            with sp.span("input.left"):
                left = self._input("left", img_l)
            t = self._step("track", self._track, left)
            with sp.span("read"):
                do_kf = self._read(t.do_kf)   # the per-frame host read
            sp.after_read(frame)
            if do_kf:
                with sp.span("input.right"):
                    right = self._input("right", img_r)
                event = self._step("keyframe", self._keyframe_body, t, right)
                if event is not None:
                    # the graph rewrites its outputs on the next replay
                    self.events.append(KeyframeEvent(
                        frame, *(x.clone() for x in event)))
            else:
                self._step("advance", self._advance_body, t)
            self.state = self.state.replace(frame=frame + 1)

    def run(self, frames):
        """Process [(img_l, img_r)] pairs in order. Returns the count."""
        for img_l, img_r in frames:
            self.process_frame(img_l, img_r)
        return len(frames)

    def results(self) -> dict:
        """Every per-frame log, as numpy arrays."""
        st = self.state
        n = min(st.frame, self.max_frames)
        return {
            "frames": st.frame,
            "trajectory": st.traj[:n].cpu().numpy(),
            "inliers": st.log_inliers[:n].cpu().numpy(),
            "is_keyframe": st.log_kf[:n].cpu().numpy(),
            "tracked_ok": st.log_ok[:n].cpu().numpy(),
            "window_obs_dropped": st.log_wdrop[:n].cpu().numpy(),
        }

    def keyframe_trajectory(self):
        """(frame_ids, positions, poses) of valid keyframes, for ATE."""
        kf = self.state.kf
        valid = kf.valid.cpu().numpy()
        fids = kf.frame_id.cpu().numpy()[valid]
        poses = kf.pose_l.cpu().numpy()[valid]
        order = np.argsort(fids)
        return fids[order], poses[order][:, :3], poses[order]


class StreamingSLAM(StreamingVO):
    """Streaming full SLAM: the VO stream plus host-side place recognition,
    loop closure and relocalization, run at polls.

    Port of ``StreamingSLAM`` in ``vslam_tpu/pipeline/streaming.py``. Every
    ``poll_every`` frames ``poll`` reads the keyframe events logged since
    the last poll; for each new keyframe it takes the BoW words and the
    covisibility row, updates the inverted-file database and runs the loop
    detector (loop_closure_utils.h:141-388). A consistent candidate that
    passes ``compute_sim3``, ``verify_loop`` and the identity-gain gate is
    applied to the live state: the live gauge moves rigidly onto the old
    map, the pose graph bends the chain between them, and a global BA is
    dispatched and skip-merged at the next poll (``pipeline/ba_global``).

    Relocalization (``cfg.enable_relocalization``): the newest frame's
    features stay in the state; when a poll finds the newest
    ``reloc_lost_frames`` frames all lost, it runs the BoW + PnP recovery
    (loop/relocalize.py) against the live map and patches the tracker
    pose; failed attempts back off exponentially.

    ``run`` reads the events and the loss log on the reference's
    schedule, so that both packages attempt relocalization on the same
    frames. At ``chunk=1`` it polls every ``poll_every`` frames and at the
    end. At ``chunk=C > 1`` (``poll_every`` a multiple of C) it reads, at
    each C-frame boundary, what the previous boundary had logged (a
    lagged poll); where that shows a sustained loss it polls the current
    state at once. A poll of the current state that finds the newest
    frames lost enters lost mode, which polls the current state at every
    boundary until tracking is back. A tail of fewer than C frames runs
    frame by frame before the last poll. The reference's chunked driver
    also stretches the lagged poll's stride (up to ``poll_every // C``
    boundaries) while its fetches wait long on a congested device link;
    the port keeps the stride at 1, which is what a quiet link gives it.
    ``process_frame`` stays one frame at a time: only the host's reading
    points follow the chunks.

    The reference hides its accelerator's round trip behind a device-side
    keyframe event ring, one packed poll buffer and chunked dispatch; the
    port keeps the events in a host list and reads the logs directly. The
    polls, place recognition, closure, relocalization and global BA run
    eagerly on the host between frames, as in the reference, and write
    what they change into the state in place (``write_state``), so the
    frame step's graphs stay valid. The host RANSAC draws of closure and
    relocalization come from a ``torch.Generator`` seeded with
    ``cfg.seed + 1``.

    A vocabulary is required (the reference equally loads ORBvoc.txt
    before processing, slam.cpp:370-380).
    """

    def __init__(self, calib: Calibration, config: Optional[SlamConfig],
                 vocabulary, max_frames: int = 8192, poll_every: int = 16,
                 chunk: int = 1, device="cuda", feature_fn=None,
                 cuda_graphs: Optional[bool] = None, spans: bool = True):
        if vocabulary is None:
            raise ValueError("StreamingSLAM requires a pretrained "
                             "vocabulary (loop.vocabulary.train)")
        chunk = max(1, int(chunk))
        if chunk > 1 and poll_every % chunk:
            raise ValueError(f"poll_every={poll_every} must be a multiple "
                             f"of chunk={chunk} (polls land on chunk "
                             "boundaries)")
        cfg = config or SlamConfig()
        super().__init__(calib, cfg, max_frames, vocabulary=vocabulary,
                         store_features=cfg.enable_relocalization,
                         device=device, feature_fn=feature_fn,
                         cuda_graphs=cuda_graphs, spans=spans)
        from ..loop.detector import LoopDetector

        self.poll_every = poll_every
        self.chunk = chunk
        self.detector = LoopDetector(self.cfg.num_consistency)
        self.covis_host: dict = {}
        self.frame_of_slot: dict = {}
        self.loop_edges: list = []
        self.rejected_loops: list = []  # (slot, cand, n_inl, n_vis)
        self.closure_stats: list = []   # per-closure sub-stage wall times
        self.reloc_events: list = []    # (frame_polled, ok)
        self.reloc_diags: list = []     # per-attempt diag dicts
        self.gba_stats: list = []       # per global BA: iterations, costs
        self._reloc_failures = 0        # consecutive failed attempts
        self._reloc_next_attempt = 0    # backoff: no attempt before this
        # wall seconds per closure stage, and why candidates did / did not
        # close, per gate
        self.loop_timings = collections.Counter()
        self.loop_stats = collections.Counter()
        self._ev_consumed = 0
        # lost mode (chunked runs): poll the current state at every chunk
        # boundary while the newest frames are lost
        self._lost_mode = False
        self._lagged_n = None   # frames logged at the last unread boundary
        self._last_closure_frame = -(10 ** 9)
        self._pending_gba = None
        self.gba_merges = 0
        self.host_generator = torch.Generator(device=self.device)
        self.host_generator.manual_seed(self.cfg.seed + 1)
        # the closure and relocalization RANSAC gate, derived in float64 on
        # the host as the reference derives it
        self.pnp_threshold = pnp.ransac_threshold(
            self.cfg.pnp_inlier_thresh_px)

    def run(self, frames):
        """Process [(img_l, img_r)] pairs, polling on the reference's
        schedule (see the class docstring). Returns the count."""
        n, C = len(frames), self.chunk
        if C == 1:
            for i, (img_l, img_r) in enumerate(frames):
                self.process_frame(img_l, img_r)
                if (i + 1) % self.poll_every == 0:
                    self.poll()
            self.poll()
            return n
        groups = n // C
        for g in range(groups):
            for img_l, img_r in frames[g * C:(g + 1) * C]:
                self.process_frame(img_l, img_r)
            self._poll_lagged()
            if self._lost_mode:
                self._poll_at(self.state.frame)
        for img_l, img_r in frames[groups * C:]:
            self.process_frame(img_l, img_r)
        self.poll()
        return n

    def _poll_lagged(self):
        """A chunk boundary: read what the previous boundary logged (none
        in lost mode, whose polls read the current state), and poll the
        current state at once where that showed a sustained loss."""
        prev, self._lagged_n = self._lagged_n, self.state.frame
        if prev is None or self._lost_mode:
            return
        if self._poll_at(prev, stale=True):
            self._poll_at(self.state.frame)

    def poll(self):
        """Process the keyframe and loss events logged since the last
        poll (a boundary's that is still unread first)."""
        if self._lagged_n is not None:
            self._poll_at(self._lagged_n, stale=True)
            self._lagged_n = None
        self._poll_at(self.state.frame)

    def _poll_at(self, n: int, stale: bool = False) -> bool:
        """The poll of the first ``n`` frames' keyframe events and loss log.
        A ``stale`` one (a lagged boundary's) leaves lost mode as it is
        and attempts no recovery, but returns True where it would have:
        the caller then polls the current state."""
        t_poll = time.perf_counter()
        fetched = []
        while (self._ev_consumed < len(self.events)
               and self.events[self._ev_consumed].frame < n):
            e = self.events[self._ev_consumed]
            self._ev_consumed += 1
            fetched.append((e.frame, int(e.slot), e.words.cpu().numpy(),
                            e.covis.cpu().numpy()))
        n = min(n, self.max_frames)   # the loss log ends at max_frames
        ok_log = self.state.log_ok[:n].cpu().numpy()
        self.loop_timings["poll_fetch"] += time.perf_counter() - t_poll
        for frame, slot, words, covis in fetched:
            if slot < 0 or slot in self.frame_of_slot:
                continue
            self._handle_keyframe(frame, slot, words, covis)
        # sustained-loss detection -> relocalization (slam.cpp:1348-1367
        # runs it per lost frame; here a poll reacts)
        R = self.cfg.reloc_lost_frames
        if not stale and self.cfg.enable_relocalization:
            self._lost_mode = bool(n > 0 and not ok_log[max(0, n - R):n].any())
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
            frames_lost = int(n - 1 - oks[-1]) if len(oks) else n
            self._try_relocalize_stream(n, frames_lost)
        self._merge_gba_if_ready()
        return False

    def _merge_gba_if_ready(self):
        """Skip-merge a dispatched global BA (slam.cpp:1410-1447). The solve
        is done at dispatch, so with or without ``deterministic_async`` the
        merge lands at the first poll after it."""
        if self._pending_gba is None:
            return
        t0 = time.perf_counter()
        kf2, lm2 = ba_global.merge_global_ba(self.state.kf, self.state.lm,
                                             self._pending_gba)
        self.write_state(kf=kf2, lm=lm2)
        self._pending_gba = None
        self.gba_merges += 1
        self.loop_timings["gba_merge"] += time.perf_counter() - t0

    def keyframe_trajectory(self):
        self._merge_gba_if_ready()
        return super().keyframe_trajectory()

    @contextlib.contextmanager
    def _timed(self, key):
        """Accumulate the block's wall seconds into loop_timings[key]."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.loop_timings[key] += time.perf_counter() - t0

    def _graph_sets(self):
        return {s: set(d) for s, d in self.covis_host.items()}

    def _try_relocalize_stream(self, frame_now: int, frames_lost: int = 1):
        """BoW candidates + PnP against the live map, then the tracker pose
        patched in the stream state (the late analogue of
        relocalize_camera, tracking.h:241-419). ``frames_lost`` scales the
        motion gate (see loop/relocalize.py)."""
        from ..loop import relocalize as reloc_mod

        cfg, st = self.cfg, self.state
        if int(st.cur_valid.sum()) < cfg.reloc_min_features:
            return  # blackout frame: nothing to recognize
        words = self.dvoc.words(st.cur_bits, st.cur_valid).cpu().numpy()
        bow = vocab_mod.bow_from_words(self.voc, words)
        if not bow:
            return
        ok, T_wc, _pairs, diag = reloc_mod.relocalize(
            st.kf, st.lm, self.detector, st.cur_bits, st.cur_valid,
            st.cur_corners, bow, self._graph_sets(), st.cur_pose, st.vel,
            st.intr0, self.cam_name, cfg.motion_threshold,
            self.pnp_threshold, self.host_generator,
            num_hypotheses=cfg.ransac_hypotheses,
            max_retries=cfg.track_max_retries,
            max_candidates=cfg.reloc_max_candidates,
            frames_lost=frames_lost,
            # cross-gauge recoveries are only safe when loop closure can
            # merge the gauges afterwards (see config.py)
            gate_cap_mult=(cfg.reloc_gate_cap_mult
                           if cfg.enable_loop_closure else
                           min(cfg.reloc_gate_cap_mult,
                               cfg.reloc_gate_cap_mult_no_lc)))
        self.reloc_events.append((frame_now, bool(ok)))
        # the features and pose the recovery used are the newest frame's
        diag.update(frame=frame_now, frames_lost=frames_lost,
                    applied_frame=st.frame - 1)
        if ok:
            diag["T_wc"] = [round(float(v), 4) for v in T_wc.cpu()]
        self.reloc_diags.append(diag)
        if not ok:
            self._reloc_failures += 1
            self._reloc_next_attempt = frame_now + min(
                cfg.reloc_backoff_frames * (2 ** (self._reloc_failures - 1)),
                cfg.reloc_backoff_cap_frames)
            return
        self._reloc_failures = 0
        # hold off re-attempts until the recovery has had a chance to land
        # in the loss log
        self._reloc_next_attempt = frame_now + 2 * self.poll_every
        # patch the tracker: recovered pose, motion model at rest, and a
        # keyframe request so the next frame re-anchors the track
        T = T_wc.to(torch.float32)
        self.write_state(
            cur_pose=T, last_pose=T,
            vel=lie.identity_pose(torch.float32, self.device),
            take_kf=torch.ones((), dtype=torch.bool, device=self.device))

    def _handle_keyframe(self, frame_idx: int, slot: int, words, covis_row):
        from ..loop import closure as closure_mod

        _T = self._timed
        cfg = self.cfg
        self.frame_of_slot[slot] = frame_idx
        edges = {int(s): int(covis_row[s])
                 for s in np.nonzero(covis_row >= cfg.num_cov_threshold)[0]
                 if s != slot}
        self.covis_host[slot] = edges
        for s, w in edges.items():
            self.covis_host.setdefault(s, {})[slot] = w

        bow = vocab_mod.bow_from_words(self.voc, words)
        if not bow:
            return
        if not cfg.enable_loop_closure:
            # relocalization-only mode still needs the recognition database
            self.detector.db.insert(slot, bow)
            return
        with _T("detect"):
            candidates = self.detector.detect(
                slot, bow, edges, self._graph_sets(),
                2 * cfg.num_cov_threshold,
                essential_threshold=cfg.num_ess_threshold)
        self.loop_stats["candidates"] += len(candidates)
        if self.loop_edges and frame_idx - self._last_closure_frame \
                < cfg.loop_cooldown_frames:
            self.loop_stats["cooldown"] += len(candidates)
            return  # cooldown: the same revisit keeps re-detecting
        for cand in candidates:
            gap = frame_idx - self.frame_of_slot.get(cand, frame_idx)
            if gap <= cfg.loop_closing_time_threshold:
                self.loop_stats["too_recent"] += 1
                continue
            st = self.state
            nbrs = sorted(self.covis_host.get(cand, {}))
            with _T("sim3"):
                if cfg.sim3_solver == "horn":
                    # 3D-3D alignment of the drifted and the old landmark
                    # clouds (sim3.h:48-141): well-conditioned on
                    # depth-uniform scenes, where the PnP path has a
                    # lateral-translation / yaw ambiguity
                    ok, sim3, _scale = closure_mod.compute_sim3_horn(
                        st.kf, st.lm, slot, cand, nbrs, self.host_generator,
                        num_hypotheses=cfg.ransac_hypotheses)
                else:
                    ok, sim3 = closure_mod.compute_sim3(
                        st.kf, st.lm, slot, cand, nbrs, st.intr0,
                        self.cam_name, self.pnp_threshold,
                        self.host_generator,
                        num_hypotheses=cfg.ransac_hypotheses)
            if not ok:
                self.loop_stats["sim3_failed"] += 1
                continue
            if cfg.enable_loop_verification:
                verify = dict(px_gate=cfg.loop_verify_px,
                              threshold=cfg.match_max_dist,
                              ratio=cfg.match_next_best)
                with _T("verify"):
                    n_inl, n_vis = closure_mod.verify_loop(
                        st.kf, st.lm, slot, cand, nbrs, sim3, st.intr0,
                        self.cam_name, self.calib.width, self.calib.height,
                        **verify)
                if (n_inl < cfg.loop_verify_min_inliers
                        or n_inl < cfg.loop_verify_min_ratio
                        * max(n_vis, 1)):
                    self.loop_stats["verify_failed"] += 1
                    self.rejected_loops.append((slot, cand, n_inl, n_vis))
                    continue
                if cfg.loop_verify_min_gain > 0:
                    # identity-gain gate: reject corrections that do not
                    # beat the current poses at explaining the candidate
                    # side's structure
                    sim3_id = lie.se3_mul(lie.se3_inv(st.kf.pose_l[cand]),
                                          st.kf.pose_l[slot])
                    with _T("verify"):
                        n_id, _ = closure_mod.verify_loop(
                            st.kf, st.lm, slot, cand, nbrs, sim3_id,
                            st.intr0, self.cam_name, self.calib.width,
                            self.calib.height, **verify)
                    if n_inl < cfg.loop_verify_min_gain * max(n_id, 1):
                        self.loop_stats["no_gain"] += 1
                        self.rejected_loops.append((slot, cand, n_inl,
                                                    -n_id))
                        continue
            if not cfg.use_sim3:
                sim3 = lie.identity_pose(torch.float32, self.device)
            # late application: the stream has tracked past `slot`, so the
            # whole live gauge (slot, every newer keyframe, the tracker)
            # moves rigidly onto the old map and the pose graph bends the
            # chain between the two anchors
            newer = [s for s, f in self.frame_of_slot.items()
                     if f >= self.frame_of_slot[slot]]
            new_cur, new_last = closure_mod.corr_apply(
                st.kf.pose_l[cand], sim3, st.kf.pose_l[slot], st.cur_pose,
                st.last_pose)
            with _T("pose_graph"):
                kf2, lm2, cl_stats = closure_mod.loop_closure(
                    st.kf, st.lm, slot, cand, sim3, self.covis_host,
                    st.T_0_1, essential_threshold=cfg.num_ess_threshold,
                    live_slots=newer, huber=1.0, max_iters=20)
            # the tracker lives in the corrected gauge now (vel is relative:
            # invariant under the left world correction)
            self.write_state(kf=kf2, lm=lm2, cur_pose=new_cur,
                             last_pose=new_last)
            self.loop_edges.append((slot, cand))
            self.closure_stats.append(
                {k: v for k, v in cl_stats.items() if k.startswith("t_")})
            self.loop_stats["closed"] += 1
            self._last_closure_frame = frame_idx
            if cfg.enable_gba_after_loop:
                # a GBA already pending is superseded: its snapshot predates
                # this closure's correction
                st = self.state
                t0 = time.perf_counter()
                with _T("gba_dispatch"):
                    self._pending_gba = ba_global.dispatch_global_ba(
                        st.kf, st.lm, st.intr0, st.intr1,
                        cam_name=self.cam_name, huber=cfg.ba_huber_px,
                        max_iters=cfg.gba_max_iters,
                        cg_iters=cfg.gba_cg_iters,
                        mesh=ba_global.gba_mesh(cfg))
                stats = self._pending_gba.stats
                self.gba_stats.append(dict(
                    frame=frame_idx, iterations=int(stats["iterations"]),
                    initial_cost=float(stats["initial_cost"]),
                    final_cost=float(stats["final_cost"]),
                    seconds=time.perf_counter() - t0))
