"""Full-state checkpoint / resume.

Port of ``vslam_tpu/utils/checkpoint.py``, with its file layout: the
complete SLAM state (keyframes, landmarks with their observation tables
and descriptor banks, track state, calibration, vocabulary) in
``<path>.npz`` under ``lm.*``, ``kf.*``, ``track.*``, ``calib.*`` and
``voc.*``, and the host bookkeeping (covisibility graph, window, BoW
inverted file, consistency groups) in ``<path>.json``. A checkpoint
written by the reference's ``save`` therefore loads into the port's
``SlamSystem``: this is how a run of the reference continues in the port.

The reference's PRNG ``key`` has no meaning to torch: the port stores its
generator's state as ``torch_generator`` (with the device type it belongs
to) and, where that is absent or from another device type, seeds the
generator from ``cfg.seed``.

``load`` and ``load_stream`` restore onto the card unless the caller names
another device, and raise where there is none; the driver they restore
into must live on that device.
"""

from __future__ import annotations

import dataclasses
import json
from typing import TYPE_CHECKING

import numpy as np
import torch

from .. import interop, resolve_device
from ..config import DEVICE_TUNABLE
from ..core.state import KeyframeState, LandmarkState, TrackState
from ..loop import vocabulary as vocab_mod

if TYPE_CHECKING:
    from ..pipeline.slam import SlamSystem

_VOC_FIELDS = ("node_desc", "children", "is_leaf", "word_of_node",
               "node_of_word", "weights", "parent", "level")


def _put(arrays, prefix, tree):
    for field, val in interop.to_arrays(tree).items():
        arrays[f"{prefix}.{field}"] = np.asarray(val)


def _get(cls, data, prefix, device):
    names = [f.name for f in dataclasses.fields(cls)]
    return interop.from_arrays(
        cls, {n: data[f"{prefix}.{n}"] for n in names
              if f"{prefix}.{n}" in data}, device)


def _put_generator(arrays, name, gen: torch.Generator):
    arrays[name] = gen.get_state().cpu().numpy()
    arrays[name + ".device"] = np.asarray(gen.device.type)


def _set_generator(data, name, gen: torch.Generator, seed: int):
    if name in data and str(data[name + ".device"]) == gen.device.type:
        gen.set_state(torch.as_tensor(data[name]))
    else:
        gen.manual_seed(seed)


def _detector_host(detector) -> dict:
    return {
        "db_inverted": {str(k): v for k, v in detector.db.inverted.items()},
        "db_bow": {str(k): v for k, v in detector.db.bow_of.items()},
        "consistent_groups": [
            [sorted(g), n] for g, n in detector.consistent_groups],
    }


def _restore_detector(detector, host):
    detector.db.inverted = {
        int(k): list(v) for k, v in host["db_inverted"].items()}
    detector.db.bow_of = {
        int(k): {int(w): x for w, x in d.items()}
        for k, d in host["db_bow"].items()}
    detector.consistent_groups = [
        (set(g), n) for g, n in host["consistent_groups"]]


def _covis_from(host_covis) -> dict:
    return {int(k): {int(s): w for s, w in d.items()}
            for k, d in host_covis.items()}


def _same_device(driver, device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != driver.device.type:
        raise ValueError(f"the driver lives on {driver.device}, the "
                         f"checkpoint was asked onto {dev}")
    return driver.device


def save(slam: "SlamSystem", path: str) -> None:
    """Write <path>.npz (arrays) and <path>.json (host bookkeeping)."""
    slam._merge_pending_ba(force=True)  # settle the held window BA
    arrays = {}
    for name, tree in (("lm", slam.lm), ("kf", slam.kf),
                       ("track", slam.track)):
        _put(arrays, name, tree)
    _put_generator(arrays, "torch_generator", slam.generator)
    arrays["calib.intr0"] = slam.intr0.cpu().numpy()
    arrays["calib.intr1"] = slam.intr1.cpu().numpy()
    arrays["calib.T_0_1"] = slam.T_0_1.cpu().numpy()
    if slam.voc is not None:
        v = slam.voc
        arrays["voc.meta"] = np.asarray([v.k, v.depth])
        for f in _VOC_FIELDS:
            arrays[f"voc.{f}"] = getattr(v, f)
    np.savez_compressed(path + ".npz", **arrays)

    host = {
        "frame": slam.frame,
        "take_keyframe": slam.take_keyframe,
        "last_kf_slot": slam.last_kf_slot,
        "kf_window": slam.kf_window,
        "slot_of_frame": {str(k): v for k, v in slam.slot_of_frame.items()},
        "covis": {str(k): v for k, v in slam.covis.items()},
        "tracking_ok": slam.tracking_ok,
        "trajectory": [t.tolist() for t in slam.trajectory],
        "loop_edges": slam.loop_edges,
        "pose_graph_done": slam.pose_graph_done,
        "stats": slam.stats,
        # beyond the reference's record: what an exact resume also needs
        "lost_count": slam._lost_count,
        "last_closure_frame": slam._last_closure_frame,
        "gba_merges": slam.gba_merges,
        **_detector_host(slam.detector),
    }
    with open(path + ".json", "w") as f:
        json.dump(host, f)


def load(slam: "SlamSystem", path: str, device="cuda") -> "SlamSystem":
    """Restore state saved by ``save`` (the port's or the reference's) into
    an initialized SlamSystem of the same configuration on ``device``."""
    dev = _same_device(slam, device)
    data = np.load(path + ".npz")

    slam.lm = _get(LandmarkState, data, "lm", dev)
    slam.kf = _get(KeyframeState, data, "kf", dev)
    slam.track = _get(TrackState, data, "track", dev)
    _set_generator(data, "torch_generator", slam.generator, slam.cfg.seed)
    if "calib.intr0" in data:  # older checkpoints predate calib persistence
        slam.intr0 = torch.as_tensor(data["calib.intr0"], device=dev)
        slam.intr1 = torch.as_tensor(data["calib.intr1"], device=dev)
        slam.T_0_1 = torch.as_tensor(data["calib.T_0_1"], device=dev)
    if "voc.meta" in data:
        k, depth = (int(x) for x in data["voc.meta"])
        slam.voc = vocab_mod.from_arrays(
            dict(k=k, depth=depth,
                 **{f: data[f"voc.{f}"] for f in _VOC_FIELDS}))
        slam.device_voc = vocab_mod.DeviceVocabulary(slam.voc, dev)
    slam._pending_ba = slam._pending_gba = None

    with open(path + ".json") as f:
        host = json.load(f)
    slam.frame = host["frame"]
    slam.take_keyframe = host["take_keyframe"]
    slam.last_kf_slot = host["last_kf_slot"]
    slam.kf_window = list(host["kf_window"])
    slam.slot_of_frame = {int(k): v for k, v in host["slot_of_frame"].items()}
    slam.covis = _covis_from(host["covis"])
    slam.tracking_ok = host["tracking_ok"]
    slam.trajectory = [np.asarray(t, np.float32) for t in host["trajectory"]]
    slam.loop_edges = [tuple(e) for e in host["loop_edges"]]
    slam.pose_graph_done = host["pose_graph_done"]
    _restore_detector(slam.detector, host)
    slam.stats = host["stats"]
    slam._lost_count = host.get("lost_count", 0)
    slam._last_closure_frame = host.get("last_closure_frame", -(10 ** 9))
    slam.gba_merges = host.get("gba_merges", 0)
    return slam


def save_stream(vo, path: str) -> None:
    """Checkpoint a StreamingVO / StreamingSLAM (pipeline/streaming.py):
    the stream state (nested ``kf.*`` / ``lm.*``), the gate scalars as
    ``tune`` and the generators in the npz; StreamingSLAM's host
    bookkeeping (detector db, covisibility cache, loop edges, the keyframe
    events no poll has read yet) in the JSON sidecar. A global BA still
    held is merged first."""
    if hasattr(vo, "_merge_gba_if_ready"):
        vo._merge_gba_if_ready()
    arrays = {}
    for field, val in interop.to_arrays(vo.state).items():
        if val is None:
            continue
        if isinstance(val, dict):   # nested KeyframeState / LandmarkState
            for f2, v2 in val.items():
                arrays[f"{field}.{f2}"] = np.asarray(v2)
        else:
            arrays[field] = np.asarray(val)
    arrays["tune"] = np.asarray([vo.tune[n] for n in DEVICE_TUNABLE],
                                np.float32)
    _put_generator(arrays, "torch_generator", vo.generator)

    host = {"kind": type(vo).__name__}
    if hasattr(vo, "detector"):
        _put_generator(arrays, "torch_host_generator", vo.host_generator)
        pending = vo.events[vo._ev_consumed:]
        if pending:
            arrays["events.slot"] = torch.stack(
                [e.slot for e in pending]).cpu().numpy()
            arrays["events.words"] = torch.stack(
                [e.words for e in pending]).cpu().numpy()
            arrays["events.covis"] = torch.stack(
                [e.covis for e in pending]).cpu().numpy()
        host.update({
            "event_frames": [e.frame for e in pending],
            "covis_host": {str(k): v for k, v in vo.covis_host.items()},
            "frame_of_slot": {str(k): v for k, v in
                              vo.frame_of_slot.items()},
            "loop_edges": vo.loop_edges,
            "last_closure_frame": vo._last_closure_frame,
            "lost_mode": vo._lost_mode,
            "reloc_failures": vo._reloc_failures,
            "reloc_next_attempt": vo._reloc_next_attempt,
            "gba_merges": vo.gba_merges,
            **_detector_host(vo.detector),
        })
    np.savez_compressed(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(host, f)


def load_stream(vo, path: str, device="cuda"):
    """Restore a stream checkpoint into an initialized driver of the same
    configuration on ``device``. Returns the driver."""
    from ..pipeline.streaming import KeyframeEvent

    dev = _same_device(vo, device)
    data = np.load(path + ".npz")
    st = vo.state
    fields = {}
    for f in dataclasses.fields(st):
        val = getattr(st, f.name)
        if dataclasses.is_dataclass(val):
            fields[f.name] = _get(type(val), data, f.name, dev)
        elif torch.is_tensor(val):
            fields[f.name] = torch.as_tensor(data[f.name], device=dev)
        elif val is not None:
            fields[f.name] = int(data[f.name])
    vo.write_state(**fields)
    if "tune" in data:
        vo.tune = {n: float(v) for n, v in zip(DEVICE_TUNABLE, data["tune"])}
    _set_generator(data, "torch_generator", vo.generator, vo.cfg.seed)

    with open(path + ".json") as f:
        host = json.load(f)
    if hasattr(vo, "detector") and "db_inverted" in host:
        _set_generator(data, "torch_host_generator", vo.host_generator,
                       vo.cfg.seed + 1)
        vo.events = [
            KeyframeEvent(
                frame=frame,
                slot=torch.as_tensor(data["events.slot"][i], device=dev),
                words=torch.as_tensor(data["events.words"][i], device=dev),
                covis=torch.as_tensor(data["events.covis"][i], device=dev))
            for i, frame in enumerate(host.get("event_frames", []))]
        vo._ev_consumed = 0
        vo._pending_gba = None
        vo.covis_host = _covis_from(host["covis_host"])
        vo.frame_of_slot = {int(k): v for k, v in
                            host["frame_of_slot"].items()}
        vo.loop_edges = [tuple(e) for e in host["loop_edges"]]
        vo._last_closure_frame = host.get("last_closure_frame", -(10 ** 9))
        vo._lost_mode = host.get("lost_mode", False)
        vo._reloc_failures = host.get("reloc_failures", 0)
        vo._reloc_next_attempt = host.get("reloc_next_attempt", 0)
        vo.gba_merges = host.get("gba_merges", 0)
        _restore_detector(vo.detector, host)
    return vo
