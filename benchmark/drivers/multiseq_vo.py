"""Driver ``multiseq_vo``: the port's ``MultiSeqVO``, S rigs in lockstep,
one lockstep frame a call.

The functions ``drivers/streaming_vo.py`` documents, over a stream that
interleaves the rigs in the order of trajectory kind ``fleet``: stream
frame ``S t + j`` is rig ``(t + j + 1) mod S`` at lockstep frame ``t``
(``fleet.rig_at``), so a call's ``frames_per_call`` = S frames are one
lockstep frame, and its newest frame is rig ``t mod S``'s.

- ``make(..., num_sequences)``: ``MultiSeqVO`` with ``cuda_graphs=None``
  (the lockstep bodies replay as CUDA graphs on the card, eagerly
  elsewhere), its logs ``max_frames / S`` lockstep frames long.
- ``step``: the S pairs handed over in one call, each to its rig, their
  S poses back in stream order.
- ``results``: ``is_keyframe`` and ``tracked_ok`` of every stream frame,
  in stream order.
- ``frontend_answer``: the left features of the call's newest stream
  frame (rig ``t mod S``) as the batched tracking computed them, so that
  the sampled calls check every rig's tracking in turn.
- ``keyframe_answers``: every rig's stored keyframes, each labelled with
  the stream frame of its rig's lockstep frame.
- ``counters``: keyframes and window BAs per rig over the run, and the
  graphs captured.
"""

import numpy as np

from harness import cells


def _fleet():
    return cells.module("trajectories", "fleet")


def make(calib, cfg, max_frames, device, num_sequences):
    from vslam_tpu_torch.parallel.multiseq_runner import MultiSeqVO

    drv = MultiSeqVO(calib, num_sequences, cfg,
                     max_frames=-(-max_frames // num_sequences),
                     device=device, cuda_graphs=None)
    # keep the batched tracking's outputs in view: with graphs they are
    # the tensors the tracking graph rewrites on every replay (its
    # capture's outputs), on the eager path each frame's own
    track = drv._track_body
    drv.observed_tracking = None

    def observed(*args, **kwargs):
        out = track(*args, **kwargs)
        drv.observed_tracking = out[1]
        return out

    drv._track_body = observed
    return drv


def step(drv, frames):
    S = drv.S
    if len(frames) != S:
        raise ValueError(f"a call hands over one lockstep frame of {S} "
                         f"pairs, got {len(frames)}")
    t = drv.state.frame
    j = _fleet().stream_index(np.arange(S), t, S) - S * t   # rig -> slot
    drv.process_frames(np.stack([frames[i][0] for i in j]),
                       np.stack([frames[i][1] for i in j]))
    rigs, _ = _fleet().rig_at(S * t + np.arange(S), S)       # slot -> rig
    return drv.state.pose.to("cpu", copy=True)[rigs]


def results(drv):
    res = drv.results()
    S, T = res["is_keyframe"].shape
    idx = _fleet().stream_index(np.arange(S)[:, None], np.arange(T)[None],
                                S)
    out = {}
    for name in ("is_keyframe", "tracked_ok"):
        out[name] = np.empty(S * T, res[name].dtype)
        out[name][idx] = res[name]
    return out


def frontend_answer(drv):
    if drv.observed_tracking is None:
        return None
    s = (drv.state.frame - 1) % drv.S
    f = drv.observed_tracking.res.feats
    return f.corners[s], f.bits[s], f.valid[s]


def keyframe_answers(drv, first_frame):
    kf = drv.state.kf
    S = drv.S
    fid = kf.frame_id.cpu().numpy().astype(np.int64)
    valid = kf.valid.cpu().numpy()
    out = []
    for s in range(S):
        stream = _fleet().stream_index(s, fid[s], S)
        for slot in np.nonzero(valid[s] & (stream >= first_frame))[0]:
            out.append((int(stream[slot]), kf.corners[s, slot].cpu(),
                        kf.desc[s, slot].cpu(), kf.kp_valid[s, slot].cpu()))
    return sorted(out, key=lambda a: a[0])


def counters(drv):
    kf = drv.results()["is_keyframe"]
    bas = np.bincount([i.ba_seq for i in drv.infos if i.ba_seq is not None],
                      minlength=drv.S)
    return dict(lockstep_frames=drv.state.frame,
                keyframes_per_rig=kf.sum(1).tolist(),
                window_bas_per_rig=bas.tolist(),
                graphs=len(getattr(drv, "_graphs", {})))
