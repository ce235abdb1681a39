"""Driver ``streaming_vo``: the port's ``StreamingVO``, one frame a call.

What a driver file gives the harness (``harness/drive.py`` calls these;
a configuration file names its driver by the file's name):

- ``make(calib, cfg, max_frames, device, **args)``: the program's driver,
  built as a user builds it (here ``cuda_graphs=None``: the step's
  bodies replay as CUDA graphs on the card, eagerly elsewhere).
- ``step(driver, frames)``: hand over ``frames`` [(left, right)] and
  return their poses [len(frames), 7] copied to the host, which is what a
  user waits for and what a frame's latency counts.
- ``results(driver)``: per-frame logs over every frame so far, numpy:
  ``is_keyframe``, ``tracked_ok``.
- ``frontend_answer(driver)``: the newest frame's left-image features as
  the program computed them inside its step: (corners [N, 2], bits [N,
  256], valid [N]) device tensors that the next step rewrites; None
  where the step computed none.
- ``keyframe_answers(driver, first_frame)``: [(frame, corners [2, N, 2],
  packed descriptors [2, N, 32], valid [2, N])] of the stored keyframes
  (left and right image) made from stream frame ``first_frame`` on.
"""

import numpy as np


def make(calib, cfg, max_frames, device, **args):
    from vslam_tpu_torch.pipeline.streaming import StreamingVO

    drv = StreamingVO(calib, cfg, max_frames=max_frames, device=device,
                      cuda_graphs=None, **args)
    # keep body T's outputs in view: with graphs they are the tensors the
    # track graph rewrites on every replay (its capture's outputs), on the
    # eager path each frame's own
    track = drv._track
    drv.observed_tracking = None

    def observed(img_l):
        out = track(img_l)
        drv.observed_tracking = out[1]
        return out

    drv._track = observed
    return drv


def step(drv, frames):
    for left, right in frames:
        drv.process_frame(left, right)
    return drv.state.cur_pose.to("cpu", copy=True)[None]


def results(drv):
    res = drv.results()
    return dict(is_keyframe=res["is_keyframe"], tracked_ok=res["tracked_ok"])


def frontend_answer(drv):
    if drv.observed_tracking is None:
        return None
    f = drv.observed_tracking.res.feats
    return f.corners, f.bits, f.valid


def keyframe_answers(drv, first_frame):
    kf = drv.state.kf
    fid = kf.frame_id.cpu().numpy()
    slots = np.nonzero(kf.valid.cpu().numpy() & (fid >= first_frame))[0]
    return [(int(fid[s]), kf.corners[s].cpu(), kf.desc[s].cpu(),
             kf.kp_valid[s].cpu()) for s in slots]
