"""The port's StreamingSLAM reads its logs and attempts relocalization on
the JAX package's schedule.

Both packages' own ``StreamingSLAM.run`` go over a scripted loss log: the
frame step is replaced by one that logs the script's tracked / lost flag
for the frame and advances the frame count (no image is tracked, no step
is compiled), and ``relocalize`` by one that records the attempt's
``frames_lost`` and motion gate (each package's own ``relocalize`` on a
detector with no candidates computes the gate) and returns the script's
outcome for that attempt. At the same ``(poll_every, chunk)`` the two
drivers must read the logs at the same frame counts (lagged reads apart
from reads of the current state) and attempt on the same frames with the
same ``frames_lost`` and gate, for chunk 1, 4 and 8, a sustained loss
and a loss that recovers and returns within the backoff, with every
attempt failing (so that the backoff's frames are held too) or the
second one accepted.

The JAX driver's lagged read backs its stride off while its fetches wait
long; the tests pin that stride to 1 (``_stride_limit = 1``), the port's
schedule. The runs are split as the benchmark splits them: 32 frames, a
poll, then the rest (a tail shorter than a chunk at chunk 8).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_streaming import small_config
from vslam_tpu import synthetic as jsynthetic
from vslam_tpu.loop import relocalize as jreloc
from vslam_tpu.loop import vocabulary as jvocab
from vslam_tpu.pipeline.streaming import StreamingSLAM as JaxSLAM
from vslam_tpu_torch import synthetic as tsynthetic
from vslam_tpu_torch.loop import relocalize as treloc
from vslam_tpu_torch.loop import vocabulary as tvocab
from vslam_tpu_torch.pipeline.streaming import StreamingSLAM

N_FRAMES = 100
POLL_EVERY = 16
SPLIT = 32


def loss_script(shape):
    """Tracked flags per frame: ``sustained`` loses frames 40-81;
    ``returns`` loses 30-36, tracks 37-38 and loses 39-69 again, inside
    the 16-frame backoff of a failed attempt."""
    ok = np.ones(N_FRAMES, bool)
    if shape == "sustained":
        ok[40:82] = False
    else:
        ok[30:37] = False
        ok[39:70] = False
    return ok


def slam_config():
    cfg = small_config()
    cfg.enable_relocalization = True
    cfg.enable_loop_closure = True
    return cfg


class NoCandidates:
    """A detector whose database offers no relocalization candidate: the
    real ``relocalize`` then returns its diagnostics (with the gate) at
    once."""

    def relocalization_candidates(self, bow, max_candidates):
        return []


def scripted_relocalize(inner, accepted, attempts):
    """``relocalize`` recording (frames_lost, gate) of each attempt and
    returning the attempt's scripted outcome (the current pose on
    acceptance)."""

    def fake(kf, lm, detector, bits, valid, corners, bow, graph, cur, vel,
             *args, **kw):
        _, _, _, diag = inner(kf, lm, NoCandidates(), bits, valid, corners,
                              bow, graph, cur, vel, *args, **kw)
        ok = len(attempts) in accepted
        attempts.append((kw["frames_lost"], diag["gate"]))
        return ok, (cur if ok else None), [], diag

    return fake


@functools.lru_cache(maxsize=None)
def world(backend):
    """(calibration, vocabulary) of a small world, for ``backend``'s
    driver: the scripted runs need no more of either."""
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 2, (600, 256)).astype(np.uint8)
    synthetic, vocab = ((jsynthetic, jvocab) if backend == "jax" else
                        (tsynthetic, tvocab))
    return (synthetic.generate(num_frames=2, num_points=50, seed=3).calib,
            vocab.train(bits, k=4, depth=2, seed=0))


def features(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 2, (n, 256)).astype(np.uint8),
            rng.uniform(0, 200, (n, 2)).astype(np.float32))


def drive(slam, calls, frames):
    """``calls``: ("run", k) runs the next k frames, ("poll",) polls."""
    at = 0
    for call in calls:
        if call[0] == "poll":
            slam.poll()
        else:
            slam.run(frames[at:at + call[1]])
            at += call[1]


BENCH_CALLS = (("run", SPLIT), ("poll",), ("run", N_FRAMES - SPLIT))


def jax_schedule(script, chunk, accepted, monkeypatch,
                 poll_every=POLL_EVERY, calls=BENCH_CALLS, cfg=None):
    """(reads [(n, lagged)], attempts [(frame, frames_lost, gate, ok)]) of
    the JAX package's driver over ``script``, run by ``calls``; attempt i
    is accepted where i is in ``accepted``."""
    calib, voc = world("jax")
    slam = JaxSLAM(calib, cfg or slam_config(), voc,
                   max_frames=len(script) + 8, poll_every=poll_every,
                   chunk=chunk)
    slam._stride_limit = 1
    bits, corners = features(slam.cfg.num_features)
    slam.state = slam.state._replace(
        cur_bits=jnp.asarray(bits), cur_corners=jnp.asarray(corners),
        cur_valid=jnp.ones(slam.cfg.num_features, bool))
    slam.detector.db.insert(0, {0: 1.0})
    ok_log = jnp.asarray(script)

    def advance(state, k):
        f = int(state.frame)
        return state._replace(
            frame=jnp.asarray(f + k, state.frame.dtype),
            log_ok=state.log_ok.at[f:f + k].set(ok_log[f:f + k]))

    if chunk > 1:
        def step(state, batch):
            state = advance(state, len(batch))
            return state, slam._pack_poll(state)
    else:
        def step(state, pair):
            return advance(state, 1)
    slam._step = step
    slam._single_step = lambda: (lambda state, pair: advance(state, 1))
    slam._pack_chunk = np.asarray

    reads = []
    consume = slam._consume_poll_blob

    def recording(blob, stale=False):
        reads.append((int(np.asarray(blob)[0]), stale))
        return consume(blob, stale)

    slam._consume_poll_blob = recording
    attempts = []
    monkeypatch.setattr(jreloc, "relocalize", scripted_relocalize(
        jreloc.relocalize, accepted, attempts))
    drive(slam, calls, np.arange(len(script)))
    return reads, [(f, *a, ok) for (f, ok), a in zip(slam.reloc_events,
                                                     attempts)]


def port_schedule(script, chunk, accepted, monkeypatch):
    """The same as ``jax_schedule``, of the port's driver."""
    calib, voc = world("torch")
    slam = StreamingSLAM(calib, slam_config(), voc, max_frames=N_FRAMES + 8,
                         poll_every=POLL_EVERY, chunk=chunk, device="cpu")
    bits, corners = features(slam.cfg.num_features)
    slam.state = slam.state.replace(
        cur_bits=torch.as_tensor(bits), cur_corners=torch.as_tensor(corners),
        cur_valid=torch.ones(slam.cfg.num_features, dtype=torch.bool))
    slam.detector.db.insert(0, {0: 1.0})

    def step(img_l, img_r):
        st = slam.state
        st.log_ok[st.frame] = bool(script[st.frame])
        slam.state = st.replace(frame=st.frame + 1)

    slam.process_frame = step
    reads = []
    poll_at = slam._poll_at

    def recording(n, stale=False):
        reads.append((n, stale))
        return poll_at(n, stale)

    slam._poll_at = recording
    attempts = []
    monkeypatch.setattr(treloc, "relocalize", scripted_relocalize(
        treloc.relocalize, accepted, attempts))
    drive(slam, BENCH_CALLS, [(None, None)] * N_FRAMES)
    return reads, [(f, *a, ok) for (f, ok), a in zip(slam.reloc_events,
                                                     attempts)]


@pytest.mark.parametrize("accepted", [(), (1,)], ids=["all_fail",
                                                      "second_ok"])
@pytest.mark.parametrize("shape", ["sustained", "returns"])
@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_attempts_on_the_jax_frames(monkeypatch, chunk, shape, accepted):
    script = loss_script(shape)
    reads_j, att_j = jax_schedule(script, chunk, set(accepted), monkeypatch)
    reads_t, att_t = port_schedule(script, chunk, set(accepted), monkeypatch)
    assert reads_t == reads_j
    assert len(att_j) >= 2, att_j   # a backoff lies between attempts
    assert [a[:2] for a in att_t] == [a[:2] for a in att_j]
    assert [a[3] for a in att_t] == [a[3] for a in att_j]
    np.testing.assert_allclose([a[2] for a in att_t],
                               [a[2] for a in att_j], rtol=1e-6)
    # every attempt came at a read of the current state
    assert all((f, False) in reads_j for f, *_ in att_j)
    if chunk == 1:
        # no lost mode: reads only every poll_every frames of a run call
        # and at its end
        assert {n for n, _ in reads_j} <= {16, 32, 48, 64, 80, 96, 100}


def test_chunk_must_divide_poll_every():
    for backend, driver, kw in (("torch", StreamingSLAM, dict(device="cpu")),
                                ("jax", JaxSLAM, {})):
        calib, voc = world(backend)
        with pytest.raises(ValueError, match="multiple of chunk"):
            driver(calib, slam_config(), voc, poll_every=16, chunk=6, **kw)
