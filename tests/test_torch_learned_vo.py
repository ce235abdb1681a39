"""The port's learned frontend trained from scratch and driving VO:
tests/test_learned_frontend.py::test_learned_frontend_drives_vo_end_to_end
through the port, on the CPU.

300 ``torch.optim.Adam`` steps at 2e-3 on the JAX test's supervised batch
(``synthetic.superpoint_training_batch``, equal to the test's
``make_training_batch``), then ``StreamingVO(feature_fn=...)`` and
``SlamSystem(feature_fn=...)`` over the JAX test's world at its
configuration deltas (``synthetic.learned_config``), with its bars: the
last loss under 0.8 of the first, tracked share after frame 3 above 0.7,
at least 3 keyframes, keyframe ATE under 1.3 m.

Those bars hold for some initializations and not others, in both
packages: over flax keys 0-7 the JAX package's run ends under 1.3 m for 3
of 8 (0.62 to 250 m); the port's, over seeds 0-15, for 9 of 16 (0.39 to
6.0 m; ``tools/learned_vo_sweep.py``). The run is one call of that tool
in a fresh interpreter: deterministic algorithms, two threads, and AVX2
code paths in place of the host's widest (see the tool), so it trains the
same weights bit for bit on every run of one torch build, whatever the
x86-64 host. Seed 0 ends at 0.42 m (VO) and 0.56 m (the faithful driver)
with torch 2.13, and at 0.59 and 0.71 m with torch 2.11 on another CPU,
where 6 of 16 seeds meet the bars.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_learned_frontend import make_training_batch
from vslam_tpu import synthetic as jsyn
from vslam_tpu_torch import synthetic

INIT_SEED = 0


def test_training_batch_is_the_jax_test_s():
    want = make_training_batch(jsyn.generate(num_frames=16, num_points=500,
                                             seed=4), [0, 2, 4, 6, 8], m=128)
    got = synthetic.superpoint_training_batch(
        synthetic.generate(num_frames=16, num_points=500, seed=4),
        [0, 2, 4, 6, 8], m=synthetic.LEARNED_POINTS)
    assert set(got) == set(want)
    for name, value in want.items():
        value = np.asarray(value)
        assert got[name].dtype == value.dtype, name
        np.testing.assert_array_equal(got[name], value, err_msg=name)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Train and drive in a fresh interpreter (module docstring): ~70 s."""
    path = str(tmp_path_factory.mktemp("learned") / "run.pt")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "tools/learned_vo_sweep.py",
                          "--seeds", str(INIT_SEED), "--out", path],
                         cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return torch.load(path, weights_only=False)


def test_training_reduces_loss(run):
    losses = run["losses"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


def test_learned_frontend_drives_streaming_vo(run):
    assert run["vo_frames"] == 16
    ok = run["vo_ok"]
    assert ok[3:].mean() > 0.7, f"learned-VO tracked {ok[3:].mean():.0%}"
    assert len(run["vo_fids"]) >= 3
    assert run["vo_ate"] < 1.3, f"learned-frontend VO ATE {run['vo_ate']:.3f} m"


def test_learned_frontend_drives_the_faithful_driver(run):
    """``SlamSystem`` on the same hook: it tracks the world. The JAX
    package sets no bar for this driver (a drive of it measured 0.73 m
    after 400 steps, ROUND5_NOTES.md); here the trajectory must stay within
    the world's scale."""
    ok = run["slam_ok"]
    assert ok[3:].mean() > 0.7, ok
    assert len(run["slam_fids"]) >= 3 and run["slam_finite"]
    assert run["slam_ate"] < 2.0, \
        f"faithful learned-frontend VO ATE {run['slam_ate']:.3f} m"
