"""The port's CUDA kernels on the card (marked ``cuda``; skipped without a
CUDA device). The file imports no JAX, so it also runs on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each hand-written kernel must equal its plain PyTorch version exactly (the
outputs are integers), at the main path's shapes and at ragged and
all-invalid shapes, and the dispatchers must route CUDA tensors through
the kernels.
"""

import numpy as np
import pytest
import torch

from vslam_tpu_torch.ops import cuda_hamming, hamming

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda_hamming.build()
    return torch.device("cuda")


def top2_inputs(rng, n, m, dev, valid=0.9):
    a = rng.randint(0, 2, (n, 256)).astype(np.uint8)
    b = rng.randint(0, 2, (m, 256)).astype(np.uint8)
    if n and m:
        src = rng.randint(0, n, m // 2)
        flip = rng.rand(m // 2, 256) < 0.05
        b[: m // 2] = np.where(flip, 1 - a[src], a[src])
    return tuple(torch.as_tensor(x, device=dev) for x in
                 (a, b, rng.rand(n) < valid, rng.rand(m) < valid))


def landmark_inputs(rng, n, p, nb, dev, lm_valid=0.9, bank_valid=0.7):
    kp = rng.randint(0, 2, (n, 256)).astype(np.uint8)
    src = rng.randint(0, max(n, 1), (p, nb))
    flip = rng.rand(p, nb, 256) < 0.08
    bank = np.where(flip, 1 - kp[src], kp[src]).astype(np.uint8)
    kxy = (rng.rand(n, 2) * [752, 480]).astype(np.float32)
    lxy = (kxy[src[:, 0]] + rng.normal(0, 15, (p, 2))).astype(np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in
                 (kp, rng.rand(n) < 0.95, kxy, bank,
                  rng.rand(p, nb) < bank_valid, lxy,
                  rng.rand(p) < lm_valid)) + (20.0,)


def assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("n,m,valid", [(1500, 1500, 0.95), (130, 600, 0.9),
                                       (1, 129, 0.5), (257, 0, 0.9),
                                       (64, 64, 0.0)])
def test_hamming_top2_kernel_equals_plain(dev, n, m, valid):
    args = top2_inputs(np.random.RandomState(n + m), n, m, dev, valid)
    assert_equal(cuda_hamming.hamming_top2(*args),
                 hamming.hamming_top2_plain(*args))


@pytest.mark.parametrize("n,p,nb,lm_valid,bank_valid", [
    (1500, 2048, 4, 0.9, 0.7), (100, 300, 4, 0.9, 0.8),
    (129, 513, 3, 0.5, 0.5), (7, 0, 4, 0.9, 0.7), (64, 256, 4, 0.0, 0.7),
    (64, 256, 4, 0.9, 0.0)])
def test_landmark_top2_kernel_equals_plain(dev, n, p, nb, lm_valid,
                                           bank_valid):
    args = landmark_inputs(np.random.RandomState(n + p), n, p, nb, dev,
                           lm_valid, bank_valid)
    assert_equal(cuda_hamming.landmark_top2(*args),
                 hamming.landmark_top2_plain(*args))


def test_dispatch_launches_kernels(dev):
    rng = np.random.RandomState(0)
    a, b, va, vb = top2_inputs(rng, 300, 280, dev)
    before = dict(cuda_hamming.LAUNCHES)
    got = hamming.match_descriptors(a, b, va, vb)
    want = hamming.match_descriptors(a.cpu(), b.cpu(), va.cpu(), vb.cpu())
    assert cuda_hamming.LAUNCHES["hamming_top2"] == \
        before["hamming_top2"] + 2
    assert_equal(got, want)
    args = landmark_inputs(rng, 400, 512, 4, dev)
    got = hamming.match_landmarks(args[0], args[1], args[3], args[4],
                                  args[2], args[5], args[6])
    cpu = [x.cpu() for x in args[:7]]
    want = hamming.match_landmarks(cpu[0], cpu[1], cpu[3], cpu[4], cpu[2],
                                   cpu[5], cpu[6])
    assert cuda_hamming.LAUNCHES["landmark_top2"] == \
        before["landmark_top2"] + 1
    assert_equal(got, want)
