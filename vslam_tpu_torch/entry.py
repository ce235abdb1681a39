"""Driver entry points: the single-device tracking step and the
multi-device dryrun.

Port of ``__graft_entry__.py``. ``entry()`` returns the fused per-frame
tracking step (detect / describe -> project -> gated Hamming matching, the
landmark top-2 kernel on the card -> RANSAC PnP -> motion gate) with
example arguments. ``dryrun_multichip(n)`` runs three programs on an
n-entry mesh (``parallel/mesh.py``), at the reference's shapes:

1. batched multi-sequence tracking, the sequences split over 'data', one
   intrinsics row per sequence;
2. the sharded global BA (LM-CG, the observations split over 'data');
3. one training step of the SuperPoint frontend on a (data, model) mesh
   (n >= 4; (data,) below), with both of the reference's splits:

   - the batch over 'data'. The reference's step is one program, so its
     loss is the whole batch's loss; ``descriptor_loss`` divides by the
     batch's valid counts, and a mean of per-shard losses would be another
     function. So each 'data' entry runs the forward on its shard, the
     outputs are concatenated, and the loss is taken once;
   - the output channels of the wide convolutions over 'model'. A
     convolution whose output channels divide over the axis and number at
     least 32 (the reference's ``param_spec`` rule) computes one slice of
     them on each entry of the axis, and the slices are concatenated. On
     one device this is the same function.

The mesh is single-controller, as everywhere in the port: one process
drives every entry, and autograd carries the gradients of every entry's
copies back to the one set of parameters. Where the process has at least
n cards the mesh is n cards; otherwise it lists the one device n times,
so the split code runs where there is one card or none. The reference's
subprocess with a scrubbed environment and its virtual CPU mesh exist only
to keep its TPU plugin from hanging the run, and have no counterpart.

Everything runs on the card unless given ``device="cpu"``, and raises
without one:

    python -m vslam_tpu_torch.entry [n] [--entry] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time

import torch
import torch.nn.functional as F

from . import resolve_device
from .core.state import LandmarkState, init_landmarks, map_tensors
from .geometry import cameras, lie
from .models import superpoint
from .parallel import multiseq, sharded_ba
from .parallel.mesh import Mesh, make_mesh
from .pipeline import tracking
from .solvers.ba import BAProblem
from .utils.profiling import sync

_H, _W = 96, 128


def _lm_state(pos, bank_bits) -> LandmarkState:
    """A table of L valid, active landmarks at ``pos`` [L, 3], each with
    the B-slot bank ``bank_bits`` [L, B, 256] (every slot valid), on their
    device: ``_small_lm_state``'s table from given arrays."""
    L, B = bank_bits.shape[:2]
    dev = pos.device
    return dataclasses.replace(
        init_landmarks(L, M=8, M2=8, B=B, device=dev),
        pos=pos.to(torch.float32),
        valid=torch.ones((L,), dtype=torch.bool, device=dev),
        active=torch.ones((L,), dtype=torch.bool, device=dev),
        bank_bits=bank_bits.to(torch.uint8),
        bank_valid=torch.ones((L, B), dtype=torch.bool, device=dev))


def _small_lm_state(L: int = 512, B: int = 2, generator=None,
                    device="cuda", spread: float = 2.0,
                    depth: float = 5.0) -> LandmarkState:
    """L landmarks uniform in [-spread, spread]^3 about (0, 0, depth), with
    random {0,1} banks of B slots, drawn from ``generator`` (a CPU
    generator; seed 0 by default) and placed on ``device``."""
    g = generator or torch.Generator().manual_seed(0)
    pos = (torch.rand((L, 3), generator=g) * (2 * spread) - spread
           + torch.tensor([0.0, 0.0, depth]))
    bank = torch.randint(0, 2, (L, B, 256), generator=g, dtype=torch.uint8)
    dev = resolve_device(device)
    return _lm_state(pos.to(dev), bank.to(dev))


def _intr(device="cpu"):
    return torch.tensor([110.0, 110.0, _W / 2, _H / 2, 0, 0, 0, 0],
                        device=device)


def entry(device="cuda", generator=None):
    """(fn, example_args) for the fused tracking step on one device.

    ``fn(img, lm, predicted, gate, vel, intr0, sample_idx=None)`` is
    ``tracking.track_frame`` at pinhole, 128 features, 256 in-view slots,
    128x96 and 64 hypotheses; its RANSAC draws come from a generator on
    ``device`` bound into it, or from ``sample_idx`` [64, 6]. The
    arguments are a random uint8 image, ``_small_lm_state()``, identity
    poses and ``_intr()``, drawn from ``generator`` (a CPU generator; seed
    0 by default), so that they are the same on every device."""
    dev = resolve_device(device)
    g = generator or torch.Generator().manual_seed(0)
    img = torch.randint(0, 255, (_H, _W), generator=g).to(torch.uint8)
    lm = _small_lm_state(generator=g, device=dev)
    ransac = torch.Generator(dev).manual_seed(
        int(torch.randint(2 ** 31, (), generator=g)))
    fn = functools.partial(
        tracking.track_frame, cam_name="pinhole", num_features=128,
        inview_cap=256, width=_W, height=_H, num_hypotheses=64,
        generator=ransac)
    pose = lie.identity_pose(device=dev)
    return fn, (img.to(dev), lm, pose, pose, pose, _intr(dev))


def _mesh_devices(n: int, dev: torch.device) -> list:
    """n cards where the process has that many, else ``dev`` n times (a
    card by its index: generators report theirs so)."""
    if dev.type == "cuda":
        if torch.cuda.device_count() >= n:
            return [torch.device("cuda", i) for i in range(n)]
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return [dev] * n


def data_mesh(n: int, device="cuda") -> Mesh:
    """The dryrun's n-entry ('data',) mesh: n cards where the process has
    that many, else ``device`` n times."""
    return make_mesh(n, axes=("data",),
                     devices=_mesh_devices(n, resolve_device(device)))


# ---------------------------------------------------------------------------
# 1. batched tracking
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchedStep:
    """A batched tracking step's sizes: H x W images; L landmarks of B
    bank slots, uniform within +-spread of (0, 0, depth); a pinhole camera
    with fx = fy = f at the image centre; ``track_frame``'s budgets."""
    H: int
    W: int
    L: int
    spread: float
    depth: float
    f: float
    num_features: int
    inview_cap: int
    num_hypotheses: int
    B: int = 2


# the reference dryrun's step (the fast-test end-to-end size)
DRYRUN_STEP = BatchedStep(H=240, W=320, L=1024, spread=2.0, depth=5.0,
                          f=240.0, num_features=400, inview_cap=512,
                          num_hypotheses=64)
# tests/test_multichip_scale.py's EuRoC-scale step
FULL_WIDTH_STEP = BatchedStep(H=480, W=752, L=4096, spread=4.0, depth=6.0,
                              f=380.0, num_features=1500, inview_cap=2048,
                              num_hypotheses=128)


def multiseq_inputs(n: int, step: BatchedStep = DRYRUN_STEP, seed: int = 1,
                    device="cuda"):
    """(imgs [S,H,W] uint8, lm, poses [S,7], intr0 [S,8]) for S = n
    sequences at ``step``'s sizes, drawn from ``seed`` on the CPU: random
    images, one ``_small_lm_state`` for every sequence, identity poses."""
    S, H, W = n, step.H, step.W
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    imgs = torch.randint(0, 255, (S, H, W), generator=g).to(torch.uint8)
    lm = map_tensors(_small_lm_state(L=step.L, B=step.B, generator=g,
                                     device=dev, spread=step.spread,
                                     depth=step.depth),
                     lambda x: torch.stack([x] * S))
    pose = lie.identity_pose(device=dev).repeat(S, 1)
    intr = torch.tensor([step.f, step.f, W / 2, H / 2, 0, 0, 0, 0],
                        device=dev).repeat(S, 1)
    return imgs.to(dev), lm, pose, intr


def multiseq_step(mesh: Mesh, inputs=None, step: BatchedStep = DRYRUN_STEP,
                  sample_idx=None):
    """The batched tracking step at ``step``'s budgets over ``mesh``'s
    'data' axis, on ``multiseq_inputs`` for one sequence per entry (or
    ``inputs``, the same tuple); raises on a non-finite pose. The draws:
    ``sample_idx`` [S, hypotheses, 6], else a generator on the mesh's
    first device where every 'data' entry is that device, else each
    device's own."""
    devs = mesh.axis_devices("data")
    home = devs[0]
    imgs, lm, pose, intr = inputs or multiseq_inputs(len(devs), step,
                                                     device=home)
    run = multiseq.batched_track_frame(
        mesh, "pinhole", num_features=step.num_features,
        inview_cap=step.inview_cap, width=imgs.shape[-1],
        height=imgs.shape[-2], num_hypotheses=step.num_hypotheses)
    gen = None
    if sample_idx is None and all(d == home for d in devs):
        gen = torch.Generator(home).manual_seed(2)
    out = run(imgs, lm, pose, pose, pose, intr, generator=gen,
              sample_idx=sample_idx)
    if not bool(torch.isfinite(out.T_w_c).all()):
        raise RuntimeError("dryrun: batched tracking gave a non-finite pose")
    return out


# ---------------------------------------------------------------------------
# 2. sharded global BA
# ---------------------------------------------------------------------------

def _ba_problem(n: int, device="cuda") -> BAProblem:
    """K = 128 cameras along x, L = 2048 points about (0, 0, 6) perturbed
    by 1 cm, O = max(1024 n, 8192) exact pinhole observations; the first
    two cameras fixed."""
    K, L = 128, 2048
    O = max(n * 1024, 8192)
    g = torch.Generator().manual_seed(3)
    points = (torch.rand((L, 3), generator=g) * 4.0 - 2.0
              + torch.tensor([0.0, 0.0, 6.0]))
    poses = lie.identity_pose().repeat(K, 1)
    poses[:, 0] = torch.linspace(0, 1.0, K)
    obs_cam = torch.randint(0, K, (O,), generator=g)
    obs_point = torch.randint(0, L, (O,), generator=g)
    pc = lie.se3_apply(lie.se3_inv(poses[obs_cam]), points[obs_point])
    prob = BAProblem(
        poses=poses, pose_fixed=torch.arange(K) < 2,
        intr=_intr().repeat(K, 1),
        points=points + 0.01 * torch.randn((L, 3), generator=g),
        point_valid=torch.ones((L,), dtype=torch.bool),
        obs_cam=obs_cam.to(torch.int32), obs_point=obs_point.to(torch.int32),
        obs_uv=cameras.project("pinhole", _intr(), pc),
        obs_valid=torch.ones((O,), dtype=torch.bool))
    dev = resolve_device(device)
    return map_tensors(prob, lambda x: x.to(dev))


def _dryrun_sharded_ba(mesh: Mesh, n: int, prob: BAProblem = None):
    """Two LM iterations of five CG steps each on ``_ba_problem(n)`` (or
    ``prob``), the observations split over ``mesh``'s 'data' axis; the
    cost must not rise. Returns the solver's stats."""
    if prob is None:
        prob = _ba_problem(n, device=mesh.axis_devices("data")[0])
    _, _, stats = sharded_ba.solve_sharded(prob, mesh, cam_name="pinhole",
                                           max_iters=2, cg_iters=5)
    if not float(stats["final_cost"]) <= float(stats["initial_cost"]) + 1e-3:
        raise RuntimeError(f"dryrun: the sharded BA's cost rose from "
                           f"{float(stats['initial_cost'])} to "
                           f"{float(stats['final_cost'])}")
    return stats


# ---------------------------------------------------------------------------
# 3. the SuperPoint training step, split over (data, model)
# ---------------------------------------------------------------------------

def _split_conv(conv, x, row):
    """``conv`` on ``x`` (on ``row[0]``) with its output channels split
    over the devices of ``row`` (one 'data' entry's 'model' axis) where
    their count divides over them and is at least 32: each device computes
    its slice of the weight and bias, and the slices are concatenated on
    x's device."""
    m = len(row)
    if conv.out_channels % m or conv.out_channels < 32:
        m = 1
    return torch.cat([
        F.conv2d(x.to(d), w.to(d), b.to(d), padding=conv.padding).to(
            x.device)
        for d, w, b in zip(row, conv.weight.chunk(m), conv.bias.chunk(m))],
        dim=1)


def split_forward(model: superpoint.SuperPointTPU, mesh: Mesh):
    """``model``'s forward over ``mesh``: the batch split over the 'data'
    entries (a contiguous shard each), the wide convolutions' output
    channels over each entry's 'model' axis (``_split_conv``); the logits
    and descriptors of the whole batch come back on the mesh's first
    device."""
    home = mesh.devices.flat[0]
    rows = [list(r) for r in mesh.devices.reshape(mesh.shape["data"], -1)]

    def forward(x):
        outs = [model(part.to(row[0]),
                      conv=functools.partial(_split_conv, row=row))
                for row, part in zip(rows, x.tensor_split(len(rows)))]
        return tuple(torch.cat([o[i].to(home) for o in outs])
                     for i in range(2))

    return forward


def _train_mesh(n: int, dev: torch.device) -> Mesh:
    return make_mesh(n, axes=("data", "model") if n >= 4 else ("data",),
                     devices=_mesh_devices(n, dev))


def _dryrun_train_step(n: int, device="cuda", model=None, batch=None):
    """One Adam step (lr 1e-3) of ``SuperPointTPU(dim=64, width=16)`` on a
    ``synthetic_batch`` of one 32x32 pair per 'data' entry (8
    correspondences), split over ``_train_mesh(n)`` (``split_forward``);
    ``model`` and ``batch`` replace the drawn ones. Returns (the loss before
    the step, the model, whose ``.grad`` hold the step's gradients)."""
    dev = resolve_device(device)
    mesh = _train_mesh(n, dev)
    g = torch.Generator().manual_seed(4)
    if model is None:
        model = superpoint.SuperPointTPU(dim=64, width=16, generator=g)
    if batch is None:
        batch = superpoint.synthetic_batch(g, batch=mesh.shape["data"],
                                           h=32, w=32, m=8)
    home = mesh.devices.flat[0]
    model = model.to(home)
    step = superpoint.make_train_step(
        split_forward(model, mesh),
        torch.optim.Adam(model.parameters(), lr=1e-3))
    loss = step({k: v.to(home) for k, v in batch.items()})
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("dryrun: the training step's loss is not finite")
    return loss, model


def dryrun_multichip(n: int, device="cuda") -> dict:
    """The three programs (module docstring) on an n-entry mesh. Returns
    each one's result and its wall ms (host clock, ended by a
    synchronize): ``poses`` [n, 7], ``ba`` (stats), ``loss``, and
    ``{multiseq,sharded_ba,train_step}_ms``."""
    dev = resolve_device(device)
    mesh = data_mesh(n, dev)
    out = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        sync(dev)
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        return result

    out["poses"] = timed("multiseq", lambda: multiseq_step(mesh)).T_w_c
    out["ba"] = timed("sharded_ba", lambda: _dryrun_sharded_ba(mesh, n))
    out["loss"] = timed("train_step",
                        lambda: _dryrun_train_step(n, dev)[0])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--entry", action="store_true",
                    help="also run entry()'s tracking step once")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    print(f"dryrun_multichip({args.n}) OK")
    if args.entry:
        fn, example = entry(args.device)
        out = fn(*example)
        print("entry OK; pose:", out.T_w_c.cpu().numpy())


if __name__ == "__main__":
    main()
