"""SuperPoint-style learned feature frontend (``torch.nn``).

Port of ``vslam_tpu/models/superpoint.py``. A compact VGG-style encoder
with a detector head (65-way cell softmax over 8x8 pixel cells, incl.
dustbin) and a descriptor head (D-dim, L2-normalized), trained on the
synthetic generator's exact corner/correspondence ground truth.
Descriptors are binarized (sign -> bits) to drop into the Hamming matching
path (``models/learned_frontend.py``).

The module takes and returns the reference's NHWC layout (images
[B, H, W, 1], logits [B, H/8, W/8, 65], descriptors [B, H/8, W/8, D]) and
computes in NCHW inside. Its parameters start as flax's defaults do
(LeCun-normal kernels, truncated at two standard deviations; zero
biases); ``from_flax_params`` carries a flax parameter tree across. The
convolutions are ``F.conv2d``: the reference computes them with XLA, not
in a Pallas kernel.

The training step is one loss, ``backward`` and a ``torch.optim.Adam``
step, which is ``optax.adam``'s update (eps added after the square root,
the same bias corrections).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CELL = 8


def _call(conv: nn.Conv2d, x):
    return conv(x)


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    # flax "SAME" for a 3x3 stride-1 convolution pads one pixel each side
    return nn.Conv2d(cin, cout, k, padding=k // 2)


class ConvBlock(nn.Module):
    """Two 3x3 convolutions, each followed by a ReLU."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv0 = _conv(cin, features, 3)
        self.conv1 = _conv(features, features, 3)

    def forward(self, x, conv=_call):
        return F.relu(conv(self.conv1, F.relu(conv(self.conv0, x))))


class SuperPointTPU(nn.Module):
    """Encoder + detector/descriptor heads. Input [B, H, W, 1] in [0, 1];
    returns (logits [B, H/8, W/8, 65], desc [B, H/8, W/8, dim]).
    ``forward(x, conv)`` applies every convolution as ``conv(module, x)``
    (``entry.split_forward`` splits some over devices)."""

    def __init__(self, dim: int = 256, width: int = 64,
                 generator: torch.Generator = None):
        super().__init__()
        w = width
        self.dim, self.width = dim, width
        self.blocks = nn.ModuleList([
            ConvBlock(1, w), ConvBlock(w, w), ConvBlock(w, 2 * w),
            ConvBlock(2 * w, 2 * w)])
        self.det0 = _conv(2 * w, 4 * w, 3)
        self.det1 = _conv(4 * w, CELL * CELL + 1, 1)   # 65-way per cell
        self.desc0 = _conv(2 * w, 4 * w, 3)
        self.desc1 = _conv(4 * w, dim, 1)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator = None):
        """flax's ``nn.Conv`` defaults: LeCun-normal kernels (variance
        1 / fan_in, truncated at two standard deviations), zero biases."""
        with torch.no_grad():
            for conv in self.convs():
                fan_in = conv.weight[0].numel()
                # the truncated normal's std is 0.8796 of its parameter's
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                conv.bias.zero_()

    def convs(self):
        """The convolutions in flax's naming order: each block's two, then
        the heads' in call order (detector 3x3, 1x1, descriptor 3x3,
        1x1)."""
        out = []
        for block in self.blocks:
            out += [block.conv0, block.conv1]
        return out + [self.det0, self.det1, self.desc0, self.desc1]

    def forward(self, x, conv=_call):
        x = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
        for i, block in enumerate(self.blocks):
            x = block(x, conv)
            if i < 3:
                x = F.max_pool2d(x, 2, 2)
        feat = x                                        # [B, 2w, H/8, W/8]
        logits = conv(self.det1, F.relu(conv(self.det0, feat)))
        desc = conv(self.desc1, F.relu(conv(self.desc0, feat)))
        desc = desc / (torch.linalg.vector_norm(desc, dim=1, keepdim=True)
                       + 1e-8)
        return logits.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)


def from_flax_params(model: SuperPointTPU, params) -> SuperPointTPU:
    """Load a flax ``SuperPointTPU`` parameter tree (``model.init``'s
    output, or its ``"params"`` entry; leaves anything ``np.asarray``
    takes) into ``model`` in place. flax names its submodules by class and
    call order: ``ConvBlock_0..3`` with ``Conv_0..1`` each, then the
    heads' ``Conv_0..3``; kernels are HWIO and become OIHW."""
    p = params["params"] if "params" in params else params
    names = [(f"ConvBlock_{b}", f"Conv_{c}") for b in range(4)
             for c in range(2)] + [(f"Conv_{h}",) for h in range(4)]
    with torch.no_grad():
        for conv, path in zip(model.convs(), names):
            leaf = p
            for key in path:
                leaf = leaf[key]
            kernel = np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1)
            if kernel.shape != tuple(conv.weight.shape):
                raise ValueError(f"{'/'.join(path)}: kernel {kernel.shape} "
                                 f"for a weight {tuple(conv.weight.shape)}")
            conv.weight.copy_(torch.as_tensor(np.ascontiguousarray(kernel)))
            conv.bias.copy_(torch.as_tensor(np.array(leaf["bias"])))
    return model


def heatmap_to_cells(heat):
    """[B, H, W] {0,1} corner map -> 65-way cell labels [B, H/8, W/8]
    (int64; the first corner of a cell in row-major order, 64 = dustbin)."""
    b, h, w = heat.shape
    cells = heat.reshape(b, h // CELL, CELL, w // CELL, CELL)
    cells = cells.permute(0, 1, 3, 2, 4).reshape(
        b, h // CELL, w // CELL, CELL * CELL)
    has_pt = cells.amax(-1) > 0
    return torch.where(has_pt, cells.argmax(-1),
                       torch.full_like(has_pt, CELL * CELL,
                                       dtype=torch.int64))


def detector_loss(logits, heat):
    """Softmax cross-entropy of the 65-way cells against their labels,
    mean over cells (``optax.softmax_cross_entropy_with_integer_labels``).
    The label's log-probability is taken through a one-hot product, whose
    backward is elementwise: deterministic on the card."""
    label = heatmap_to_cells(heat)
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(label, logits.shape[-1]).to(logp.dtype)
    return -(logp * onehot).sum(-1).mean()


def descriptor_loss(desc_a, desc_b, uv_a, uv_b, valid, margin_pos=1.0,
                    margin_neg=0.2, lam=1.0):
    """Hinge contrastive loss on cell descriptors at known correspondences.

    desc_* [B, Hc, Wc, D]; uv_* [B, M, 2] pixel coords of the same 3D points
    in both views; valid [B, M] bool. The negative term is normalized over
    the valid pair count and weighted at parity with the positive term (see
    the reference's docstring for why)."""
    def gather(desc, uv):
        cx = torch.div(uv[..., 0], CELL, rounding_mode="floor").long()
        cy = torch.div(uv[..., 1], CELL, rounding_mode="floor").long()
        cx = torch.clamp(cx, 0, desc.shape[2] - 1)
        cy = torch.clamp(cy, 0, desc.shape[1] - 1)
        bidx = torch.arange(desc.shape[0], device=desc.device)[:, None]
        return desc[bidx, cy, cx]                           # [B, M, D]

    da = gather(desc_a, uv_a)
    db = gather(desc_b, uv_b)
    sim = torch.einsum("bmd,bnd->bmn", da, db)              # [B, M, M]
    pos = torch.einsum("bmd,bmd->bm", da, db)
    vmask = valid[:, :, None] & valid[:, None, :]
    eye = torch.eye(sim.shape[1], dtype=torch.bool, device=sim.device)[None]
    negmask = vmask & ~eye
    neg = torch.where(negmask, sim, torch.full_like(sim, -1.0))
    vf = valid.to(sim.dtype)
    nf = negmask.to(sim.dtype)
    pos_l = torch.clamp(margin_pos - pos, min=0.0) * vf
    neg_l = torch.clamp(neg - margin_neg, min=0.0) * nf
    return (pos_l.sum() / torch.clamp(vf.sum(), min=1)
            + lam * neg_l.sum() / torch.clamp(nf.sum(), min=1))


def loss_fn(model: SuperPointTPU, batch):
    """Detector loss of both views plus the descriptor loss; ``model`` is
    the network or any images -> (logits, desc) function."""
    la, da = model(batch["img_a"])
    lb, db = model(batch["img_b"])
    l_det = detector_loss(la, batch["heat_a"]) + detector_loss(
        lb, batch["heat_b"])
    l_desc = descriptor_loss(da, db, batch["uv_a"], batch["uv_b"],
                             batch["valid"])
    return l_det + l_desc


def make_train_step(model: Callable, optimizer):
    """Returns train_step(batch) -> loss (before the step): one
    ``loss_fn(model, batch)``, ``backward`` and ``optimizer.step()``.
    ``model`` is the network or any images -> (logits, desc) function over
    the optimizer's parameters (``entry.split_forward``)."""

    def train_step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def synthetic_batch(generator: torch.Generator, batch: int = 2, h: int = 64,
                    w: int = 64, m: int = 16, device=None):
    """Tiny self-contained training batch (two views + correspondences),
    drawn from ``generator``."""
    kw = dict(generator=generator, device=device)
    img_a = torch.rand((batch, h, w, 1), **kw)
    img_b = torch.rand((batch, h, w, 1), **kw)
    uv = 4 + torch.rand((batch, m, 2), **kw) * (min(h, w) - 8)
    heat = torch.zeros((batch, h, w), device=device)
    iy = uv[..., 1].long()
    ix = uv[..., 0].long()
    bidx = torch.arange(batch, device=device)[:, None].expand(batch, m)
    heat[bidx, iy, ix] = 1.0
    return {
        "img_a": img_a, "img_b": img_b,
        "heat_a": heat, "heat_b": heat.clone(),
        "uv_a": uv, "uv_b": uv,
        "valid": torch.ones((batch, m), dtype=torch.bool, device=device),
    }
