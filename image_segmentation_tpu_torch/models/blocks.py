"""Convolutional building blocks, NHWC; counterpart of
``image_segmentation_tpu/models/blocks.py`` (ConvBlock :41,
ConvBlockDownsample :74, resize_bilinear_align_corners :108,
ConvBlockUpsampleSkip :140, ConvBlockUpsample :167).

The modules hold their parameters in ``nn.Conv2d`` / ``nn.BatchNorm2d`` /
``nn.ConvTranspose2d`` under the reference torch key layout
(``conv.{0,1,3,4}``, ``block.0``, ``up``, ``conv.conv``), so a JAX tree
converted by ``utils/convert.py`` loads strictly.  The forwards are
written on NHWC tensors, as in the JAX package: convolutions take a
permuted (channels-last) view.  Parameters stay fp32 and are cast to the
activation dtype at use, like flax's ``dtype=`` modules; eval BatchNorm is
computed in fp32 and cast back, as flax does (in float64 for a float64
model, :func:`~..ops.precision.wide`).

Training mode (``train=True``) normalises with the batch statistics in
flax's semantics (blocks.py:35-37, folded.py:340-353): biased
``var = max(0, E[x^2] - mean^2)`` in fp32, and running averages
``0.9*running + 0.1*batch`` from that same biased variance — not
``nn.BatchNorm2d``'s unbiased running update, which this module never
runs.  The statistics are the global batch's when several ranks train
(:func:`batch_stats`), as JAX's are over its batch-sharded array.

Tensor parallelism (``parallel/tensor.py``): a conv or ConvTranspose whose
weight is sharded is column-parallel — it computes its slice of the output
channels from the full input and the slices are gathered, so the
BatchNorm, the pools and the resizes after it see the whole tensor.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.precision import wide
from ..parallel import mesh
from ..parallel import tensor as tp

# torch BatchNorm2d default, and the JAX package's BN_EPS (blocks.py:38).
BN_EPS = 1e-5
# flax's running-average decay (blocks.py:37): running = 0.9*running + 0.1*batch.
BN_MOMENTUM = 0.9


def bn_affine(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as ``y = x*a + b`` with fp32 ``a, b``
    (models/folded.py:356-357)."""
    a = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
    return a, bn.bias - bn.running_mean * a


def bn_relu(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """``relu(BatchNorm(x))`` in eval mode, computed in fp32."""
    a, b = bn_affine(bn)
    return F.relu(wide(x) * a + b).to(x.dtype)


# False while a training forward is recomputed in the backward (the
# Trainer's ``remat``): its batch statistics were committed by the forward.
_commits = True


@contextmanager
def no_commits():
    """Skip :func:`commit_running_stats` while the block runs, so a
    recomputed forward commits nothing a second time."""
    global _commits
    before, _commits = _commits, False
    try:
        yield
    finally:
        _commits = before


def commit_running_stats(
    bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor
) -> None:
    """flax's running-average update with the batch mean and BIASED
    variance (folded.py:348-354); nothing under :func:`no_commits`."""
    if not _commits:
        return
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)


def batch_stats(x: torch.Tensor, bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 batch mean and biased variance of NHWC ``x`` per channel, with
    ``bn``'s running averages committed.  Over the global batch: with
    several ranks (``parallel.mesh``) the per-channel sums of x and x^2 are
    summed over ranks, differentiably, before the ratios, so every rank
    commits the same running averages."""
    xf = wide(x)
    if mesh.active():
        n = xf.shape[0] * xf.shape[1] * xf.shape[2] * mesh.data_size()
        s, q = mesh.all_reduce_sum(torch.stack([xf.sum((0, 1, 2)), (xf * xf).sum((0, 1, 2))]))
        mean = s / n
        var = torch.clamp(q / n - mean * mean, min=0.0)
    else:
        mean = xf.mean((0, 1, 2))
        var = torch.clamp((xf * xf).mean((0, 1, 2)) - mean * mean, min=0.0)
    commit_running_stats(bn, mean.detach(), var.detach())
    return mean, var


def bn_relu_train(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """``relu(BatchNorm(x))`` with batch statistics, computed in fp32, and
    the running averages committed."""
    mean, var = batch_stats(x, bn)
    mul = torch.rsqrt(var + BN_EPS) * bn.weight
    return F.relu((wide(x) - mean) * mul + bn.bias).to(x.dtype)


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` (SAME padding) on an NHWC tensor, in ``x``'s dtype
    (column-parallel when its weight is sharded)."""
    def op(x, w, b):
        y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b.to(x.dtype), padding=conv.padding)
        return y.permute(0, 2, 3, 1)

    return tp.column(op, x, conv.weight, conv.bias, tp.shard(conv))


def conv1x1_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """1x1 conv on an NHWC tensor as one matmul over the channel axis
    (models/folded.py ``Folded1x1`` at fold 1)."""
    def op(x, w, b):
        return F.linear(x, w[:, :, 0, 0].to(x.dtype), b.to(x.dtype))

    return tp.column(op, x, conv.weight, conv.bias, tp.shard(conv))


def conv_transpose2x2_nhwc(x: torch.Tensor, up: nn.ConvTranspose2d) -> torch.Tensor:
    """ConvTranspose(k=2, s=2) on an NHWC tensor, in ``x``'s dtype."""
    def op(x, w, b):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b.to(x.dtype), stride=2)
        return y.permute(0, 2, 3, 1)

    return tp.column(op, x, up.weight, up.bias, tp.shard(up))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel=2, stride=2) in NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _resize_axis_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) fp32 two-tap interpolation matrix with
    ``align_corners=True`` weights (blocks.py:88-105)."""
    m = np.zeros((out_size, in_size), np.float32)
    if out_size == 1 or in_size == 1:
        m[:, 0] = 1.0
        return m
    src = np.arange(out_size, dtype=np.float64) * ((in_size - 1) / (out_size - 1))
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = (src - lo).astype(np.float32)
    m[np.arange(out_size), lo] += 1.0 - frac
    m[np.arange(out_size), hi] += frac
    return m


def resize_bilinear_align_corners(
    x: torch.Tensor, height: int, width: int
) -> torch.Tensor:
    """Bilinear NHWC resize with ``align_corners=True``, as two fp32
    two-tap matmuls; the identity when the size already matches."""
    _, h, w, _ = x.shape
    if (h, w) == (height, width):
        return x
    xf = wide(x)
    my = torch.from_numpy(_resize_axis_matrix(h, height)).to(x.device, xf.dtype)
    mx = torch.from_numpy(_resize_axis_matrix(w, width)).to(x.device, xf.dtype)
    top = torch.einsum("oh,bhwc->bowc", my, xf)
    return torch.einsum("ow,bhwc->bhoc", mx, top).to(x.dtype)


class ConvBlock(nn.Module):
    """[Conv3x3 -> BatchNorm -> ReLU] x2 (blocks.py:41)."""

    def __init__(self, in_features: int, features: int, *, device=None):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(in_features, features, 3, padding=1, device=device),
            nn.BatchNorm2d(features, eps=BN_EPS, device=device),
            nn.ReLU(),
            nn.Conv2d(features, features, 3, padding=1, device=device),
            nn.BatchNorm2d(features, eps=BN_EPS, device=device),
            nn.ReLU(),
        )

    def forward(
        self, x: torch.Tensor, x_b: Optional[torch.Tensor] = None, *, train: bool = False
    ) -> torch.Tensor:
        """``x_b`` (optional): the input is the channel concat ``[x | x_b]``."""
        if x_b is not None:
            x = torch.cat([x, x_b.to(x.dtype)], dim=-1)
        act = bn_relu_train if train else bn_relu
        x = act(conv_nhwc(x, self.conv[0]), self.conv[1])
        return act(conv_nhwc(x, self.conv[3]), self.conv[4])


class ConvBlockDownsample(nn.Module):
    """ConvBlock -> 2x2 max-pool (blocks.py:74).  ``block.0`` is the
    reference's Sequential([ConvBlock, MaxPool]) index."""

    block_cls = ConvBlock

    def __init__(self, in_features: int, features: int, *, device=None):
        super().__init__()
        self.block = nn.ModuleList([self.block_cls(in_features, features, device=device)])

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        return max_pool_2x2(self.block[0](x, train=train))


class ConvBlockUpsample(nn.Module):
    """ConvTranspose(k=2, s=2) -> ConvBlock(features -> features), no skip
    and no resize (blocks.py:167; the reference exports it as ``up`` and
    ``conv.conv.*``, utils/torch_export.py ``_upsample``)."""

    block_cls = ConvBlock

    def __init__(self, in_features: int, features: int, *, device=None):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_features, features, 2, stride=2, device=device)
        self.conv = self.block_cls(features, features, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        return self.conv(conv_transpose2x2_nhwc(x, self.up), train=train)


class ConvBlockUpsampleSkip(nn.Module):
    """ConvTranspose(k=2, s=2) -> align-corners resize to the skip ->
    concat [up | skip] -> ConvBlock(2*features -> features) (blocks.py:140)."""

    block_cls = ConvBlock

    def __init__(self, in_features: int, features: int, *, device=None):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_features, features, 2, stride=2, device=device)
        self.conv = self.block_cls(2 * features, features, device=device)

    def forward(
        self, x: torch.Tensor, skip: torch.Tensor, *, train: bool = False
    ) -> torch.Tensor:
        up = conv_transpose2x2_nhwc(x, self.up)
        up = resize_bilinear_align_corners(up, skip.shape[1], skip.shape[2])
        return self.conv(up, skip, train=train)
