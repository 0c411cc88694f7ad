"""The ResNet-34 feature extractor, NHWC; counterpart of
``image_segmentation_tpu/models/resnet.py`` (BasicBlock :31,
ResNet34Features :78).

conv 7x7/2 (pad 3, no bias) -> BatchNorm -> ReLU -> max-pool 3x3/2 (pad
1) -> four stages of BasicBlocks (3, 4, 6, 3 blocks at widths 64, 128,
256, 512; the first block of stages 2-4 strides by 2) -> (B, H/32, W/32,
512).  A BasicBlock is conv3x3(stride) -> bn1 -> ReLU -> conv3x3 -> bn2,
plus the identity or, where the stride or the width changes, a 1x1
``downsample`` conv (stride, no bias) -> BatchNorm, then ReLU of the sum.
The stride-2 3x3 conv pads (1, 1) on both sides, as torch does (the JAX
module spells the padding out, :45-56).

The convs are cuDNN's in the compute dtype (XLA convs in JAX, never a
Pallas kernel).  BatchNorm follows the port's rule
(:mod:`.blocks`): eval from the running averages in fp32, training with
the fp32 batch statistics (biased variance) and flax's running update
through ``commit_running_stats``; each BatchNorm's output is cast back to
the compute dtype, as flax's ``BatchNorm(dtype=...)`` returns it.

Tensor parallelism (``parallel/tensor.py``): JAX's rule shards every
conv kernel here (each has at least 4096 elements), and the frozen
backbone's weights are this rank's slices as JAX places them, though no
optimizer holds them.  Each conv is column-parallel, its slices gathered
plainly (the backbone runs without autograd), so the BatchNorms, the
ReLUs, the residual sums and the max-pool see whole tensors, and every
model rank commits the same running statistics to its own copy.

Module names follow the reference's ``nn.Sequential(*resnet34.children()
[:-2])`` (processing_blocks.py:262-263, the layout
``utils/torch_export.resnet34_children_to_torch`` writes): ``model.0`` the
stem conv, ``model.1`` its BatchNorm, ``model.4``-``model.7`` the stages,
each block ``conv1``, ``bn1``, ``conv2``, ``bn2`` and ``downsample.{0,1}``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.precision import wide
from ..parallel import tensor as tp
from ..utils import spans
from .blocks import BN_EPS, batch_stats, bn_affine

RESNET34_LAYERS = (3, 4, 6, 3)
RESNET34_WIDTHS = (64, 128, 256, 512)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` (no bias) on NHWC x with its own stride and padding, in x's
    dtype; column-parallel when its weight is sharded."""
    def op(x, w, b):
        y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b, stride=conv.stride,
                     padding=conv.padding)
        return y.permute(0, 2, 3, 1)

    return tp.column(op, x, conv.weight, None, tp.shard(conv))


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool) -> torch.Tensor:
    """BatchNorm of NHWC x in fp32, cast back to x's dtype; in training with
    the batch statistics, its running averages committed."""
    if train:
        mean, var = batch_stats(x, bn)
        y = (wide(x) - mean) * (torch.rsqrt(var + BN_EPS) * bn.weight) + bn.bias
    else:
        a, b = bn_affine(bn)
        y = wide(x) * a + b
    return y.to(x.dtype)


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1, *, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 3, stride, padding=1, bias=False,
                               device=device)
        self.bn1 = nn.BatchNorm2d(features, eps=BN_EPS, device=device)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False, device=device)
        self.bn2 = nn.BatchNorm2d(features, eps=BN_EPS, device=device)
        self.downsample = None
        if stride != 1 or in_features != features:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_features, features, 1, stride, bias=False, device=device),
                nn.BatchNorm2d(features, eps=BN_EPS, device=device))

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        h = F.relu(batch_norm(_conv(x, self.conv1), self.bn1, train))
        h = batch_norm(_conv(h, self.conv2), self.bn2, train)  # no ReLU before the sum
        residual = x
        if self.downsample is not None:
            residual = batch_norm(_conv(x, self.downsample[0]), self.downsample[1], train)
        return F.relu(h + residual)


class ResNet34Features(nn.Module):
    """``forward(x (B, H, W, 3)) -> (B, H/32, W/32, 512)`` in the compute
    dtype ``dtype``; H and W multiples of 32."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16, *, device=None):
        super().__init__()
        self.dtype = dtype
        stages, cin = [], 64
        for stage, (blocks, width) in enumerate(zip(RESNET34_LAYERS, RESNET34_WIDTHS)):
            stages.append(nn.Sequential(*[
                BasicBlock(cin if b == 0 else width, width, 2 if (b == 0 and stage > 0) else 1,
                           device=device)
                for b in range(blocks)]))
            cin = width
        self.model = nn.Sequential(
            nn.Conv2d(3, 64, 7, 2, padding=3, bias=False, device=device),
            nn.BatchNorm2d(64, eps=BN_EPS, device=device),
            nn.ReLU(), nn.MaxPool2d(3, 2, padding=1), *stages)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        with spans.span("model.resnet34"):
            h = F.relu(batch_norm(_conv(x.to(self.dtype), self.model[0]), self.model[1], train))
            h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)
            for stage in self.model[4:]:
                for block in stage:
                    h = block(h, train=train)
            return h
