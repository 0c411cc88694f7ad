"""Kernel-backed blocks of the levels that JAX folds; counterpart of
``image_segmentation_tpu/models/folded.py``: FoldedConvBlock (:365, fused
path :431-523, ``input_grad`` :377-386), FoldedConvBlockDownsample (:634,
raw-output pool :651-673), FoldedConvBlockUpsample (:699) and
FoldedConvBlockUpsampleSkip (:723, with the ConvTranspose kernel
:586-595), and Folded1x1 (:226) as :func:`conv1x1`.

The width fold itself is not ported: it exists to fill the TPU's 128
lanes, and at fold 1 the same kernels compute the plain NHWC ops.  Each
block here subclasses its standard twin in :mod:`.blocks` and owns the same
parameters, so the two share a state dict; only the forward differs.
:func:`block_classes` picks the family a level takes from ``w2d_impl``:

- ``"pallas_fused"``: the fused blocks below (``Fused…``);
- ``"pallas"``: the unfused blocks (``Unfused…``, folded.py:406-429): each
  conv is one :class:`~..ops.fused_conv.Conv3x3Function` (the conv3x3
  kernels in their plain forms, ``make_folded_conv3x3``) and BatchNorm +
  ReLU are PyTorch ops between them, as ``FoldedBatchNorm`` applies them;
  the pool and the up-conv are the standard ones (folded.py:596-612, 696);
- any other value (``"dense"``, ``"halo"``: XLA convs in JAX): the
  standard blocks.

The fused family, eval (``train=False``):

- conv1 reads the block input (the decoder's [up | skip] pair without
  building the concat) through :func:`~..ops.fused_conv.conv3x3`;
- conv2 applies bn1's affine + ReLU on load, so bn1's output never exists;
- the encoder returns conv2's raw output, and the pool applies bn2's affine
  + ReLU on load; the decoder applies ``relu(y2*a2 + b2)`` itself in the
  activation dtype, as ``folded.py:521-523`` does.

Training (``train=True``): the whole block is ONE autograd node,
:class:`~..ops.fused_conv.FusedBlockFunction` (``make_folded_block``), whose
outputs ``(z, mean1, var1, mean2, var2)`` also commit the running averages
(folded.py:496-499).  With ``raw_out`` bn2's affine is resolved OUTSIDE the
node from ``(mean2, var2)`` and rounded to the activation dtype
(folded.py:477-482, :500-506), so the pool's affine cotangent reaches bn2
through autograd as ``mean2``/``var2`` cotangents, as in JAX.  The pool and
the ConvTranspose train through their Functions with backward kernels.

The deep levels at fold 1 (``fused_deep``, folded.py:646-683, :733-756):
JAX's fused blocks run there with fold 1, where its raw-output pool
(``fold > 1``) and its ConvTranspose kernel (``fold > 1``) are not taken,
so :class:`FusedDeepConvBlockDownsample` is a :class:`FusedConvBlock` and
the standard max-pool, :class:`FusedDeepConvBlockUpsampleSkip` the
standard up-conv and resize and a :class:`FusedConvBlock` over the pair
[up | skip], and a fused bottleneck is a plain :class:`FusedConvBlock`.

Tensor parallelism (``parallel/tensor.py``): every kernel runs on the
``Co/M`` slice of a sharded weight.  A fused block's sharded convs run in
the TP form of :class:`~..ops.fused_conv.FusedBlockFunction` (and in eval
conv1's slice is gathered before conv2); a sharded conv2's output stays a
slice through the block's own epilogue or the pool kernel (bn2's affine
is per channel) and is gathered after it; the unfused convs, the
ConvTranspose kernel and K11 are column-parallel around their Functions.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fused_conv
from ..ops.conv1x1 import Conv1x1Function
from ..ops.precision import wide
from ..parallel import tensor as tp
from ..utils import spans
from .blocks import (
    BN_EPS,
    ConvBlock,
    ConvBlockDownsample,
    ConvBlockUpsample,
    ConvBlockUpsampleSkip,
    batch_stats,
    bn_affine,
    commit_running_stats,
    conv1x1_nhwc,
    conv_transpose2x2_nhwc,
    max_pool_2x2,
    resize_bilinear_align_corners,
)

Raw = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
# JAX's fold factor (models/folded.py FOLD).  A model takes its folded
# (kernel) path only where the image width is a multiple of FOLD_WIDTH
# (unet.py:76, clip_models.py:68, autoencoder.py:160); elsewhere JAX builds
# its standard modules, and the port runs :func:`standard_forward`.
FOLD = 4
FOLD_WIDTH = 2 * FOLD


class FusedConvBlock(ConvBlock):
    """[Conv3x3 -> BN -> ReLU] x2 through the conv3x3 kernels.

    ``input_grad=False`` (folded.py:377-386): the block input is a model
    input that is never differentiated (the prompt heatmap), so the
    backward runs conv1's wgrad kernel without its dgrad.  The contract is
    explicit: an input that requires grad while grad mode is on raises,
    where the JAX block would return a silent zero."""

    input_grad: bool = True

    def forward(
        self,
        x: torch.Tensor,
        x_b: Optional[torch.Tensor] = None,
        *,
        train: bool = False,
        raw_out: bool = False,
    ) -> Union[torch.Tensor, Raw]:
        """``raw_out``: return ``(y2, a2, b2)`` — conv2's raw output and
        bn2's fp32 affine — for a consumer that applies ``relu(y2*a2 + b2)``
        on its own load."""
        if not self.input_grad and torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (x, x_b)):
            raise RuntimeError(
                "a block built with input_grad=False got an input that requires grad; "
                "build it with input_grad=True to differentiate with respect to its input")
        conv1, bn1, conv2, bn2 = (self.conv[i] for i in (0, 1, 3, 4))
        s1, s2 = tp.shard(conv1), tp.shard(conv2)
        x = x.contiguous()
        x_b = None if x_b is None else x_b.contiguous()
        if train:
            z, mean1, var1, mean2, var2 = fused_conv.FusedBlockFunction.apply(
                x, x_b, conv1.weight, conv1.bias, conv2.weight, conv2.bias,
                bn1.weight, bn1.bias, bn2.weight, bn2.bias, raw_out, BN_EPS, self.input_grad,
                s1, s2,
            )
            commit_running_stats(bn1, *_whole(s1, mean1.detach(), var1.detach()))
            commit_running_stats(bn2, *_whole(s2, mean2.detach(), var2.detach()))
            if not raw_out:
                return z if s2 is None else tp.gather_model(z)
            a2 = torch.rsqrt(var2 + BN_EPS) * tp.take(bn2.weight, s2)
            return z, a2, tp.take(bn2.bias, s2) - mean2 * a2
        y1 = fused_conv.conv3x3(x, conv1.weight, tp.take(conv1.bias, s1), x_b=x_b)
        if s1 is not None:
            y1 = tp.gather(y1)
        a1, b1 = bn_affine(bn1)
        y2 = fused_conv.conv3x3(y1, conv2.weight, tp.take(conv2.bias, s2), a=a1, b=b1)
        a2, b2 = (tp.take(t, s2) for t in bn_affine(bn2))
        if raw_out:
            return y2, a2, b2
        dt = y2.dtype
        z = F.relu(y2 * a2.to(dt) + b2.to(dt))
        return z if s2 is None else tp.gather(z)


def _whole(s: Optional[tp.Shard], *vectors: torch.Tensor):
    """Per-channel vectors of a conv's slice made whole (no autograd)."""
    return vectors if s is None else tuple(tp.gather(v) for v in vectors)


class FusedConvBlockDownsample(ConvBlockDownsample):
    """FusedConvBlock -> the BN-affine max-pool kernel."""

    block_cls = FusedConvBlock

    def __init__(self, in_features: int, features: int, *, input_grad: bool = True,
                 device=None):
        super().__init__(in_features, features, device=device)
        self.block[0].input_grad = input_grad

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """With conv2 sharded, the pool runs on its channel slice, then
        the pooled slices are gathered."""
        y2, a2, b2 = self.block[0](x.contiguous(), train=train, raw_out=True)
        sharded = tp.shard(self.block[0].conv[3]) is not None
        if not train:
            p = fused_conv.maxpool2x2_affine_relu(y2, a2, b2)
            return tp.gather(p) if sharded else p
        dt = y2.dtype
        # rounded in autograd, so the affine cotangent is rounded back as in JAX
        p = fused_conv.PoolFunction.apply(y2, wide(a2.to(dt)), wide(b2.to(dt)))
        return tp.gather_model(p) if sharded else p


def _up_kernel(up: nn.ConvTranspose2d, x: torch.Tensor, train: bool) -> torch.Tensor:
    """The ConvTranspose kernel, through its Function in training.  JAX
    gates it by folded width (folded.py:586) and runs XLA below 64 folded
    columns; the port runs it at every width, with the same math."""
    x = x.contiguous()
    fn = fused_conv.ConvTransposeFunction.apply if train else fused_conv.convtranspose2x2
    return tp.column(fn, x, up.weight, up.bias, tp.shard(up))


class FusedConvBlockUpsampleSkip(ConvBlockUpsampleSkip):
    """The ConvTranspose kernel -> FusedConvBlock over [up | skip]."""

    block_cls = FusedConvBlock

    def forward(
        self, x: torch.Tensor, skip: torch.Tensor, *, train: bool = False
    ) -> torch.Tensor:
        up = _up_kernel(self.up, x, train)
        # the identity at these levels for even image sizes (folded.py:765)
        up = resize_bilinear_align_corners(up, skip.shape[1], skip.shape[2])
        return self.conv(up.contiguous(), skip.to(up.dtype).contiguous(), train=train)


class FusedConvBlockUpsample(ConvBlockUpsample):
    """The ConvTranspose kernel -> FusedConvBlock, no skip (folded.py:699)."""

    block_cls = FusedConvBlock

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        return self.conv(_up_kernel(self.up, x, train), train=train)


class FusedDeepConvBlockDownsample(ConvBlockDownsample):
    """A deep encoder at fold 1 (folded.py:677-683): FusedConvBlock, then
    the standard max-pool on its activated output."""

    block_cls = FusedConvBlock


class FusedDeepConvBlockUpsampleSkip(ConvBlockUpsampleSkip):
    """A deep decoder at fold 1 (folded.py:741-756): the standard up-conv
    and align-corners resize (not the identity at dec1, whose skip lives at
    the bottleneck's resolution), then FusedConvBlock over [up | skip],
    never concatenated."""

    block_cls = FusedConvBlock

    def forward(
        self, x: torch.Tensor, skip: torch.Tensor, *, train: bool = False
    ) -> torch.Tensor:
        up = conv_transpose2x2_nhwc(x, self.up)
        up = resize_bilinear_align_corners(up, skip.shape[1], skip.shape[2])
        return self.conv(up, skip.to(up.dtype), train=train)


# --------------------------------------------------------------------------
# the unfused family (w2d_impl="pallas")
# --------------------------------------------------------------------------

def folded_bn_relu(y: torch.Tensor, bn: nn.BatchNorm2d, train: bool) -> torch.Tensor:
    """``relu(BatchNorm(y))`` as ``FoldedBatchNorm`` applies it
    (folded.py:336-362): the fp32 affine ``a, b`` — from y's batch
    statistics in training (fp32 mean and biased variance, the running
    averages committed), from the running averages in eval — rounded to
    y's dtype, and ``y*a + b`` in that dtype."""
    if train:
        mean, var = batch_stats(y, bn)
        a = torch.rsqrt(var + BN_EPS) * bn.weight
        b = bn.bias - mean * a
    else:
        a, b = bn_affine(bn)
    dt = y.dtype
    return F.relu(y * a.to(dt) + b.to(dt))


class UnfusedConvBlock(ConvBlock):
    """[Conv3x3 -> BN -> ReLU] x2 with each conv one
    :class:`~..ops.fused_conv.Conv3x3Function`: FoldedConvBlock with
    ``impl="pallas"`` (folded.py:406-429).  A second input ``x_b`` is
    concatenated first, as JAX does for that impl (folded.py:781)."""

    def forward(
        self, x: torch.Tensor, x_b: Optional[torch.Tensor] = None, *, train: bool = False
    ) -> torch.Tensor:
        if x_b is not None:
            x = torch.cat([x, x_b.to(x.dtype)], dim=-1)
        for i in (0, 3):
            conv = self.conv[i]
            y = tp.column(fused_conv.Conv3x3Function.apply, x.contiguous(), conv.weight,
                          conv.bias, tp.shard(conv))
            x = folded_bn_relu(y, self.conv[i + 1], train)
        return x


class UnfusedConvBlockDownsample(ConvBlockDownsample):
    """UnfusedConvBlock -> the standard max-pool (folded.py:696)."""

    block_cls = UnfusedConvBlock


class UnfusedConvBlockUpsampleSkip(ConvBlockUpsampleSkip):
    """The standard up-conv -> UnfusedConvBlock over [up | skip]."""

    block_cls = UnfusedConvBlock


class UnfusedConvBlockUpsample(ConvBlockUpsample):
    """The standard up-conv -> UnfusedConvBlock, no skip."""

    block_cls = UnfusedConvBlock


STANDARD = (ConvBlockDownsample, ConvBlockUpsampleSkip, ConvBlockUpsample)
FAMILIES = {
    "pallas_fused": (FusedConvBlockDownsample, FusedConvBlockUpsampleSkip, FusedConvBlockUpsample),
    "pallas": (UnfusedConvBlockDownsample, UnfusedConvBlockUpsampleSkip, UnfusedConvBlockUpsample),
}


def block_classes(w2d_impl: str, folded: bool = True) -> tuple:
    """``(Downsample, UpsampleSkip, Upsample)`` of a level that JAX builds
    as ``models/folded.py`` blocks with ``impl=w2d_impl`` when ``folded``
    (see the module doc); the standard blocks when not."""
    return FAMILIES.get(w2d_impl, STANDARD) if folded else STANDARD


def standard_forward(block: nn.Module, x: torch.Tensor, x_b: Optional[torch.Tensor] = None, *,
                     train: bool) -> torch.Tensor:
    """The standard twin's math on ``block``'s parameters, whatever its
    family: where a model's fold gate is off in JAX (the image width), it
    builds the standard module on the same tree.  ``block`` is a
    ConvBlock[Downsample|Upsample|UpsampleSkip] or a subclass; ``x_b`` a
    ConvBlock's second input or an UpsampleSkip's skip."""
    if isinstance(block, ConvBlockDownsample):
        return max_pool_2x2(ConvBlock.forward(block.block[0], x, train=train))
    if isinstance(block, ConvBlockUpsample):
        return ConvBlock.forward(block.conv, conv_transpose2x2_nhwc(x, block.up), train=train)
    if isinstance(block, ConvBlockUpsampleSkip):
        up = conv_transpose2x2_nhwc(x, block.up)
        up = resize_bilinear_align_corners(up, x_b.shape[1], x_b.shape[2])
        return ConvBlock.forward(block.conv, up, x_b, train=train)
    return ConvBlock.forward(block, x, x_b, train=train)


def block_forward(block: nn.Module, *inputs: torch.Tensor, train: bool,
                  kernels: bool) -> torch.Tensor:
    """``block(*inputs)``, or without ``kernels`` (where the model's fold
    gate is off in JAX) :func:`standard_forward` on its parameters; inside
    the block's profiler span (``utils.spans``)."""
    if kernels:
        return spans.module_block(block, block, *inputs, train=train)
    return spans.module_block(block, functools.partial(standard_forward, block), *inputs,
                              train=train)


def conv1x1(x: torch.Tensor, conv: nn.Conv2d, *, folded: bool) -> torch.Tensor:
    """The 1x1 ``conv`` on NHWC x, in x's dtype.  ``folded``: where JAX
    builds a ``Folded1x1`` without ``in_perm`` (the folded paths' stem and
    output conv), through :class:`~..ops.conv1x1.Conv1x1Function`, whose
    backward is K11; else ``blocks.conv1x1_nhwc``.  Inside the conv's
    profiler span (``utils.spans``)."""
    return spans.module_block(conv, _conv1x1, x, conv, folded=folded)


def _conv1x1(x: torch.Tensor, conv: nn.Conv2d, *, folded: bool) -> torch.Tensor:
    if not folded:
        return conv1x1_nhwc(x, conv)
    return tp.column(Conv1x1Function.apply, x.contiguous(), conv.weight, conv.bias,
                     tp.shard(conv))
