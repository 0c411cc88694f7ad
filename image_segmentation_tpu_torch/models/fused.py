"""Kernel-backed blocks of the two full-resolution levels; counterpart of
``image_segmentation_tpu/models/folded.py``: FoldedConvBlock (:365, fused
path :431-523, ``input_grad`` :377-386), FoldedConvBlockDownsample (:634,
raw-output pool :651-673) and FoldedConvBlockUpsampleSkip (:723, with the
ConvTranspose kernel :586-595).

The width fold itself is not ported: it exists to fill the TPU's 128
lanes, and at fold 1 the same kernels compute the plain NHWC ops.  Each
block here subclasses its standard twin in :mod:`.blocks` and owns the same
parameters, so the two share a state dict; only the forward differs.

Eval (``train=False``):

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
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..ops import fused_conv
from .blocks import (
    BN_EPS,
    ConvBlock,
    ConvBlockDownsample,
    ConvBlockUpsampleSkip,
    bn_affine,
    commit_running_stats,
    resize_bilinear_align_corners,
)

Raw = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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
        if train:
            z, mean1, var1, mean2, var2 = fused_conv.FusedBlockFunction.apply(
                x, x_b, conv1.weight, conv1.bias, conv2.weight, conv2.bias,
                bn1.weight, bn1.bias, bn2.weight, bn2.bias, raw_out, BN_EPS, self.input_grad,
            )
            commit_running_stats(bn1, mean1.detach(), var1.detach())
            commit_running_stats(bn2, mean2.detach(), var2.detach())
            if not raw_out:
                return z
            a2 = torch.rsqrt(var2 + BN_EPS) * bn2.weight
            return z, a2, bn2.bias - mean2 * a2
        y1 = fused_conv.conv3x3(x, conv1.weight, conv1.bias, x_b=x_b)
        a1, b1 = bn_affine(bn1)
        y2 = fused_conv.conv3x3(y1, conv2.weight, conv2.bias, a=a1, b=b1)
        a2, b2 = bn_affine(bn2)
        if raw_out:
            return y2, a2, b2
        dt = y2.dtype
        return F.relu(y2 * a2.to(dt) + b2.to(dt))


class FusedConvBlockDownsample(ConvBlockDownsample):
    """FusedConvBlock -> the BN-affine max-pool kernel."""

    block_cls = FusedConvBlock

    def __init__(self, in_features: int, features: int, *, input_grad: bool = True,
                 device=None):
        super().__init__(in_features, features, device=device)
        self.block[0].input_grad = input_grad

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        y2, a2, b2 = self.block[0](x.contiguous(), train=train, raw_out=True)
        if not train:
            return fused_conv.maxpool2x2_affine_relu(y2, a2, b2)
        dt = y2.dtype
        # rounded in autograd, so the affine cotangent is rounded back as in JAX
        return fused_conv.PoolFunction.apply(y2, a2.to(dt).float(), b2.to(dt).float())


class FusedConvBlockUpsampleSkip(ConvBlockUpsampleSkip):
    """The ConvTranspose kernel -> FusedConvBlock over [up | skip]."""

    block_cls = FusedConvBlock

    def forward(
        self, x: torch.Tensor, skip: torch.Tensor, *, train: bool = False
    ) -> torch.Tensor:
        x = x.contiguous()
        if train:
            up = fused_conv.ConvTransposeFunction.apply(x, self.up.weight, self.up.bias)
        else:
            up = fused_conv.convtranspose2x2(x, self.up.weight, self.up.bias)
        # the identity at these levels for even image sizes (folded.py:765)
        up = resize_bilinear_align_corners(up, skip.shape[1], skip.shape[2])
        return self.conv(up.contiguous(), skip.to(up.dtype).contiguous(), train=train)
