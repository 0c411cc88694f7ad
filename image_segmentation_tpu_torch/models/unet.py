"""U-Net family, NHWC; counterpart of ``image_segmentation_tpu/models/unet.py``
(UNet :29, LargeUNet :251), eval and training forwards.

The constructor takes the JAX modules' fields, so the model args stored in
a JAX artifact build the same network here:

- ``w2d_level0`` folds level 0 (enc1 and the last decoder) in JAX, and
  ``w2d_level1_fold2`` or ``w2d_level1`` level 1 too (enc2 and the decoder
  before the last, unet.py:133-155, :220-237).  A folded level takes the
  block family of ``w2d_impl`` (:func:`.fused.block_classes`): the fused
  kernel blocks under ``"pallas_fused"``, the unfused ones (one conv
  kernel per conv, BatchNorm between them) under ``"pallas"``, and the
  standard blocks under ``"dense"`` and ``"halo"``, which change only the
  TPU layout of XLA's convs;
- with ``w2d_level0`` the stem and the output conv are JAX's
  ``Folded1x1``, whose backward the port always runs on K11
  (:func:`.fused.conv1x1`);
- the deeper levels run the standard blocks, as JAX runs them as XLA,
  except those that ``fused_deep`` puts on the fused kernel blocks at fold
  1 (:mod:`.fused`, ``FusedDeep…`` and the bottleneck's
  ``FusedConvBlock``).  The math is the same either way (shared parameter
  tree, tests/test_folded.py);
- all of this holds only where JAX takes its folded path: ``w2d_level0``
  and an image width that is a multiple of 8 (``fused.FOLD_WIDTH``,
  unet.py:76).
  At any other width :meth:`UNet.forward` runs every level on the
  standard math (:func:`.fused.standard_forward`) and the stem and output
  as plain 1x1 convs, on the same parameters, as JAX builds its standard
  modules there.

Module names follow the reference torch key layout, so
``utils.convert.state_dict_from_jax`` loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from . import fused
from .blocks import ConvBlock, ConvBlockDownsample, ConvBlockUpsampleSkip

# JAX's cap on one fused conv's weight operand, (3, 3*cin, co) bf16
# (unet.py:173-178).  It is the TPU's VMEM budget and means nothing on the
# H100; the port keeps it so that the same blocks run kernels in both
# packages.
FUSED_WEIGHT_BYTES = 6 * 2**20


def fused_deep_on(fused_deep: Any, w2d_impl: str, name: str) -> bool:
    """JAX's ``_fd_on`` (unet.py:161-171): whether ``fused_deep`` (False,
    True, a comma-joined string or a sequence of module names) selects the
    deep module ``name``; only under ``w2d_impl="pallas_fused"``."""
    if w2d_impl != "pallas_fused" or not fused_deep:
        return False
    if fused_deep is True:
        return True
    names = fused_deep.split(",") if isinstance(fused_deep, str) else fused_deep
    return name in names


def fused_fits(cin: int, feats: int) -> bool:
    """JAX's ``_fused_fits`` (unet.py:173-178): the larger conv weight of a
    ``cin -> feats`` block under FUSED_WEIGHT_BYTES."""
    return max(3 * (3 * cin) * feats, 3 * (3 * feats) * feats) * 2 <= FUSED_WEIGHT_BYTES


class UNet(nn.Module):
    """3-downsample U-Net (reference models/UNet.py:7-76): 1x1 stem ->
    encoders -> bottleneck (2x the last encoder) -> skip decoders -> 1x1
    output conv, raw logits out (fp32)."""

    default_encoder_features: Sequence[int] = (64, 128, 256)

    def __init__(
        self,
        out_channels: int = 3,
        dtype: torch.dtype = torch.bfloat16,
        stem_features: int = 32,
        encoder_features: Sequence[int] | None = None,
        w2d_level0: bool = False,
        w2d_level1: bool = False,
        w2d_level1_fold2: bool = False,
        w2d_impl: str = "dense",
        fused_deep: Any = False,
        *,
        device=None,
    ):
        super().__init__()
        enc = list(encoder_features or self.default_encoder_features)
        n = len(enc)
        self.dtype = dtype
        self.folded = bool(w2d_level0)
        fold_l1 = self.folded and bool(w2d_level1_fold2 or w2d_level1) and n >= 2
        down0, up0, _ = fused.block_classes(w2d_impl, self.folded)
        down1, up1, _ = fused.block_classes(w2d_impl, fold_l1)

        def deep(name: str, cin: int, feats: int) -> bool:
            """Whether JAX's folded path runs the deep module ``name`` as a
            fold-1 fused block (unet.py:180-230)."""
            return (self.folded and fused_deep_on(fused_deep, w2d_impl, name)
                    and fused_fits(cin, feats))

        self.input = nn.Conv2d(3, stem_features, 1, device=device)
        self.encoders = []
        cin = stem_features
        for i, feats in enumerate(enc, start=1):
            name = f"enc{i}"
            if i == 1 or (i == 2 and fold_l1):
                cls = down0 if i == 1 else down1
            elif deep(name, cin, feats):
                cls = fused.FusedDeepConvBlockDownsample
            else:
                cls = ConvBlockDownsample
            self.encoders.append(name)
            setattr(self, name, cls(cin, feats, device=device))
            cin = feats
        bneck = fused.FusedConvBlock if deep("bottleneck", cin, 2 * enc[-1]) else ConvBlock
        self.bottleneck = bneck(cin, 2 * enc[-1], device=device)
        cin = 2 * enc[-1]
        self.decoders = []
        for i, feats in enumerate(enc[::-1] + [stem_features], start=1):
            name = f"dec{i}"
            if i == n + 1 or (i == n and fold_l1):
                cls = up0 if i == n + 1 else up1
            elif deep(name, 2 * feats, feats):
                cls = fused.FusedDeepConvBlockUpsampleSkip
            else:
                cls = ConvBlockUpsampleSkip
            self.decoders.append(name)
            setattr(self, name, cls(cin, feats, device=device))
            cin = feats
        self.out = nn.Conv2d(stem_features, out_channels, 1, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """x (B, H, W, Cin) float -> logits (B, H, W, out_channels) fp32.

        ``train``: BatchNorm with batch statistics over the whole batch,
        committing the running averages (flax's ``train=True``).  Off JAX's
        fold gate (module doc) every block runs the standard math."""
        x = x.to(self.dtype)
        kernels = self.folded and x.shape[2] % fused.FOLD_WIDTH == 0
        h = fused.conv1x1(x, self.input, folded=kernels)
        # Decoder i pairs with skips[-i]: enc outputs are post-pool, so dec1's
        # skip (the last encoder) has the bottleneck's resolution and its 2x
        # up-conv is resized back down (unet.py:94-99).
        skips = [h]
        for name in self.encoders:
            h = fused.block_forward(getattr(self, name), h, train=train, kernels=kernels)
            skips.append(h)
        h = fused.block_forward(self.bottleneck, h, train=train, kernels=kernels)
        for i, name in enumerate(self.decoders, start=1):
            h = fused.block_forward(getattr(self, name), h, skips[-i], train=train,
                                    kernels=kernels)
        return fused.conv1x1(h, self.out, folded=kernels).float()


class LargeUNet(UNet):
    """4-downsample U-Net with a 1024-wide bottleneck (reference
    models/UNet.py:78-148)."""

    default_encoder_features = (64, 128, 256, 512)
