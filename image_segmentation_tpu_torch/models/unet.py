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
- the deeper levels run the standard blocks, as JAX runs them as XLA
  (``fused_deep`` is not ported).  The math is the same either way (shared
  parameter tree, tests/test_folded.py).

Module names follow the reference torch key layout, so
``utils.convert.state_dict_from_jax`` loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from . import fused
from .blocks import ConvBlock, ConvBlockDownsample, ConvBlockUpsampleSkip


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
        if fused_deep:
            raise NotImplementedError(
                "fused_deep (fused ConvBN kernels on the deep levels) is not "
                "ported; see ROADMAP.md Queue 2"
            )
        enc = list(encoder_features or self.default_encoder_features)
        self.dtype = dtype
        self.folded = bool(w2d_level0)
        down0, up0, _ = fused.block_classes(w2d_impl, self.folded)
        down1, up1, _ = fused.block_classes(
            w2d_impl, self.folded and bool(w2d_level1_fold2 or w2d_level1) and len(enc) >= 2)
        n = len(enc)

        self.input = nn.Conv2d(3, stem_features, 1, device=device)
        self.encoders = []
        cin = stem_features
        for i, feats in enumerate(enc, start=1):
            cls = {1: down0, 2: down1}.get(i, ConvBlockDownsample)
            self.encoders.append(f"enc{i}")
            setattr(self, f"enc{i}", cls(cin, feats, device=device))
            cin = feats
        self.bottleneck = ConvBlock(cin, 2 * enc[-1], device=device)
        cin = 2 * enc[-1]
        self.decoders = []
        for i, feats in enumerate(enc[::-1] + [stem_features], start=1):
            cls = {n + 1: up0, n: up1}.get(i, ConvBlockUpsampleSkip)
            self.decoders.append(f"dec{i}")
            setattr(self, f"dec{i}", cls(cin, feats, device=device))
            cin = feats
        self.out = nn.Conv2d(stem_features, out_channels, 1, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """x (B, H, W, Cin) float -> logits (B, H, W, out_channels) fp32.

        ``train``: BatchNorm with batch statistics over the whole batch,
        committing the running averages (flax's ``train=True``)."""
        h = fused.conv1x1(x.to(self.dtype), self.input, folded=self.folded)
        # Decoder i pairs with skips[-i]: enc outputs are post-pool, so dec1's
        # skip (the last encoder) has the bottleneck's resolution and its 2x
        # up-conv is resized back down (unet.py:94-99).
        skips = [h]
        for name in self.encoders:
            h = getattr(self, name)(h, train=train)
            skips.append(h)
        h = self.bottleneck(h, train=train)
        for i, name in enumerate(self.decoders, start=1):
            h = getattr(self, name)(h, skips[-i], train=train)
        return fused.conv1x1(h, self.out, folded=self.folded).float()


class LargeUNet(UNet):
    """4-downsample U-Net with a 1024-wide bottleneck (reference
    models/UNet.py:78-148)."""

    default_encoder_features = (64, 128, 256, 512)
