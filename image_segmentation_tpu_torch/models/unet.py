"""U-Net family, NHWC; counterpart of ``image_segmentation_tpu/models/unet.py``
(UNet :29, LargeUNet :251), eval and training forwards.

The constructor takes the JAX modules' fields, so the model args stored in
a JAX artifact build the same network here:

- ``w2d_level0`` with ``w2d_impl="pallas_fused"`` runs level 0 (enc1 and
  the last decoder) through the hand-written kernels (:mod:`.fused`);
- adding ``w2d_level1_fold2`` also runs level 1 (enc2 and the decoder
  before the last) through them;
- every other level — and levels whose JAX form only changes the TPU
  layout (other ``w2d_impl`` values, ``w2d_level1``) — runs the plain
  PyTorch blocks, as JAX runs them as plain XLA.  The math is the same
  either way (shared parameter tree, tests/test_folded.py).

Module names follow the reference torch key layout, so
``utils.convert.state_dict_from_jax`` loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from . import fused
from .blocks import (
    ConvBlock,
    ConvBlockDownsample,
    ConvBlockUpsampleSkip,
    conv1x1_nhwc,
)


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
        kernels0 = bool(w2d_level0) and w2d_impl == "pallas_fused"
        kernels1 = kernels0 and bool(w2d_level1_fold2) and len(enc) >= 2
        n = len(enc)

        self.input = nn.Conv2d(3, stem_features, 1, device=device)
        self.encoders = []
        cin = stem_features
        for i, feats in enumerate(enc, start=1):
            fast = (i == 1 and kernels0) or (i == 2 and kernels1)
            cls = fused.FusedConvBlockDownsample if fast else ConvBlockDownsample
            self.encoders.append(f"enc{i}")
            setattr(self, f"enc{i}", cls(cin, feats, device=device))
            cin = feats
        self.bottleneck = ConvBlock(cin, 2 * enc[-1], device=device)
        cin = 2 * enc[-1]
        self.decoders = []
        for i, feats in enumerate(enc[::-1] + [stem_features], start=1):
            fast = (i == n + 1 and kernels0) or (i == n and kernels1)
            cls = fused.FusedConvBlockUpsampleSkip if fast else ConvBlockUpsampleSkip
            self.decoders.append(f"dec{i}")
            setattr(self, f"dec{i}", cls(cin, feats, device=device))
            cin = feats
        self.out = nn.Conv2d(stem_features, out_channels, 1, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """x (B, H, W, Cin) float -> logits (B, H, W, out_channels) fp32.

        ``train``: BatchNorm with batch statistics over the whole batch,
        committing the running averages (flax's ``train=True``)."""
        h = conv1x1_nhwc(x.to(self.dtype), self.input)
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
        return conv1x1_nhwc(h, self.out).float()


class LargeUNet(UNet):
    """4-downsample U-Net with a 1024-wide bottleneck (reference
    models/UNet.py:78-148)."""

    default_encoder_features = (64, 128, 256, 512)
