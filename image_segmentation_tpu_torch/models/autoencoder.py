"""The convolutional autoencoder, NHWC; counterpart of
``image_segmentation_tpu/models/autoencoder.py`` (Encoder :27, Decoder :80,
Autoencoder :148; reference models/classical_autoencoder.py).

Encoder: 1x1 stem to 32, three downsampling blocks 64/64/64, bottleneck
ConvBlock(64); it returns every level in a dict (``x0``, ``enc1``,
``enc2``, ``enc3``, ``bottleneck``), the backbone contract later models
reuse.  Decoder: three skip-less upsampling blocks 64/64/32 and a 1x1
output conv.  Autoencoder: both, with a sigmoid on the output (fp32).

The constructors take the JAX modules' fields.  With ``w2d_level0`` JAX
folds, and the port runs on the block family of ``w2d_impl``
(:func:`.fused.block_classes`): enc1 and dec3 always, enc2 and dec2 with
``w2d_level1_fold2``, dec1 with ``w2d_level2_fold2``; enc3 and the
bottleneck are standard (cuDNN), and the stem and the output conv train
through K11 (:func:`.fused.conv1x1`).  JAX decides the fold in the forward
(autoencoder.py:160-163): one gate for both halves, the image width a
multiple of 8.  When the gate is off, the port runs the standard blocks'
math on the same parameters.

Module names follow the JAX tree with the reference torch layout inside
(``encoder.input``, ``encoder.enc{i}.block.0.conv.*``,
``encoder.bottleneck.conv.*``, ``decoder.dec{i}.up``,
``decoder.dec{i}.conv.conv.*``, ``decoder.out``), so
``utils.convert.state_dict_from_jax`` loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops.precision import wide
from . import fused
from .blocks import ConvBlock, ConvBlockDownsample



class Encoder(nn.Module):
    def __init__(
        self,
        dtype: torch.dtype = torch.bfloat16,
        w2d_level0: bool = False,
        w2d_level1_fold2: bool = False,
        w2d_impl: str = "dense",
        *,
        device=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.w2d_level0 = bool(w2d_level0)
        self.level1 = self.w2d_level0 and bool(w2d_level1_fold2)
        self.input = nn.Conv2d(3, 32, 1, device=device)
        self.enc1 = fused.block_classes(w2d_impl, self.w2d_level0)[0](32, 64, device=device)
        self.enc2 = fused.block_classes(w2d_impl, self.level1)[0](64, 64, device=device)
        self.enc3 = ConvBlockDownsample(64, 64, device=device)
        self.bottleneck = ConvBlock(64, 64, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                folded: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """x (B, H, W, 3) -> every level; ``folded`` (the Autoencoder's one
        gate) defaults to this encoder's own: ``w2d_level0`` and the width a
        multiple of 8 (autoencoder.py:40)."""
        x = x.to(self.dtype)
        if folded is None:
            folded = self.w2d_level0 and x.shape[2] % fused.FOLD_WIDTH == 0
        x0 = fused.conv1x1(x, self.input, folded=folded)
        x1 = fused.block_forward(self.enc1, x0, train=train, kernels=folded)
        x2 = fused.block_forward(self.enc2, x1, train=train, kernels=folded and self.level1)
        x3 = fused.block_forward(self.enc3, x2, train=train, kernels=True)
        return {"x0": x0, "enc1": x1, "enc2": x2, "enc3": x3,
                "bottleneck": fused.block_forward(self.bottleneck, x3, train=train,
                                                  kernels=True)}


class Decoder(nn.Module):
    def __init__(
        self,
        out_channels: int = 3,
        dtype: torch.dtype = torch.bfloat16,
        w2d_level0: bool = False,
        w2d_level1_fold2: bool = False,
        w2d_level2_fold2: bool = False,
        w2d_impl: str = "dense",
        *,
        device=None,
    ):
        super().__init__()
        self.w2d_level0 = bool(w2d_level0)
        self.level1 = self.w2d_level0 and bool(w2d_level1_fold2)
        self.level2 = self.w2d_level0 and bool(w2d_level2_fold2)
        up = [fused.block_classes(w2d_impl, on)[2]
              for on in (self.level2, self.level1, self.w2d_level0)]
        self.dec1 = up[0](64, 64, device=device)
        self.dec2 = up[1](64, 64, device=device)
        self.dec3 = up[2](64, 32, device=device)
        self.out = nn.Conv2d(32, out_channels, 1, device=device)

    def forward(self, bottleneck: torch.Tensor, *, train: bool = False,
                folded: Optional[bool] = None) -> torch.Tensor:
        """bottleneck (B, h, w, 64) -> (B, 8h, 8w, out_channels) fp32, no
        activation; ``folded`` defaults to ``w2d_level0``."""
        folded = self.w2d_level0 if folded is None else folded
        h = fused.block_forward(self.dec1, bottleneck, train=train, kernels=folded and self.level2)
        h = fused.block_forward(self.dec2, h, train=train, kernels=folded and self.level1)
        h = fused.block_forward(self.dec3, h, train=train, kernels=folded)
        return wide(fused.conv1x1(h, self.out, folded=folded))


class Autoencoder(nn.Module):
    """Reconstruction autoencoder: ``forward(x (B, H, W, 3)) -> sigmoid
    output (B, H, W, out_channels) fp32`` (autoencoder.py:148-175)."""

    def __init__(
        self,
        out_channels: int = 3,
        dtype: torch.dtype = torch.bfloat16,
        w2d_level0: bool = False,
        w2d_level1_fold2: bool = False,
        w2d_level2_fold2: bool = False,
        w2d_impl: str = "dense",
        *,
        device=None,
    ):
        super().__init__()
        self.w2d_level0 = bool(w2d_level0)
        self.encoder = Encoder(dtype, w2d_level0, w2d_level1_fold2, w2d_impl, device=device)
        self.decoder = Decoder(out_channels, dtype, w2d_level0, w2d_level1_fold2,
                               w2d_level2_fold2, w2d_impl, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        # one gate for both halves (autoencoder.py:160-163)
        folded = self.w2d_level0 and x.shape[2] % fused.FOLD_WIDTH == 0
        feats = self.encoder(x, train=train, folded=folded)
        return torch.sigmoid(self.decoder(feats["bottleneck"], train=train, folded=folded))
