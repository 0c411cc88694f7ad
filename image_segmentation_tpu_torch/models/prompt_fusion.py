"""Image encoder + prompt encoder fused at the bottleneck, NHWC;
counterpart of ``image_segmentation_tpu/models/prompt_fusion.py``
(PromptEncoderV1 :25, SegmentationModelWithPrompt :45).

The autoencoder's :class:`~.autoencoder.Encoder` (bottleneck 64 wide at
1/8) and a PromptEncoderV1 (the 1-channel heatmap through three
downsampling blocks 32/64/128 and a ConvBlock to the bottleneck width) are
fused by ``"concat"`` (channel concat + 1x1 ``fusion_conv`` back to 64) or
``"add"``, then the autoencoder's :class:`~.autoencoder.Decoder` gives the
logits.  Every part runs at its defaults, the standard blocks (JAX builds
them unfolded): this model runs no kernel.

Module names follow the JAX tree (``image_encoder``, ``prompt_encoder``,
``fusion_conv``, ``decoder``) with the reference torch layout inside, so
``utils.convert.state_dict_from_jax`` loads it strictly.
"""

from __future__ import annotations

import torch
from torch import nn

from .autoencoder import Decoder, Encoder
from .blocks import conv1x1_nhwc
from .clip_models import PromptEncoder

FUSIONS = ("concat", "add")


class PromptEncoderV1(PromptEncoder):
    """prompt_fusion.py:25-42: ConvBlockDownsample 1 -> 32 -> 64 -> 128 and
    ConvBlock(out_features) at 1/8 (the standard blocks of
    :class:`~.clip_models.PromptEncoder`); a (B, H, W) prompt gets its
    channel axis."""

    def forward(self, prompt: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        if prompt.dim() == 3:
            prompt = prompt[..., None]
        return super().forward(prompt, train=train)


class SegmentationModelWithPrompt(nn.Module):
    """``forward(x (B, H, W, 3), prompt (B, H, W[, 1])) -> logits (B, H, W,
    out_channels) fp32`` (prompt_fusion.py:45-81), H and W multiples of 8."""

    def __init__(
        self,
        out_channels: int = 1,
        fusion: str = "concat",
        dtype: torch.dtype = torch.bfloat16,
        *,
        device=None,
    ):
        super().__init__()
        if fusion not in FUSIONS:
            raise ValueError(f"unknown fusion {fusion!r}")
        self.dtype = dtype
        self.fusion = fusion
        self.image_encoder = Encoder(dtype, device=device)
        self.prompt_encoder = PromptEncoderV1(64, dtype, device=device)
        if fusion == "concat":
            self.fusion_conv = nn.Conv2d(128, 64, 1, device=device)
        self.decoder = Decoder(out_channels, dtype, device=device)

    def forward(self, x: torch.Tensor, prompt: torch.Tensor, *,
                train: bool = False) -> torch.Tensor:
        bottleneck = self.image_encoder(x, train=train)["bottleneck"]
        prompt_emb = self.prompt_encoder(prompt, train=train).to(bottleneck.dtype)
        if self.fusion == "concat":
            fused = conv1x1_nhwc(torch.cat([bottleneck, prompt_emb], dim=-1), self.fusion_conv)
        else:
            fused = bottleneck + prompt_emb
        return self.decoder(fused, train=train)
