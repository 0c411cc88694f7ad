"""The CLIP-conditioned U-Net and the prompt model, NHWC; counterpart of
``image_segmentation_tpu/models/clip_models.py`` (FROZEN_PREFIXES :37,
ClipUnet :40-139, PromptEncoder :307-358, ClipUnetPrompt :361-455).

The frozen CLIP tower (:mod:`.clip`) embeds the image; the embedding is
one context token for :class:`~..ops.cross_attention.CrossAttentionFusion`
at the 512-wide bottleneck, so the fusion takes its exact one-key path
(``out_proj(v_proj(embedding))`` broadcast over the map) and no attention
kernel.  Its output does not depend on the bottleneck block's output: that
block still runs, and its running statistics update, but its parameters
get zero gradients (the Trainer fills them in, as JAX's are zeros).

The level 0-1 blocks take the block family of ``w2d_impl`` exactly as the
U-Nets decide it (``models/unet.py``, :func:`.fused.block_classes`):
``w2d_level0`` folds the stem level (enc1, dec4, and the prompt encoder's
enc1), adding ``w2d_level1_fold2`` also level 1 (enc2, dec3, the prompt
encoder's enc2); under ``"pallas_fused"`` they are the fused kernel
blocks, under ``"pallas"`` the unfused ones.  With ``w2d_level0`` the stem
and the output conv train through K11 (:func:`.fused.conv1x1`; JAX's
``Folded1x1``, clip_models.py:75,129,394,447); ``prompt_fusion`` stays a
plain 1x1 conv.  The prompt encoder's enc1 reads the 1-channel heatmap, a
model input, with ``input_grad=False`` in the fused family
(clip_models.py:327-340): its backward runs conv1's wgrad kernel alone, as
the unfused family's does on its own (the heatmap needs no gradient).

Module names follow the reference torch layout
(``utils/torch_export.clip_unet_state_dict`` :196 and
``clip_unet_prompt_state_dict`` :272): ``clip_feature_extractor.
clip_model.*``, ``cross_attention_fusion.cross_attn.*``, the U-Net keys,
``prompt_encoder.enc{1-3}.block.0.conv.*``, ``prompt_encoder.conv.conv.*``
and ``prompt_fusion``, so ``utils.convert.state_dict_from_jax`` loads the
JAX tree strictly.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from ..ops.cross_attention import CrossAttentionFusion
from . import fused
from .blocks import ConvBlock, ConvBlockDownsample, ConvBlockUpsampleSkip, conv1x1_nhwc
from .clip import ClipFeatureExtractor

# Parameter subtrees that are frozen: not decayed, not updated (the JAX
# Trainer's set_to_zero mask on "clip_tower"; the ResNet backbone of
# clip_res comes with that model).
FROZEN_PREFIXES = ("clip_feature_extractor.",)


def level_classes(w2d_level0: bool, w2d_level1_fold2: bool, w2d_impl: str):
    """The (Downsample, UpsampleSkip, Upsample) classes of level 0 and of
    level 1, as models/unet.py picks them."""
    return (fused.block_classes(w2d_impl, bool(w2d_level0)),
            fused.block_classes(w2d_impl, bool(w2d_level0 and w2d_level1_fold2)))


class ClipUnet(nn.Module):
    """U-Net (stem 32, encoders 64/128/256, bottleneck 512) whose bottleneck
    is fused with the frozen CLIP image embedding (CLIP_models.py:63-134).
    ``forward(x (B, H, W, 3) in [0, 1]) -> logits (B, H, W, out) fp32``."""

    def __init__(
        self,
        out_channels: int = 3,
        dtype: torch.dtype = torch.bfloat16,
        freeze_clip: bool = True,
        clip_kwargs: Optional[Mapping[str, Any]] = None,
        w2d_level0: bool = False,
        w2d_level1_fold2: bool = False,
        w2d_impl: str = "dense",
        *,
        device=None,
    ):
        super().__init__()
        if not freeze_clip:
            raise NotImplementedError(
                "freeze_clip=False (training the CLIP tower) is not ported; the tower is "
                "frozen as in every preset")
        self.dtype = dtype
        self.folded = bool(w2d_level0)
        l0, l1 = level_classes(w2d_level0, w2d_level1_fold2, w2d_impl)
        self.clip_feature_extractor = ClipFeatureExtractor(dtype, clip_kwargs, device=device)
        proj_dim = self.clip_feature_extractor.clip_model.proj_dim
        self.input = nn.Conv2d(3, 32, 1, device=device)
        self.enc1 = l0[0](32, 64, device=device)
        self.enc2 = l1[0](64, 128, device=device)
        self.enc3 = ConvBlockDownsample(128, 256, device=device)
        self.bottleneck = ConvBlock(256, 512, device=device)
        self.cross_attention_fusion = CrossAttentionFusion(512, 1, dtype, kv_dim=proj_dim,
                                                           device=device)
        self.dec1 = ConvBlockUpsampleSkip(512, 256, device=device)
        self.dec2 = ConvBlockUpsampleSkip(256, 128, device=device)
        self.dec3 = l1[1](128, 64, device=device)
        self.dec4 = l0[1](64, 32, device=device)
        self.out = nn.Conv2d(32, out_channels, 1, device=device)

    def encode(self, x: torch.Tensor, train: bool):
        """(skips [stem, enc1, enc2, enc3], the fusion's output)."""
        clip_feats = self.clip_feature_extractor(x)
        stem = fused.conv1x1(x, self.input, folded=self.folded)
        skips = [stem]
        h = stem
        for enc in (self.enc1, self.enc2, self.enc3):
            h = enc(h, train=train)
            skips.append(h)
        bottleneck = self.bottleneck(h, train=train)
        return skips, self.cross_attention_fusion(bottleneck, clip_feats)

    def decode(self, h: torch.Tensor, skips, train: bool) -> torch.Tensor:
        for dec, skip in zip((self.dec1, self.dec2, self.dec3, self.dec4), skips[::-1]):
            h = dec(h.contiguous(), skip, train=train)
        return fused.conv1x1(h, self.out, folded=self.folded).float()

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        skips, attn = self.encode(x, train)
        return self.decode(attn, skips, train)


class PromptEncoder(nn.Module):
    """1-channel heatmap -> three downsampling blocks (32, 64, 128) ->
    ConvBlock(out_features) at 1/8 resolution (prompt_segmentation.py:
    16-30)."""

    def __init__(
        self,
        out_features: int = 512,
        dtype: torch.dtype = torch.bfloat16,
        w2d_level0: bool = False,
        w2d_level1_fold2: bool = False,
        w2d_impl: str = "dense",
        *,
        device=None,
    ):
        super().__init__()
        self.dtype = dtype
        (down0, _, _), (down1, _, _) = level_classes(w2d_level0, w2d_level1_fold2, w2d_impl)
        # the heatmap is a model input: never differentiated (see module doc)
        fused0 = issubclass(down0, fused.FusedConvBlockDownsample)
        self.enc1 = down0(1, 32, device=device, **({"input_grad": False} if fused0 else {}))
        self.enc2 = down1(32, 64, device=device)
        self.enc3 = ConvBlockDownsample(64, 128, device=device)
        self.conv = ConvBlock(128, out_features, device=device)

    def forward(self, prompt: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        h = prompt.to(self.dtype)
        for enc in (self.enc1, self.enc2, self.enc3):
            h = enc(h, train=train)
        return self.conv(h, train=train)


class ClipUnetPrompt(ClipUnet):
    """ClipUnet with the prompt branch fused at the bottleneck
    (prompt_segmentation.py:32-95): ``forward(x (B, H, W, 3), prompt (B,
    H, W[, 1])) -> binary logits (B, H, W, 1) fp32``.  The fusion's output
    and the prompt embedding are concatenated and mixed by the 1x1
    ``prompt_fusion`` conv (1024 -> 512) before the decoders."""

    def __init__(
        self,
        out_channels: int = 1,
        dtype: torch.dtype = torch.bfloat16,
        freeze_clip: bool = True,
        clip_kwargs: Optional[Mapping[str, Any]] = None,
        w2d_level0: bool = False,
        w2d_level1_fold2: bool = False,
        w2d_impl: str = "dense",
        *,
        device=None,
    ):
        super().__init__(out_channels, dtype, freeze_clip, clip_kwargs, w2d_level0,
                         w2d_level1_fold2, w2d_impl, device=device)
        self.prompt_encoder = PromptEncoder(512, dtype, w2d_level0, w2d_level1_fold2, w2d_impl,
                                            device=device)
        self.prompt_fusion = nn.Conv2d(1024, 512, 1, device=device)

    def forward(self, x: torch.Tensor, prompt: torch.Tensor, *,
                train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        if prompt.dim() == 3:
            prompt = prompt[..., None]
        skips, attn = self.encode(x, train)
        prompt_emb = self.prompt_encoder(prompt, train=train)
        h = conv1x1_nhwc(torch.cat([attn.to(self.dtype), prompt_emb], dim=-1),
                         self.prompt_fusion)
        return self.decode(h, skips, train)
