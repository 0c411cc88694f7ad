"""The CLIP-conditioned models, NHWC; counterpart of
``image_segmentation_tpu/models/clip_models.py`` (FROZEN_PREFIXES :37,
ClipUnet :40-139, ClipResSegmentationModel :142-198, ClipAutoencoder
:201-235, ClipResSegmentationClassification :238-304, PromptEncoder
:307-358, ClipUnetPrompt :361-455).

The CLIP tower (:mod:`.clip`), frozen unless ``freeze_clip=False``,
embeds the image; the embedding is one context token for
:class:`~..ops.cross_attention.CrossAttentionFusion` at the 512-wide
bottleneck, so the fusion takes its exact one-key path
(``out_proj(v_proj(embedding))`` broadcast over the map) and no attention
kernel.  Its output does not depend on the map it is fused with: in
ClipUnet the bottleneck block still runs, and its running statistics
update, but its parameters get zero gradients (the Trainer fills them in,
as JAX's are zeros); in the ClipRes models the map is the frozen ResNet-34
backbone's (:mod:`.resnet`), which runs all the same (in training its
running statistics move as JAX's do; in eval its output is unread, where
XLA drops it and the port runs it as the JAX module is written).

The level 0-1 blocks take the block family of ``w2d_impl`` exactly as the
U-Nets decide it (``models/unet.py``, :func:`.fused.block_classes`):
``w2d_level0`` folds the stem level (enc1, dec4, and the prompt encoder's
enc1), adding ``w2d_level1_fold2`` also level 1 (enc2, dec3, the prompt
encoder's enc2); under ``"pallas_fused"`` they are the fused kernel
blocks, under ``"pallas"`` the unfused ones.  They run so only where
JAX's fold gate holds, an image width that is a multiple of 8
(clip_models.py:68, :323, :384); at any other width they run the standard
math on their parameters (:func:`.fused.block_forward`) and the stem and
output are plain 1x1 convs.  With ``w2d_level0`` the stem
and the output conv train through K11 (:func:`.fused.conv1x1`; JAX's
``Folded1x1``, clip_models.py:75,129,394,447); ``prompt_fusion`` stays a
plain 1x1 conv.  The prompt encoder's enc1 reads the 1-channel heatmap, a
model input, with ``input_grad=False`` in the fused family
(clip_models.py:327-340): its backward runs conv1's wgrad kernel alone, as
the unfused family's does on its own (the heatmap needs no gradient).  The
ClipRes models fold their full-resolution level (dec5, and ``out``, which
reads ``[dec5 | image]`` as the kernels' two inputs) with ``w2d_level0``
where JAX's gate holds (:176, :285).

Tensor parallelism (``parallel/tensor.py``): every layer whose weight
JAX's rule shards is column-parallel: the blocks (:mod:`.blocks`,
:mod:`.fused`), the tower and the fusion, the frozen ResNet-34's convs
(:mod:`.resnet`) and the ClipAutoencoder's ``coupler`` (:func:`dense`).
In the ClipRes models dec5 and the output block stay whole (their kernels
are under the rule's 4096 elements), as does the class head's Dense(1).

Module names follow the reference torch layout
(``utils/torch_export.clip_unet_state_dict`` :196,
``clip_res_state_dict`` :240, ``clip_autoencoder_state_dict`` :257 and
``clip_unet_prompt_state_dict`` :272): ``clip_feature_extractor.
clip_model.*``, ``cross_attention_fusion.cross_attn.*``, the U-Net keys,
``encoder.model.*`` (the ResNet), ``coupler``, ``prompt_encoder.enc{1-3}.
block.0.conv.*``, ``prompt_encoder.conv.conv.*`` and ``prompt_fusion``,
so ``utils.convert.state_dict_from_jax`` loads the JAX tree strictly.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cross_attention import CrossAttentionFusion
from ..ops.precision import wide
from ..parallel import tensor as tp
from . import fused
from .blocks import (
    ConvBlock,
    ConvBlockDownsample,
    ConvBlockUpsample,
    ConvBlockUpsampleSkip,
    conv1x1_nhwc,
)
from .clip import ClipFeatureExtractor
from .resnet import ResNet34Features

# Parameter subtrees that are frozen: not decayed, not updated (the JAX
# Trainer's set_to_zero mask on "clip_tower").  The ClipRes models' ResNet
# backbone (JAX's "resnet_backbone") is frozen by module: its parameters do
# not require grad (ClipResSegmentationModel), which keeps them out of the
# optimizer (engine/train.trainable_parameters) without a prefix that would
# also match the autoencoder's trainable ``encoder.``.
FROZEN_PREFIXES = ("clip_feature_extractor.",)


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """flax ``nn.Dense(dtype=x.dtype)``: the weight and bias cast to x's
    dtype; column-parallel when its weight is sharded (the ClipAutoencoder's
    ``coupler``; the class head's one output stays whole)."""
    def op(x, w, b):
        return F.linear(x, w.to(x.dtype), b.to(x.dtype))

    return tp.column(op, x, layer.weight, layer.bias, tp.shard(layer))


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
        self.dtype = dtype
        self.folded = bool(w2d_level0)
        l0, l1 = level_classes(w2d_level0, w2d_level1_fold2, w2d_impl)
        self.clip_feature_extractor = ClipFeatureExtractor(dtype, clip_kwargs, freeze_clip,
                                                           device=device)
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

    def kernels(self, width: int) -> bool:
        """JAX's fold gate (clip_models.py:68): where it is off, the folded
        levels run the standard math on their parameters."""
        return self.folded and width % fused.FOLD_WIDTH == 0

    def encode(self, x: torch.Tensor, train: bool):
        """(skips [stem, enc1, enc2, enc3], the fusion's output)."""
        kernels = self.kernels(x.shape[2])
        clip_feats = self.clip_feature_extractor(x)
        stem = fused.conv1x1(x, self.input, folded=kernels)
        skips = [stem]
        h = stem
        for enc in (self.enc1, self.enc2, self.enc3):
            h = fused.block_forward(enc, h, train=train, kernels=kernels)
            skips.append(h)
        bottleneck = fused.block_forward(self.bottleneck, h, train=train, kernels=True)
        return skips, self.cross_attention_fusion(bottleneck, clip_feats)

    def decode(self, h: torch.Tensor, skips, train: bool) -> torch.Tensor:
        kernels = self.kernels(skips[0].shape[2])
        for dec, skip in zip((self.dec1, self.dec2, self.dec3, self.dec4), skips[::-1]):
            h = fused.block_forward(dec, h.contiguous(), skip, train=train, kernels=kernels)
        return wide(fused.conv1x1(h, self.out, folded=kernels))

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        skips, attn = self.encode(x, train)
        return self.decode(attn, skips, train)


class ClipResSegmentationModel(nn.Module):
    """The frozen ResNet-34 features fused with the CLIP embedding, a
    skip-less decoder (dec1-dec5: 512 -> 256 -> 128 -> 64 -> 32 -> 16, each
    a ConvTranspose 2x2/2 and a ConvBlock) and an output ConvBlock on
    ``[dec5 | image]`` (16 + 3 -> out_channels), clip_models.py:142-198:
    ``forward(x (B, H, W, 3) in [0, 1], H and W multiples of 32) -> logits
    (B, H, W, out_channels) fp32``.  The output block ends in BatchNorm and
    ReLU, so the logits are >= 0: the reference's quirk, kept.

    The backbone is frozen: it runs without autograd (JAX's
    ``stop_gradient``) and its parameters do not require grad, so no
    optimizer holds them, whatever ``freeze_backbone`` says (the JAX
    Trainer masks ``resnet_backbone`` in every model, engine/train.py:62-81).
    ``freeze_backbone=False`` is accepted and changes nothing observable:
    the one-token fusion does not read the backbone's output.  In training
    the backbone normalises with its batch statistics and commits its
    running averages, as the JAX module does.

    With ``w2d_level0``, where JAX folds (the gate of :meth:`decode`), dec5
    is the ``w2d_impl`` family's Upsample block and ``out`` its ConvBlock,
    whose conv1 reads the pair ``(dec5 output, image)`` as the kernels' two
    inputs, never concatenated (``"pallas_fused"``).  dec1-dec4 are the
    standard blocks (cuDNN)."""

    def __init__(
        self,
        out_channels: int = 3,
        dtype: torch.dtype = torch.bfloat16,
        freeze_clip: bool = True,
        freeze_backbone: bool = True,
        clip_kwargs: Optional[Mapping[str, Any]] = None,
        w2d_level0: bool = False,
        w2d_impl: str = "dense",
        *,
        device=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.folded = bool(w2d_level0)
        up = fused.block_classes(w2d_impl, self.folded)[2]
        self.clip_feature_extractor = ClipFeatureExtractor(dtype, clip_kwargs, freeze_clip,
                                                           device=device)
        proj_dim = self.clip_feature_extractor.clip_model.proj_dim
        self.encoder = ResNet34Features(dtype, device=device).requires_grad_(False)
        self.cross_attention_fusion = CrossAttentionFusion(512, 4, dtype, kv_dim=proj_dim,
                                                           device=device)
        self.dec1 = ConvBlockUpsample(512, 256, device=device)
        self.dec2 = ConvBlockUpsample(256, 128, device=device)
        self.dec3 = ConvBlockUpsample(128, 64, device=device)
        self.dec4 = ConvBlockUpsample(64, 32, device=device)
        self.dec5 = up(32, 16, device=device)
        self._make_head(out_channels, device)

    def _make_head(self, out_channels: int, device) -> None:
        self.out = self.dec5.block_cls(16 + 3, out_channels, device=device)

    def trunk(self, x: torch.Tensor, train: bool):
        """(the CLIP embedding, dec4's output) of x in the compute dtype."""
        clip_feats = self.clip_feature_extractor(x)
        with torch.no_grad():  # the frozen backbone (its statistics still commit)
            res = self.encoder(x, train=train)
        h = self.cross_attention_fusion(res, clip_feats)
        for dec in (self.dec1, self.dec2, self.dec3, self.dec4):
            h = fused.block_forward(dec, h.contiguous(), train=train, kernels=True)
        return clip_feats, h

    def decode(self, h: torch.Tensor, train: bool):
        """dec5 on dec4's output: (its output, whether JAX folds here)."""
        # JAX's gate of this level: the width after dec5's up-conv a
        # multiple of the fold (clip_models.py:176)
        folded = self.folded and (2 * h.shape[2]) % fused.FOLD == 0
        return fused.block_forward(self.dec5, h.contiguous(), train=train, kernels=folded), folded

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        _, h = self.trunk(x, train)
        h, folded = self.decode(h, train)
        return wide(fused.block_forward(self.out, h.contiguous(), x.contiguous(), train=train,
                                        kernels=folded))


class ClipResSegmentationClassification(ClipResSegmentationModel):
    """Joint binary segmentation and cat/dog classification
    (clip_models.py:238-304): the ClipRes trunk and dec5, then a 1x1
    ``mask_out`` (16 + 3 -> 1) on ``[dec5 | image]`` and a ``class_head``
    Dense(1) on the CLIP embedding.  ``forward(x) -> (mask_logits (B, H, W,
    1), class_logits (B, 1))``, both fp32.

    ``mask_out`` is a plain matmul in every configuration (JAX's
    ``Folded1x1`` with ``in_perm`` never takes the 1x1 backward kernel,
    folded.py:253-280), so it is :func:`~.blocks.conv1x1_nhwc` on the
    concat, never K11."""

    def __init__(
        self,
        dtype: torch.dtype = torch.bfloat16,
        freeze_clip: bool = True,
        freeze_backbone: bool = True,
        clip_kwargs: Optional[Mapping[str, Any]] = None,
        w2d_level0: bool = False,
        w2d_impl: str = "dense",
        *,
        device=None,
    ):
        super().__init__(1, dtype, freeze_clip, freeze_backbone, clip_kwargs, w2d_level0,
                         w2d_impl, device=device)

    def _make_head(self, out_channels: int, device) -> None:
        self.mask_out = nn.Conv2d(16 + 3, 1, 1, device=device)
        proj_dim = self.clip_feature_extractor.clip_model.proj_dim
        self.class_head = nn.Linear(proj_dim, 1, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False):
        x = x.to(self.dtype)
        clip_feats, h = self.trunk(x, train)
        h, _ = self.decode(h, train)
        mask = conv1x1_nhwc(torch.cat([h, x.to(h.dtype)], dim=-1), self.mask_out)
        return wide(mask), wide(dense(clip_feats.to(self.dtype), self.class_head))


class ClipAutoencoder(nn.Module):
    """The CLIP embedding -> ``coupler`` Dense(512 -> 16384) -> the
    channel-major view (B, 64, 16, 16) as NHWC -> dec1-dec3 ConvBlockUpsample
    (64, 64, 32) -> dec4 ConvBlockUpsampleSkip (32) with the 1x1 ``input``
    stem -> 1x1 ``out`` (clip_models.py:201-235): ``forward(x (B, H, W, 3))
    -> logits (B, H, W, out_channels) fp32``, a segmentation model despite
    its name.  No preset folds it: it runs no kernel."""

    def __init__(
        self,
        out_channels: int = 3,
        dtype: torch.dtype = torch.bfloat16,
        freeze_clip: bool = True,
        clip_kwargs: Optional[Mapping[str, Any]] = None,
        *,
        device=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.clip_feature_extractor = ClipFeatureExtractor(dtype, clip_kwargs, freeze_clip,
                                                           device=device)
        proj_dim = self.clip_feature_extractor.clip_model.proj_dim
        self.input = nn.Conv2d(3, 32, 1, device=device)
        self.coupler = nn.Linear(proj_dim, 64 * 16 * 16, device=device)
        self.dec1 = ConvBlockUpsample(64, 64, device=device)
        self.dec2 = ConvBlockUpsample(64, 64, device=device)
        self.dec3 = ConvBlockUpsample(64, 32, device=device)
        self.dec4 = ConvBlockUpsampleSkip(32, 32, device=device)
        self.out = nn.Conv2d(32, out_channels, 1, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        clip_feats = self.clip_feature_extractor(x)
        stem = conv1x1_nhwc(x, self.input)
        # whole: a sharded coupler's slices are gathered before the view,
        # since a slice of the 16384 axis is not a slice of the channels
        h = dense(clip_feats.to(self.dtype), self.coupler)
        # torch's .view(-1, 64, 16, 16) is channel-major: NCHW, then NHWC (:222)
        h = h.reshape(x.shape[0], 64, 16, 16).permute(0, 2, 3, 1).contiguous()
        for dec in (self.dec1, self.dec2, self.dec3):
            h = fused.block_forward(dec, h, train=train, kernels=True)
        h = fused.block_forward(self.dec4, h, stem, train=train, kernels=True)
        return wide(conv1x1_nhwc(h, self.out))


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
        self.folded = bool(w2d_level0)
        (down0, _, _), (down1, _, _) = level_classes(w2d_level0, w2d_level1_fold2, w2d_impl)
        # the heatmap is a model input: never differentiated (see module doc)
        fused0 = issubclass(down0, fused.FusedConvBlockDownsample)
        self.enc1 = down0(1, 32, device=device, **({"input_grad": False} if fused0 else {}))
        self.enc2 = down1(32, 64, device=device)
        self.enc3 = ConvBlockDownsample(64, 128, device=device)
        self.conv = ConvBlock(128, out_features, device=device)

    def forward(self, prompt: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        h = prompt.to(self.dtype)
        kernels = self.folded and h.shape[2] % fused.FOLD_WIDTH == 0  # clip_models.py:323
        for enc in (self.enc1, self.enc2, self.enc3):
            h = fused.block_forward(enc, h, train=train, kernels=kernels)
        return fused.block_forward(self.conv, h, train=train, kernels=True)


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
