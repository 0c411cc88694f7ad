"""Model registry: config name -> port model; counterpart of
``image_segmentation_tpu/models/registry.py``.

Every JAX registry name is ported: the U-Nets, the CLIP models (ClipUnet,
ClipRes, ClipAutoencoder, ClipResSegmentationClassification, the prompt
model), the autoencoder and ``prompt_fusion``.  JAX registers
``prompt_fusion`` only once its module is imported (registry.py:24-34);
the port registers every name here.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils import spans
from .autoencoder import Autoencoder
from .clip_models import (
    ClipAutoencoder,
    ClipResSegmentationClassification,
    ClipResSegmentationModel,
    ClipUnet,
    ClipUnetPrompt,
)
from .prompt_fusion import SegmentationModelWithPrompt
from .unet import LargeUNet, UNet

_REGISTRY = {"unet": UNet, "large_unet": LargeUNet, "clip_unet": ClipUnet,
             "clip_res": ClipResSegmentationModel, "clip_autoencoder": ClipAutoencoder,
             "clip_unet_prompt": ClipUnetPrompt, "clip_res_class": ClipResSegmentationClassification,
             "autoencoder": Autoencoder, "prompt_fusion": SegmentationModelWithPrompt}
MODEL_NAMES = tuple(_REGISTRY)


def build_model(
    name: str, *, device, dtype: torch.dtype = torch.bfloat16, **kwargs
) -> nn.Module:
    """Build registry model ``name`` with parameters on ``device`` and
    compute in ``dtype``; ``kwargs`` are the JAX model args.  Its blocks
    take their profiler spans' names from their module names
    (``utils.spans.name_blocks``)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return spans.name_blocks(_REGISTRY[name](dtype=dtype, device=device, **kwargs))
