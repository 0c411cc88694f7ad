"""Model registry: config name -> port model; counterpart of
``image_segmentation_tpu/models/registry.py``.

Ported: the U-Nets, ClipUnet, the prompt model and the autoencoder.  The
JAX package's other names (clip_res, clip_autoencoder, clip_res_class,
prompt_fusion) raise ``NotImplementedError`` naming the ROADMAP.md item
that ports them.
"""

from __future__ import annotations

import torch
from torch import nn

from .autoencoder import Autoencoder
from .clip_models import ClipUnet, ClipUnetPrompt
from .unet import LargeUNet, UNet

_REGISTRY = {"unet": UNet, "large_unet": LargeUNet, "clip_unet": ClipUnet,
             "clip_unet_prompt": ClipUnetPrompt, "autoencoder": Autoencoder}

# JAX registry names not ported yet -> the ROADMAP.md Queue 1 item.
_NOT_PORTED = {
    "clip_res": "Queue 1 'The remaining models'",
    "clip_autoencoder": "Queue 1 'The remaining models'",
    "clip_res_class": "Queue 1 'The remaining models'",
    "prompt_fusion": "Queue 1 'The remaining models'",
}


def build_model(
    name: str, *, device, dtype: torch.dtype = torch.bfloat16, **kwargs
) -> nn.Module:
    """Build registry model ``name`` with parameters on ``device`` and
    compute in ``dtype``; ``kwargs`` are the JAX model args."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet; see ROADMAP.md {_NOT_PORTED[name]}"
        )
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](dtype=dtype, device=device, **kwargs)
