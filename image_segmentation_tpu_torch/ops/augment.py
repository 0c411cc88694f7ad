"""Input normalisation; counterpart of ``image_segmentation_tpu/ops/augment.py``
(``normalize_image`` :35 only — the training augmentations are not ported
yet)."""

from __future__ import annotations

import torch


def normalize_image(
    images_u8: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """uint8 NHWC -> [0, 1] float, on the tensor's own device."""
    return images_u8.to(dtype) / 255.0
