"""In-memory array datasets; counterpart of
``image_segmentation_tpu/data/datasets.py`` (ArrayDataset :31,
synthetic_dataset :136).

The numpy code is the JAX package's, call for call, so one seed gives the
same arrays in both packages.  Loading the Oxford-IIIT-Pet split needs the
network and waits (ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Palette values of the raw Oxford-IIIT-Pet masks (data/records.py:25-27).
CAT_PALETTE = 38
DOG_PALETTE = 75
UNCERTAIN_PALETTE = 255


@dataclasses.dataclass
class ArrayDataset:
    """A fully materialized split.

    images: uint8 (N, H, W, 3)
    masks:  uint8 (N, H, W) class ids {0: bg, 1: cat, 2: dog}
    raw_masks: optional uint8 palette masks.
    """

    images: np.ndarray
    masks: np.ndarray
    raw_masks: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.images.dtype != np.uint8 or self.images.ndim != 4:
            raise ValueError(f"images must be uint8 NHWC, got {self.images.dtype} "
                             f"{self.images.shape}")
        if self.masks.dtype != np.uint8 or self.masks.ndim != 3:
            raise ValueError(f"masks must be uint8 (N, H, W), got {self.masks.dtype} "
                             f"{self.masks.shape}")
        if len(self.images) != len(self.masks):
            raise ValueError(f"{len(self.images)} images but {len(self.masks)} masks")

    def __len__(self) -> int:
        return len(self.images)


def synthetic_dataset(
    length: int = 100,
    height: int = 256,
    width: int = 256,
    num_classes: int = 3,
    seed: int = 0,
    keep_raw_masks: bool = False,
) -> ArrayDataset:
    """Random fixture: uniform uint8 images, random class-id masks and,
    with ``keep_raw_masks``, palette masks ({0, 38, 75, 255})."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (length, height, width, 3), dtype=np.uint8)
    masks = rng.integers(0, num_classes, (length, height, width)).astype(np.uint8)
    raw = None
    if keep_raw_masks:
        palette = np.array([0, CAT_PALETTE, DOG_PALETTE, UNCERTAIN_PALETTE], dtype=np.uint8)
        raw = palette[rng.integers(0, 4, (length, height, width))]
    return ArrayDataset(images, masks, raw)
