"""Raw record deserialization and mask palette remapping; counterpart of
``image_segmentation_tpu/data/records.py``, copied whole (numpy only).

Host-side: images stay uint8 HWC until they reach the device, where they
are normalised (a uint8 host->device copy is 4x cheaper than fp32).

Reference semantics reproduced:

- byte record -> uint8 (256,256,3) image / (256,256) mask
  (customDatasets/datasets.py:133-135)
- mask palette {38: cat, 75: dog, 255: uncertain ring} -> class ids
  {0: background, 1: cat, 2: dog}; the uncertain ring is absorbed into
  whichever animal is present: if ANY cat pixel exists the image is treated
  as a cat image (uncertain -> 1), else uncertain -> 2
  (customDatasets/datasets.py:118-128).
"""

from __future__ import annotations

import numpy as np

IMAGE_SHAPE = (256, 256, 3)
MASK_SHAPE = (256, 256)

CAT_PALETTE = 38
DOG_PALETTE = 75
UNCERTAIN_PALETTE = 255

BACKGROUND_ID = 0
CAT_ID = 1
DOG_ID = 2


def deserialize_image(byte_data: bytes, shape=IMAGE_SHAPE) -> np.ndarray:
    """Bytes -> uint8 array copy (datasets.py:133-135)."""
    return np.frombuffer(byte_data, dtype=np.uint8).reshape(shape).copy()


def remap_mask(raw_mask: np.ndarray) -> np.ndarray:
    """Palette mask (uint8 values {38,75,255,...}) -> class-id mask (uint8).

    Vectorized equivalent of datasets.py:118-128 including the
    uncertain-absorption rule.  Values other than the three palette entries
    map to background.
    """
    is_cat = raw_mask == CAT_PALETTE
    is_dog = raw_mask == DOG_PALETTE
    is_unc = raw_mask == UNCERTAIN_PALETTE
    animal = CAT_ID if is_cat.any() else DOG_ID
    out = np.zeros(raw_mask.shape, dtype=np.uint8)
    out[is_cat] = CAT_ID
    out[is_dog] = DOG_ID
    out[is_unc] = animal
    return out


def remap_mask_batch(raw_masks: np.ndarray) -> np.ndarray:
    """Batched :func:`remap_mask` over (N, H, W) palette masks."""
    is_cat = raw_masks == CAT_PALETTE
    is_dog = raw_masks == DOG_PALETTE
    is_unc = raw_masks == UNCERTAIN_PALETTE
    animal = np.where(
        is_cat.any(axis=(1, 2)), np.uint8(CAT_ID), np.uint8(DOG_ID)
    ).astype(np.uint8)
    out = np.zeros(raw_masks.shape, dtype=np.uint8)
    out[is_cat] = CAT_ID
    out[is_dog] = DOG_ID
    out = np.where(is_unc, animal[:, None, None], out)
    return out


def binary_any_animal_mask(raw_mask: np.ndarray) -> np.ndarray:
    """Binary segment mask (animal union uncertain) + scalar class label.

    Reference ClassImageDataset semantics (datasets.py:442-459): mask is
    cat|dog|uncertain as {0,1}; label 0 = cat image, 1 = dog image.
    """
    seg = (
        (raw_mask == CAT_PALETTE)
        | (raw_mask == DOG_PALETTE)
        | (raw_mask == UNCERTAIN_PALETTE)
    ).astype(np.uint8)
    label = 0 if (raw_mask == CAT_PALETTE).any() else 1
    return seg, label


def binary_any_animal_batch(raw_masks: np.ndarray):
    """Batched :func:`binary_any_animal_mask`: (segs (N,H,W) uint8,
    labels (N,) uint8 with 0=cat image, 1=dog image)."""
    segs = (
        (raw_masks == CAT_PALETTE)
        | (raw_masks == DOG_PALETTE)
        | (raw_masks == UNCERTAIN_PALETTE)
    ).astype(np.uint8)
    labels = (~(raw_masks == CAT_PALETTE).any(axis=(1, 2))).astype(np.uint8)
    return segs, labels


def class_presence_masks(raw_mask: np.ndarray):
    """(cat, dog, background) float32 masks for the prompt dataset.

    Reference PromptImageDataset._deserialize (datasets.py:535-547): cat/dog
    are palette matches; background is everything else (1 - cat - dog), so
    the uncertain ring counts as background here.
    """
    cat = (raw_mask == CAT_PALETTE).astype(np.float32)
    dog = (raw_mask == DOG_PALETTE).astype(np.float32)
    bg = 1.0 - (cat + dog)
    return cat, dog, bg
