"""In-memory array datasets; counterpart of
``image_segmentation_tpu/data/datasets.py`` (ArrayDataset :31,
load_pet_dataset :53, synthetic_shapes_dataset :93, synthetic_dataset
:136).

The numpy code is the JAX package's, call for call, so one seed gives the
same arrays in both packages, and one split on disk loads to the same
arrays.  ``load_pet_dataset`` takes JAX's routes in order: the
``<split>_arrays.npz`` cache in ``dataset_loc``, then ``dataset_loc`` as a
local dataset directory read by HF ``datasets`` (imported when needed),
then the hub id, which needs the network.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from . import records
from .records import CAT_PALETTE, DOG_PALETTE, UNCERTAIN_PALETTE  # noqa: F401  (re-exported)

HF_DATASET_ID = "mattidebeer/Oxford-IIIT-Pet-Augmented"
SPLITS = ("train", "validation", "test")


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


def load_pet_dataset(
    split: str = "validation",
    dataset_loc: str = "Data/Oxford-IIIT-Pet-Augmented",
    cache: bool = True,
    keep_raw_masks: bool = False,
) -> ArrayDataset:
    """A split of mattidebeer/Oxford-IIIT-Pet-Augmented as arrays: the
    ``<split>_arrays.npz`` cache first; else ``dataset_loc`` through
    ``datasets.load_dataset`` (a local directory), falling back to the hub
    id with ``dataset_loc`` as its cache; the records deserialized and the
    palette masks remapped (``records``), and the cache written."""
    if split not in SPLITS:
        raise ValueError(f"split must be one of {SPLITS}, got {split!r}")

    cache_file = os.path.join(dataset_loc, f"{split}_arrays.npz")
    if cache and os.path.exists(cache_file):
        z = np.load(cache_file)
        raw = z["raw_masks"] if ("raw_masks" in z and keep_raw_masks) else None
        return ArrayDataset(z["images"], z["masks"], raw)

    from datasets import load_dataset  # HF datasets, imported when needed

    try:
        ds = load_dataset(dataset_loc, split=split)
    except Exception:
        ds = load_dataset(HF_DATASET_ID, split=split, cache_dir=dataset_loc)

    n = len(ds)
    images = np.empty((n,) + records.IMAGE_SHAPE, dtype=np.uint8)
    raw_masks = np.empty((n,) + records.MASK_SHAPE, dtype=np.uint8)
    for i, dp in enumerate(ds):
        images[i] = records.deserialize_image(dp["image"])
        raw_masks[i] = records.deserialize_image(dp["mask"], records.MASK_SHAPE)
    masks = records.remap_mask_batch(raw_masks)

    if cache:
        os.makedirs(dataset_loc, exist_ok=True)
        np.savez(cache_file, images=images, masks=masks, raw_masks=raw_masks)
    return ArrayDataset(images, masks, raw_masks if keep_raw_masks else None)


def synthetic_shapes_dataset(
    length: int = 64,
    height: int = 64,
    width: int = 64,
    seed: int = 0,
) -> ArrayDataset:
    """Learnable fixture: a reddish ellipse (class 1, "cat") and/or a bluish
    rectangle (class 2, "dog") on a textured background, with exact masks."""
    rng = np.random.default_rng(seed)
    images = np.empty((length, height, width, 3), np.uint8)
    masks = np.zeros((length, height, width), np.uint8)
    yy, xx = np.mgrid[0:height, 0:width]
    for i in range(length):
        img = rng.integers(60, 120, (height, width, 3)).astype(np.float64)
        if rng.random() < 0.8:  # ellipse (class 1)
            cy, cx = rng.uniform(0.25, 0.75, 2) * (height, width)
            ry, rx = rng.uniform(0.1, 0.25, 2) * (height, width)
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            img[inside] = [210 + rng.integers(-20, 20), 70, 70]
            masks[i][inside] = records.CAT_ID
        if rng.random() < 0.8:  # rectangle (class 2)
            y0, x0 = rng.integers(0, height // 2), rng.integers(0, width // 2)
            hh, ww = rng.integers(height // 8, height // 3), rng.integers(
                width // 8, width // 3
            )
            box = np.zeros((height, width), bool)
            box[y0 : y0 + hh, x0 : x0 + ww] = True
            img[box] = [70, 70, 210 + rng.integers(-20, 20)]
            masks[i][box] = records.DOG_ID
        images[i] = np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(
            np.uint8
        )
    return ArrayDataset(images, masks)


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
