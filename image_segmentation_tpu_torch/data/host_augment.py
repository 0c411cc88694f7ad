"""Host-side per-item augmentation (reference ``CustomImageDatasetRobust``);
counterpart of ``image_segmentation_tpu/data/host_augment.py``, copied
whole (numpy only).

The reference keeps a CPU-side augmentation variant
(customDatasets/datasets.py:331-414): torchvision-v2 RandomHorizontalFlip +
RandomRotation(90) applied with a shared seed to image and mask, plus
image-only ColorJitter(0.4, 0.3, 0.2, 0.2) and GaussianBlur(kernel 21), with
every (aug+1)-th index left clean (datasets.py:411-412).

The on-device augmentor (ops/augment.py) is the production path; this numpy
implementation exists for capability parity and for hosts that want to
pre-augment offline; no Trainer calls it.  Geometry is shared between image
and mask via one RNG draw (the reference's shared-seed trick,
datasets.py:369-382).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _rotate_nearest(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """Nearest-neighbour rotation about the centre, zero fill.  img: HW[C]."""
    h, w = img.shape[:2]
    theta = np.deg2rad(angle_deg)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = np.meshgrid(
        np.arange(h, dtype=np.float64) - cy,
        np.arange(w, dtype=np.float64) - cx,
        indexing="ij",
    )
    cos, sin = np.cos(theta), np.sin(theta)
    src_x = cos * xx - sin * yy + cx
    src_y = sin * xx + cos * yy + cy
    sy = np.rint(src_y).astype(np.int64)
    sx = np.rint(src_x).astype(np.int64)
    valid = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
    sy = np.clip(sy, 0, h - 1)
    sx = np.clip(sx, 0, w - 1)
    out = img[sy, sx]
    out[~valid] = 0
    return out


def _gaussian_blur(img: np.ndarray, kernel: int = 21, sigma: float = None) -> np.ndarray:
    """Separable Gaussian blur with reflect padding.  img: HWC float."""
    if sigma is None:
        # torchvision default: sigma = 0.3*((k-1)*0.5 - 1) + 0.8
        sigma = 0.3 * ((kernel - 1) * 0.5 - 1) + 0.8
    r = kernel // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    p = np.pad(img, ((r, r), (0, 0), (0, 0)), mode="reflect")
    out = sum(p[i : i + img.shape[0]] * k[i] for i in range(kernel))
    p = np.pad(out, ((0, 0), (r, r), (0, 0)), mode="reflect")
    out = sum(p[:, i : i + img.shape[1]] * k[i] for i in range(kernel))
    return out


GRAY = np.array([0.299, 0.587, 0.114])


def robust_transform_item(
    rng: np.random.Generator,
    image_u8: np.ndarray,
    mask_u8: np.ndarray,
    *,
    max_degrees: float = 90.0,
    brightness: float = 0.4,
    contrast: float = 0.3,
    saturation: float = 0.2,
    hue: float = 0.2,
    blur_kernel: int = 21,
) -> Tuple[np.ndarray, np.ndarray]:
    """One augmented (image, mask) pair; geometry shared, colour image-only."""
    img = image_u8.astype(np.float64) / 255.0
    mask = mask_u8

    if rng.random() < 0.5:
        img = img[:, ::-1]
        mask = mask[:, ::-1]
    angle = rng.uniform(-max_degrees, max_degrees)
    img = _rotate_nearest(img, angle)
    mask = _rotate_nearest(mask, angle)

    # colour jitter (torchvision factor semantics, fixed op order)
    img = np.clip(img * rng.uniform(1 - brightness, 1 + brightness), 0, 1)
    fc = rng.uniform(1 - contrast, 1 + contrast)
    gray_mean = (img @ GRAY).mean()
    img = np.clip(fc * img + (1 - fc) * gray_mean, 0, 1)
    fs = rng.uniform(1 - saturation, 1 + saturation)
    gray = (img @ GRAY)[..., None]
    img = np.clip(fs * img + (1 - fs) * gray, 0, 1)
    # hue via simple channel-rotation approximation is avoided; do exact HSV
    fh = rng.uniform(-hue, hue)
    img = _hue_shift(img, fh)

    img = _gaussian_blur(img, blur_kernel)
    out_u8 = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
    return out_u8, mask.astype(np.uint8)


def _hue_shift(rgb: np.ndarray, shift: float) -> np.ndarray:
    import colorsys  # noqa: F401  (documenting intent; vectorized below)

    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    safe = np.maximum(delta, 1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = np.where(maxc == r, bc - gc, np.where(maxc == g, 2 + rc - bc, 4 + gc - rc))
    h = np.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    h = (h + shift) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.astype(int) % 6
    conds = [i == k for k in range(6)]
    r2 = np.select(conds, [v, q, p, p, t, v])
    g2 = np.select(conds, [t, v, v, q, p, p])
    b2 = np.select(conds, [p, p, t, v, v, q])
    return np.stack([r2, g2, b2], axis=-1)


def robust_augment_epoch(
    dataset,
    augmentations_per_datapoint: int = 2,
    seed: int = 0,
):
    """Iterate (image_u8, mask_u8) per VIRTUAL index with every
    (aug+1)-th index clean — CustomImageDatasetRobust.__getitem__ semantics
    (datasets.py:404-414)."""
    rep = augmentations_per_datapoint + 1
    rng = np.random.default_rng(seed)
    for idx in range(len(dataset) * rep):
        base = idx // rep
        img, mask = dataset.images[base], dataset.masks[base]
        if idx % rep != 0:
            img, mask = robust_transform_item(rng, img, mask)
        yield img, mask
