"""Point prompts from palette masks; counterpart of
``image_segmentation_tpu/data/prompts.py`` (palette_to_class_masks :31,
make_prompt_batch :39).

Per image: a class among (cat, dog, background) weighted by its pixel
count, where background is everything that is neither cat nor dog; a pixel
of that class, uniformly; a 2-D Gaussian heatmap around it (or a single
1.0 with ``gaussian_sigma=None``); the label is the chosen class's binary
mask.  When the chosen class has no pixels the point is the centre pixel
(``(h // 2, w // 2)``, :61-62).

Sampling is split from applying.  :func:`sample_prompt_draws` draws two
uniforms per image on the host (:class:`PromptDraws`: one picks the class,
one the pixel); :func:`prompt_points` turns them into ``(choice, cy, cx)``
on the device from the masks' pixel counts and a cumulative sum, with no
per-pixel random numbers and no device-to-host copy; :func:`prompt_maps`
turns a point into ``(heat, label)``.  The JAX function draws the class by
``jax.random.categorical`` on the log counts and the pixel by a masked
argmax of per-pixel uniforms; the distributions are the same, the numbers
are not, so the tests feed JAX's own choice and point to
:func:`prompt_maps`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .datasets import CAT_PALETTE, DOG_PALETTE


def palette_to_class_masks(raw_masks_u8: torch.Tensor):
    """(B, H, W) palette uint8 -> (cat, dog, bg) float32 masks."""
    cat = (raw_masks_u8 == CAT_PALETTE).float()
    dog = (raw_masks_u8 == DOG_PALETTE).float()
    return cat, dog, 1.0 - (cat + dog)


@dataclasses.dataclass(frozen=True)
class PromptDraws:
    """The random draws of one batch's prompts: per image a uniform in [0,
    1) for the class and one for the pixel."""

    u_class: torch.Tensor  # (n,) fp32
    u_pixel: torch.Tensor  # (n,) fp32

    def to(self, device, non_blocking: bool = False) -> "PromptDraws":
        return PromptDraws(self.u_class.to(device, non_blocking=non_blocking),
                           self.u_pixel.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "PromptDraws":
        return PromptDraws(self.u_class.pin_memory(), self.u_pixel.pin_memory())

    def rows(self, rows: slice) -> "PromptDraws":
        """The draws of the images ``rows`` of the batch."""
        return PromptDraws(self.u_class[rows], self.u_pixel[rows])


def sample_prompt_draws(n: int, generator: torch.Generator) -> PromptDraws:
    """The draws of n images, on the generator's device."""
    u = torch.rand((2, n), generator=generator, device=generator.device)
    return PromptDraws(u[0], u[1])


def _class_stack(raw_masks_u8: torch.Tensor) -> torch.Tensor:
    return torch.stack(palette_to_class_masks(raw_masks_u8), dim=1)  # (B, 3, H, W)


def prompt_points(raw_masks_u8: torch.Tensor, draws: PromptDraws):
    """``(choice, cy, cx)``, each (B,) int64, on the masks' device: the
    class c with ``cum[c-1] <= u_class * total < cum[c]`` over the pixel
    counts (a class without pixels is never chosen), then the
    ``floor(u_pixel * count)``-th pixel of that class in row-major order."""
    b, h, w = raw_masks_u8.shape
    masks = _class_stack(raw_masks_u8).reshape(b, 3, h * w)
    cum = masks.sum(-1).cumsum(-1)                                  # (B, 3)
    u_class = draws.u_class.to(cum.device, torch.float32)[:, None]
    choice = (cum <= u_class * cum[:, -1:]).sum(-1).clamp(max=2)    # (B,)
    sel = masks[torch.arange(b, device=masks.device), choice]       # (B, H*W)
    count = sel.sum(-1)
    k = (draws.u_pixel.to(cum.device, torch.float32) * count).floor()
    k = torch.minimum(k, (count - 1).clamp(min=0)).long()
    idx = torch.searchsorted(sel.cumsum(-1), k[:, None].float(), right=True)[:, 0]
    has_pixels = count > 0
    cy = torch.where(has_pixels, idx // w, torch.full_like(idx, h // 2))
    cx = torch.where(has_pixels, idx % w, torch.full_like(idx, w // 2))
    return choice, cy, cx


def prompt_maps(
    raw_masks_u8: torch.Tensor,
    choice: torch.Tensor,
    cy: torch.Tensor,
    cx: torch.Tensor,
    gaussian_sigma: Optional[float] = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(heat (B, H, W, 1) fp32, label (B, H, W) fp32) of the points: the
    heatmap ``exp(-(dx^2 + dy^2) / (2 sigma^2))`` or one-hot, the label the
    chosen class's mask.  A chosen class without pixels puts the point at
    the centre, whatever ``cy, cx`` say (make_prompt_batch :55-62)."""
    b, h, w = raw_masks_u8.shape
    masks = _class_stack(raw_masks_u8)
    dev = masks.device
    sel = masks[torch.arange(b, device=dev), choice.to(dev)]         # (B, H, W)
    has_pixels = sel.reshape(b, -1).amax(-1) > 0
    cy = torch.where(has_pixels, cy.to(dev), h // 2).float()[:, None, None]
    cx = torch.where(has_pixels, cx.to(dev), w // 2).float()[:, None, None]
    dy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] - cy
    dx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] - cx
    if gaussian_sigma is not None:
        heat = torch.exp(-(dx * dx + dy * dy) / (2.0 * gaussian_sigma ** 2))
    else:
        heat = ((dy == 0) & (dx == 0)).float()
    return heat[..., None], sel


def make_prompt_batch(
    raw_masks_u8: torch.Tensor,
    draws: PromptDraws,
    gaussian_sigma: Optional[float] = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prompt maps (B, H, W, 1) fp32, labels (B, H, W) fp32) of a palette
    mask batch for the given draws."""
    return prompt_maps(raw_masks_u8, *prompt_points(raw_masks_u8, draws), gaussian_sigma)
