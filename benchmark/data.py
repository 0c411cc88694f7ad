"""Synthetic pet photos and their masks, made on the device from the seed.

Each image holds one or two elliptical pets, each a cat or a dog, on a
background of a smooth colour gradient with pixel noise; each pet has its
own colour, shading and noise.  The masks hold the class ids the
segmentation task trains on (0 background, 1 cat, 2 dog: the Oxford-IIIT
Pet trimap with its uncertain border taken as background).  The same seed
gives the same batches; every seed gives the same sizes.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

CAT, DOG = 1, 2


def pet_batch(n: int, size: int, gen: torch.Generator, device) -> Tuple[torch.Tensor,
                                                                          torch.Tensor]:
    """(images (n, size, size, 3) uint8, class-id masks (n, size, size) uint8)."""
    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    yy = torch.linspace(0.0, 1.0, size, device=device).view(1, size, 1)
    xx = torch.linspace(0.0, 1.0, size, device=device).view(1, 1, size)
    # background: a colour per image, a gradient across it, noise
    base = u(n, 1, 1, 3, lo=0.1, hi=0.9)
    tilt = u(n, 1, 1, 3, lo=-0.3, hi=0.3)
    dirn = u(n, 1, 1, lo=0.0, hi=2 * math.pi)
    ramp = (torch.cos(dirn) * yy + torch.sin(dirn) * xx)[..., None]
    img = base + tilt * ramp + 0.06 * torch.randn((n, size, size, 3), generator=gen, device=device)
    mask = torch.zeros((n, size, size), dtype=torch.uint8, device=device)
    present = torch.ones(n, dtype=torch.bool, device=device)
    for slot in range(2):
        if slot:
            present = u(n) < 0.5
        cy, cx = u(n, lo=0.25, hi=0.75), u(n, lo=0.25, hi=0.75)
        ry, rx = u(n, lo=0.10, hi=0.28), u(n, lo=0.10, hi=0.28)
        th = u(n, lo=0.0, hi=math.pi)
        dog = u(n) < 0.5
        dy, dx = yy - cy.view(-1, 1, 1), xx - cx.view(-1, 1, 1)
        c, s = torch.cos(th).view(-1, 1, 1), torch.sin(th).view(-1, 1, 1)
        r2 = ((c * dx + s * dy) / rx.view(-1, 1, 1)) ** 2 + ((-s * dx + c * dy) / ry.view(-1, 1, 1)) ** 2
        inside = (r2 <= 1.0) & present.view(-1, 1, 1)
        colour = u(n, 1, 1, 3, lo=0.05, hi=0.95)
        shade = (1.0 - 0.35 * r2.clamp(max=1.0))[..., None]
        fur = 0.08 * torch.randn((n, size, size, 3), generator=gen, device=device)
        img = torch.where(inside[..., None], colour * shade + fur, img)
        label = torch.where(dog, DOG, CAT).to(torch.uint8).view(-1, 1, 1)
        mask = torch.where(inside, label.expand_as(mask), mask)
    images = (img.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8)
    return images, mask


def make_pool(batches: int, n: int, size: int, seed: int,
              device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``batches`` distinct batches of n pets from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63) ^ 0x5EED)
    return [pet_batch(n, size, gen, device) for _ in range(batches)]
