"""The robustness battery; counterpart of
``image_segmentation_tpu/data/perturbations.py`` (INT_SWEEPS :192,
FLOAT_SWEEPS :329).

Two batteries, as in the reference:

1. integer space (``INT_SWEEPS``): uint8 NHWC in, uint8 out, with the
   reference's round and clamp at every step; it produces
   ``results/robustness_scores.csv``;
2. float space (``FLOAT_SWEEPS``): [0, 1] float NHWC in and out, the
   reference's ``nn.Module`` corruptions; it produces
   ``augmentation-results/<name>.csv``.

Drawing is split from applying, as ``AugmentParams`` splits the augmentor
(``ops/augment.py``).  Each random family has a ``sample_*`` that takes an
explicit CPU ``torch.Generator`` and returns its draws, and an applying
function that is deterministic given them, on any device; the CPU tests
feed the applying half JAX's own draws (``jax.random`` inside each JAX
function: :46, :107, :145, :253, :301, :320).  A registry entry holds
``params`` (the JAX grid, the same Python values, which the CSVs carry),
``apply(images, param, draws)``, ``sample(shape, param, generator)`` (None
for a deterministic family) and ``per_point``: whether the draws depend on
the point (occlusion's bounds do), else one draw serves every point.

What JAX does, kept op for op in float32:

- every sweep parameter is rounded to float32 first, as the Evaluator's
  ``jnp.float32(param)`` (``engine/evaluate.py:159, 249-251``): in float64
  ``round(30 * 1.05)`` is 32, in float32 it is 31;
- rounding is half to even (``torch.round``, as ``jnp.round``);
- noise clamps then rounds (:49); contrast and blur round then clamp (:64,
  :93); brightness increase clamps then rounds, decrease rounds then
  clamps (:96-104);
- the integer blur pads with zeros (:55), the float blur reflects (:261);
  both sum the 9 taps in (dy, dx) order and divide by 9; the port runs
  exactly ``p`` passes, which is what JAX's masked ``max_passes`` loop
  (there only to share one compiled program, :75-88) computes;
- occlusion: ``randint(0, max(h - size + 1, 1))`` (integer, :116-130)
  and ``randint(0, max(h - size, 0) + 1)`` (float, :305-316) are the same
  bound; only the integer battery skips a square that does not fit;
- integer salt-and-pepper (:145-181): ``round(float32(amount) * H * W)``
  live draws of ``int(round(max_amount * H * W))``, each a pixel and a
  coin, whole channels set to 0 or 255, the last draw at a pixel winning:
  ``scatter_reduce(..., "amax")`` of the draw index, then a gather of that
  draw's coin (a plain scatter with repeated indices is not deterministic
  on CUDA);
- float salt-and-pepper draws ``u`` of shape (n, 1, h, w) and transposes
  it (:322); at amount 0 the image comes back unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Draws = Optional[Tuple[torch.Tensor, ...]]


def f32(param) -> torch.Tensor:
    """A sweep parameter as JAX's ``jnp.float32(param)``: a 0-d float32
    CPU tensor, rounded from the Python value once.  It combines with
    tensors on any device as a scalar, and arithmetic on it alone (``/
    255.0``) stays a float32 division on the host."""
    return torch.tensor(np.float32(param))


def _size(param) -> int:
    """A square size as ``jnp.round(size).astype(int32)``, from float32."""
    return int(np.round(np.float32(param)))


# ---------------------------------------------------------------------------
# samplers: CPU generator in, draws out (moved to the images' device by the
# caller)
# ---------------------------------------------------------------------------


def sample_normal(shape: Sequence[int], generator: torch.Generator) -> Tuple[torch.Tensor]:
    """Standard normal float32 draws of the image shape (both noise
    families)."""
    return (torch.randn(tuple(shape), generator=generator),)


def sample_occlusion(shape: Sequence[int], size, generator: torch.Generator
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-left corners ``(y0, x0)`` (int64, one per image) of the squares
    of side ``round(size)``, each uniform in ``[0, max(dim - size + 1, 1))``."""
    n, h, w = shape[:3]
    s = _size(size)
    y0 = torch.randint(0, max(h - s + 1, 1), (n,), generator=generator)
    x0 = torch.randint(0, max(w - s + 1, 1), (n,), generator=generator)
    return y0, x0


def salt_pepper_max_draws(h: int, w: int, max_amount: float) -> int:
    """Draws made per image: ``int(round(max_amount * H * W))`` (:164)."""
    return int(round(float(max_amount) * h * w))


def sample_salt_pepper(shape: Sequence[int], max_amount: float, generator: torch.Generator
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pos, salt)`` of every draw a point up to ``max_amount`` uses:
    flat pixel indices (int64, uniform in [0, H*W)) and coins (bool, salt
    with p = 1/2), each (n, max_draws)."""
    n, h, w = shape[:3]
    m = salt_pepper_max_draws(h, w, max_amount)
    pos = torch.randint(0, h * w, (n, m), generator=generator)
    salt = torch.rand((n, m), generator=generator) < 0.5
    return pos, salt


def sample_uniform_map(shape: Sequence[int], generator: torch.Generator) -> Tuple[torch.Tensor]:
    """Float salt-and-pepper's uniforms, (n, 1, h, w) as JAX draws them."""
    n, h, w = shape[:3]
    return (torch.rand((n, 1, h, w), generator=generator),)


# ---------------------------------------------------------------------------
# integer-space battery: uint8 NHWC in -> uint8 NHWC out
# ---------------------------------------------------------------------------


def gaussian_pixel_noise(images_u8: torch.Tensor, std, z: torch.Tensor) -> torch.Tensor:
    """u8 + z * std, clamped then rounded (:46-50)."""
    noisy = images_u8.float() + z * f32(std)
    return torch.round(torch.clamp(noisy, 0, 255)).to(torch.uint8)


def _box_sum(p: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The 9 taps of a padded NHWC map summed from zero in (dy, dx) order."""
    acc = torch.zeros_like(p[:, 1:h + 1, 1:w + 1])
    for dy in range(3):
        for dx in range(3):
            acc = acc + p[:, dy:dy + h, dx:dx + w]
    return acc


def box_blur_passes(images_u8: torch.Tensor, num_passes) -> torch.Tensor:
    """``num_passes`` x (3x3 box filter, zero padding, round, clamp)
    (:53-72)."""
    out = images_u8
    h, w = images_u8.shape[1:3]
    for _ in range(int(num_passes)):
        p = F.pad(out.float(), (0, 0, 1, 1, 1, 1))
        out = torch.clamp(torch.round(_box_sum(p, h, w) / 9.0), 0, 255).to(torch.uint8)
    return out


def contrast_scale(images_u8: torch.Tensor, factor) -> torch.Tensor:
    """u8 * float32(factor), rounded then clamped (:91-93)."""
    scaled = images_u8.float() * f32(factor)
    return torch.clamp(torch.round(scaled), 0, 255).to(torch.uint8)


def brightness_shift(images_u8: torch.Tensor, offset, *, increase: bool = True) -> torch.Tensor:
    """Brightness +/- offset: increase clamps then rounds, decrease rounds
    then clamps (:96-104)."""
    x = images_u8.float()
    off = f32(offset)
    if increase:
        return torch.round(torch.clamp(x + off, 0, 255)).to(torch.uint8)
    return torch.clamp(torch.round(x - off), 0, 255).to(torch.uint8)


def _square(shape, size: int, y0: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """(n, h, w, 1) bool: inside each image's square [y0, y0+size) x
    [x0, x0+size); empty for size <= 0."""
    n, h, w = shape[:3]
    yy = torch.arange(h, device=y0.device)[None, :, None]
    xx = torch.arange(w, device=y0.device)[None, None, :]
    y0, x0 = y0[:, None, None], x0[:, None, None]
    inside = (yy >= y0) & (yy < y0 + size) & (xx >= x0) & (xx < x0 + size)
    return inside[..., None]


def occlusion(images_u8: torch.Tensor, size, y0: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Black square per image (:107-131); a square of side >= H or W is
    skipped, as the reference skips it."""
    h, w = images_u8.shape[1:3]
    s = _size(size)
    if not (s < h and s < w):
        return images_u8
    inside = _square(images_u8.shape, s, y0, x0)
    return torch.where(inside, torch.zeros((), dtype=torch.uint8, device=images_u8.device),
                       images_u8)


def salt_pepper_draws(images_u8: torch.Tensor, amount, pos: torch.Tensor,
                      salt: torch.Tensor) -> torch.Tensor:
    """Salt-and-pepper with the reference's with-replacement semantics
    (:145-181): the first ``round(float32(amount) * H * W)`` draws of
    ``(pos, salt)`` are live; at each pixel the live draw of the largest
    index sets every channel to 255 (salt) or 0."""
    n, h, w, c = images_u8.shape
    hw = h * w
    num = int(np.round(np.float32(amount) * np.float32(hw)))
    draw_idx = torch.arange(pos.shape[1], device=pos.device)
    live_pos = torch.where(draw_idx[None] < num, pos, hw)  # dead draws land on slot hw
    best = torch.full((n, hw + 1), -1, dtype=torch.int64, device=pos.device)
    best = best.scatter_reduce(1, live_pos, draw_idx.expand(n, -1), "amax")[:, :hw]
    winner = torch.gather(salt, 1, best.clamp(min=0))
    pix = torch.where(winner, 255, 0).to(torch.uint8)
    flat = images_u8.reshape(n, hw, c)
    out = torch.where((best >= 0)[..., None], pix[..., None], flat)
    return out.reshape(images_u8.shape)


# ---------------------------------------------------------------------------
# float-space battery: [0, 1] float NHWC in and out
# ---------------------------------------------------------------------------


def float_gaussian_noise(images: torch.Tensor, std, z: torch.Tensor) -> torch.Tensor:
    """images + z * (std / 255), clipped to [0, 1]; std in integer units
    (:250-254)."""
    return torch.clamp(images + z * (f32(std) / 255.0), 0.0, 1.0)


def float_repeated_blur(images: torch.Tensor, times) -> torch.Tensor:
    """``times`` x (3x3 box filter, reflect padding, no rounding)
    (:257-278)."""
    out = images
    h, w = images.shape[1:3]
    for _ in range(int(times)):
        p = F.pad(out.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)
        out = _box_sum(p, h, w) / 9.0
    return out


def float_contrast(images: torch.Tensor, factor) -> torch.Tensor:
    return torch.clamp(images * f32(factor), 0.0, 1.0)


def float_brightness(images: torch.Tensor, offset) -> torch.Tensor:
    """images + offset / 255, clipped; offset in integer units (:293-295)."""
    return torch.clamp(images + f32(offset) / 255.0, 0.0, 1.0)


def float_occlusion(images: torch.Tensor, size, y0: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Black square per image, clipped to the image; no fit test
    (:298-317)."""
    inside = _square(images.shape, _size(size), y0, x0)
    return torch.where(inside, torch.zeros((), dtype=images.dtype, device=images.device), images)


def float_salt_pepper(images: torch.Tensor, amount, u: torch.Tensor) -> torch.Tensor:
    """Per-pixel salt (1) where u < amount/2, pepper (0) where
    u > 1 - amount/2, from ``u`` of shape (n, 1, h, w) (:320-326)."""
    a = f32(amount)
    u = u.permute(0, 2, 3, 1)
    salt = (u < a / 2.0).to(images.dtype)
    pepper = (u > 1.0 - a / 2.0).to(images.dtype)
    return images * (1.0 - salt - pepper) + salt


# ---------------------------------------------------------------------------
# the sweep registries (scripts/robustness_evaluation.py:59-92 and
# model_wrappers.py:524-764 grids)
# ---------------------------------------------------------------------------

_INT_BLUR_PARAMS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9]
_FLOAT_BLUR_PARAMS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9]
_INT_SP_PARAMS = [0.00, 0.02, 0.04, 0.06, 0.08, 0.10, 0.12, 0.14, 0.16, 0.18]
SP_MAX_AMOUNT = max(_INT_SP_PARAMS)


def _noise(shape, p, g):
    return sample_normal(shape, g)


def _entry(params, apply, sample=None, per_point=False) -> dict:
    return dict(params=params, apply=apply, sample=sample, random=sample is not None,
                per_point=per_point)


INT_SWEEPS: Dict[str, dict] = {
    "gaussian_noise": _entry([0, 2, 4, 6, 8, 10, 12, 14, 16, 18],
                             lambda img, p, d: gaussian_pixel_noise(img, p, *d), _noise),
    "gaussian_blur": _entry(_INT_BLUR_PARAMS, lambda img, p, d: box_blur_passes(img, p)),
    "contrast_increase": _entry([1.0, 1.01, 1.02, 1.03, 1.04, 1.05, 1.1, 1.15, 1.2, 1.25],
                                lambda img, p, d: contrast_scale(img, p)),
    "contrast_decrease": _entry([1.0, 0.95, 0.9, 0.85, 0.8, 0.6, 0.4, 0.3, 0.2, 0.1],
                                lambda img, p, d: contrast_scale(img, p)),
    "brightness_increase": _entry([0, 5, 10, 15, 20, 25, 30, 35, 40, 45],
                                  lambda img, p, d: brightness_shift(img, p, increase=True)),
    "brightness_decrease": _entry([0, 5, 10, 15, 20, 25, 30, 35, 40, 45],
                                  lambda img, p, d: brightness_shift(img, p, increase=False)),
    "occlusion": _entry([0, 5, 10, 15, 20, 25, 30, 35, 40, 45],
                        lambda img, p, d: occlusion(img, p, *d),
                        lambda shape, p, g: sample_occlusion(shape, p, g), per_point=True),
    "salt_pepper_noise": _entry(_INT_SP_PARAMS, lambda img, p, d: salt_pepper_draws(img, p, *d),
                                lambda shape, p, g: sample_salt_pepper(shape, SP_MAX_AMOUNT, g)),
}

FLOAT_SWEEPS: Dict[str, dict] = {
    "gaussian_noise": _entry([1e-6, 2, 4, 6, 8, 10, 12, 14, 16, 18],
                             lambda img, p, d: float_gaussian_noise(img, p, *d), _noise),
    "blur": _entry(_FLOAT_BLUR_PARAMS, lambda img, p, d: float_repeated_blur(img, p)),
    "contrast_increase": _entry([1.0, 1.01, 1.02, 1.03, 1.04, 1.05, 1.1, 1.15, 1.2, 1.25],
                                lambda img, p, d: float_contrast(img, p)),
    "contrast_decrease": _entry([1.0, 0.95, 0.90, 0.85, 0.80, 0.60, 0.40, 0.30, 0.20, 0.10],
                                lambda img, p, d: float_contrast(img, p)),
    "brightness_increase": _entry([0, 5, 10, 15, 20, 25, 30, 35, 40, 45],
                                  lambda img, p, d: float_brightness(img, p)),
    "brightness_decrease": _entry([0, 5, 10, 15, 20, 25, 30, 35, 40, 45],
                                  lambda img, p, d: float_brightness(img, -np.float32(p))),
    "occlusion": _entry([0, 5, 10, 15, 20, 25, 30, 35, 40, 45],
                        lambda img, p, d: float_occlusion(img, p, *d),
                        lambda shape, p, g: sample_occlusion(shape, p, g), per_point=True),
    "salt_pepper": _entry([0.00, 0.02, 0.04, 0.06, 0.08, 0.10, 0.12, 0.14, 0.16],
                          lambda img, p, d: float_salt_pepper(img, p, *d),
                          lambda shape, p, g: sample_uniform_map(shape, g)),
}

SWEEPS = {"int": INT_SWEEPS, "float": FLOAT_SWEEPS}


def sample(kind: str, name: str, shape: Sequence[int], param, generator: torch.Generator) -> Draws:
    """The draws of one point of a family for a batch of ``shape`` (NHWC),
    on the CPU; None for a deterministic family."""
    fn = SWEEPS[kind][name]["sample"]
    return None if fn is None else fn(tuple(shape), param, generator)


def apply(kind: str, name: str, images: torch.Tensor, param, draws: Draws) -> torch.Tensor:
    """One point of a family on a batch, given its draws (on the images'
    device)."""
    return SWEEPS[kind][name]["apply"](images, param, draws)


def apply_perturbation(name: str, images_u8: torch.Tensor, param,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One named integer-space perturbation of a uint8 batch, its draws
    made from ``generator`` (default: seeded 0) on the host and moved to
    the batch's device (JAX :236)."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    draws = sample("int", name, images_u8.shape, param, g)
    if draws is not None:
        draws = tuple(d.to(images_u8.device) for d in draws)
    return apply("int", name, images_u8, param, draws)
