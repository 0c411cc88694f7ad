"""Input normalisation and the on-device batch augmentor; counterpart of
``image_segmentation_tpu/ops/augment.py`` (normalize_image :35, the
geometry :45-319, the colour ops :335-461, DataAugmentor :482-568,
DataAugmentorPrompt :571-657).

Per sample: a horizontal flip (p = 0.5) and a rotation by an angle drawn
from U(-90, 90) degrees, nearest resampling with zero fill, applied to the
image and its mask together; then, on the image only, colour jitter
(brightness, contrast, saturation, hue in a fixed order) and a 5x5
Gaussian blur; every (augmentations_per_datapoint + 1)-th batch position
keeps its clean value.

Sampling is split from applying.  :meth:`DataAugmentor.sample` draws an
:class:`AugmentParams` from an explicit ``torch.Generator`` with the JAX
package's distributions; ``apply_u8`` and ``__call__`` are deterministic
functions of the params, so the tests feed them JAX's own draws.  torch
and JAX give different numbers from the same seed: equality with the JAX
package holds for the same params, not the same seed.

The rotation (``geometry="shear3"``) is a quarter turn and three shears,
each a per-row or per-column integer shift; on a uint8 image + mask stack
the four channels are packed into one int32 word per pixel and the shears
run through ``roll.row_shift`` / ``roll.col_shift`` (the kernel
``csrc/shift.cu`` on the card), so whole pixels move and the result equals
the JAX package's bit for bit.  The colour stage is a composition of torch
ops (``backend="xla"``, the JAX package's XLA code) or the fused kernel
``preprocess.preprocess`` (``backend="pallas"``, ``csrc/preprocess.cu`` on
the card).  Both kernels are looked up on their modules at call time.

``DataAugmentorPrompt`` (:572) moves the image, its label mask and the
prompt heatmap together: u8x4 image + mask words and the heatmap's fp32
bits as int32 words go through the shift kernels as one stack
(``apply_geometric_packed``, JAX's ``random_geometric_packed`` :195).

Under a profiler both augmentors record their geometry and their colour
stage as the spans ``augment.geometry`` and ``augment.colour``
(``utils/spans.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils import spans
from . import preprocess as _preprocess
from . import roll

GEOMETRIES = ("shear3", "gather", "two_pass")
BACKENDS = ("xla", "pallas")


def normalize_image(
    images_u8: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """uint8 NHWC -> [0, 1] float, on the tensor's own device."""
    return images_u8.to(dtype) / 255.0


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------

def _uniform(generator: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    """(n,) fp32 ~ U(lo, hi), as ``jax.random.uniform``: u*(hi - lo) + lo,
    at least lo."""
    u = torch.rand(n, generator=generator, device=generator.device)
    return (u * (hi - lo) + lo).clamp(min=lo)


def sample_geometric(n: int, generator: torch.Generator, max_degrees: float = 90.0):
    """Per-sample (flip (n,) bool with p = 0.5, angles (n,) ~ U(-max, max))."""
    flip = torch.rand(n, generator=generator, device=generator.device) < 0.5
    return flip, _uniform(generator, n, -max_degrees, max_degrees)


def sample_jitter_factors(
    n: int,
    generator: torch.Generator,
    brightness: float = 0.4,
    contrast: float = 0.3,
    saturation: float = 0.2,
    hue: float = 0.2,
) -> torch.Tensor:
    """(n, 4) per-sample [brightness, contrast, saturation, hue] factors with
    torchvision semantics: factor ~ U(max(0, 1-x), 1+x); hue ~ U(-hue, hue)."""
    def u(x):
        return _uniform(generator, n, max(0.0, 1.0 - x), 1.0 + x)

    return torch.stack([u(brightness), u(contrast), u(saturation),
                        _uniform(generator, n, -hue, hue)], dim=1)


def sample_blur_weights(
    n: int, generator: torch.Generator, sigma_range: Tuple[float, float] = (0.1, 2.0)
) -> torch.Tensor:
    """(n, 5) normalised 5-tap Gaussian weights, sigma ~ U(lo, hi)."""
    sigma = _uniform(generator, n, *sigma_range)
    x = torch.arange(-2, 3, dtype=torch.float32, device=sigma.device)
    k = torch.exp(-0.5 * (x[None, :] / sigma[:, None]) ** 2)
    return k / k.sum(dim=1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class AugmentParams:
    """The random draws of one augmented batch of n samples."""

    flip: torch.Tensor    # (n,) bool
    angles: torch.Tensor  # (n,) fp32 degrees
    jitter: torch.Tensor  # (n, 4) fp32 [brightness, contrast, saturation, hue]
    blur: torch.Tensor    # (n, 5) fp32 tap weights

    def _map(self, fn) -> "AugmentParams":
        return AugmentParams(*(fn(getattr(self, f.name)) for f in dataclasses.fields(self)))

    def to(self, device, non_blocking: bool = False) -> "AugmentParams":
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "AugmentParams":
        return self._map(lambda t: t.pin_memory())

    def rows(self, rows: slice) -> "AugmentParams":
        """The draws of the samples ``rows`` of the batch."""
        return self._map(lambda t: t[rows])


# --------------------------------------------------------------------------
# geometry (image and mask together)
# --------------------------------------------------------------------------

def _iota(n: int, size: int, device) -> torch.Tensor:
    return torch.arange(size, dtype=torch.float32, device=device).expand(n, size)


def _rotate_nearest_indices(h: int, w: int, angle_deg: torch.Tensor):
    """Inverse-map source indices of a rotation about the image centre, per
    sample: (src_y, src_x, valid), each (n, h, w); nearest (round), valid
    False outside the source (zero fill).  A positive angle turns the
    displayed image counter-clockwise."""
    theta = (angle_deg * (math.pi / 180.0))[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dev = angle_deg.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] - cx
    cos, sin = torch.cos(theta), torch.sin(theta)
    src_x = cos * xx - sin * yy + cx
    src_y = sin * xx + cos * yy + cy
    sy = torch.round(src_y).to(torch.int32)
    sx = torch.round(src_x).to(torch.int32)
    valid = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
    return sy.clamp(0, h - 1), sx.clamp(0, w - 1), valid


def _rotate_gather(stacked: torch.Tensor, angles_deg: torch.Tensor) -> torch.Tensor:
    """Per-sample direct 2-D nearest rotation of an NHWC stack, zero fill
    (``_rotate_one`` :67 over the batch): the exactness oracle."""
    n, h, w, c = stacked.shape
    sy, sx, valid = _rotate_nearest_indices(h, w, angles_deg)
    idx = (sy.long() * w + sx.long()).view(n, h * w, 1).expand(n, h * w, c)
    out = torch.gather(stacked.reshape(n, h * w, c), 1, idx).view(n, h, w, c)
    return torch.where(valid[..., None], out, torch.zeros((), dtype=stacked.dtype, device=stacked.device))


def _quarter_turn(stacked: torch.Tensor, quarter: torch.Tensor) -> torch.Tensor:
    """Per-sample turn by ``quarter`` * 90 degrees (visually counter-clockwise
    for +1, y pointing down), for quarter in {-1, 0, 1}; square images."""
    x_t = stacked.transpose(1, 2)
    q = quarter.view(-1, *([1] * (stacked.dim() - 1)))
    return torch.where(q == 1, x_t.flip(1), torch.where(q == -1, x_t.flip(2), stacked))


def _rotate_two_pass(stacked: torch.Tensor, angles_deg: torch.Tensor) -> torch.Tensor:
    """Per-sample nearest rotation as a quarter turn and two single-axis
    gathers, R(theta) = R(phi) o R(90 k), |phi| <= 45 (:75-128)."""
    n, h, w, c = stacked.shape
    if h != w:
        return _rotate_gather(stacked, angles_deg)
    quarter = torch.round(angles_deg / 90.0)
    phi = (angles_deg - quarter * 90.0) * (math.pi / 180.0)
    base = _quarter_turn(stacked, quarter)
    zero = torch.zeros((), dtype=stacked.dtype, device=stacked.device)

    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos = torch.cos(phi)[:, None, None]
    sin = torch.sin(phi)[:, None, None]
    tan = (torch.sin(phi) / torch.cos(phi))[:, None, None]
    yy = torch.arange(h, dtype=torch.float32, device=stacked.device)[None, :, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=stacked.device)[None, None, :] - cx

    # pass 1 (gather along H): tmp[y, x] = base[tan*x'' + y''/cos + cy, x]
    iy = torch.round(tan * xx + yy / cos + cy).to(torch.int32)
    valid1 = (iy >= 0) & (iy < h)
    idx1 = iy.clamp(0, h - 1).long()[..., None].expand(n, h, w, c)
    tmp = torch.where(valid1[..., None], torch.gather(base, 1, idx1), zero)
    # pass 2 (gather along W): out[y, x] = tmp[y, cos*x'' - sin*y'' + cx]
    ix = torch.round(cos * xx - sin * yy + cx).to(torch.int32)
    valid2 = (ix >= 0) & (ix < w)
    idx2 = ix.clamp(0, w - 1).long()[..., None].expand(n, h, w, c)
    return torch.where(valid2[..., None], torch.gather(tmp, 2, idx2), zero)


def _row_shift(x: torch.Tensor, shifts: torch.Tensor, max_shift: int) -> torch.Tensor:
    """``out[n, i, j] = x[n, i, j - shifts[n, i]]``, zero fill, for
    ``|shift| <= max_shift``: the shift's binary digits applied as static
    rolls of a zero-padded row, each selected per row (:149-173)."""
    w = x.shape[2]
    m = int(max_shift)
    p = w + 2 * m
    xp = F.pad(x, (0, 0, m, m))
    # roll(xp, r)[j] = xp[j - r];  out[j] = xp[m + j - s]  =>  r = s - m
    t = (shifts.to(torch.int32) - m) % p
    out = xp
    bit = 1
    while bit < p:
        take = ((t & bit) > 0)[..., None, None]
        out = torch.where(take, torch.roll(out, bit, dims=2), out)
        bit <<= 1
    return out[:, :, :w, :]


def _shear3_shifts(angles_deg: torch.Tensor, n: int, h: int, w: int):
    """Quarter-turn count and the two per-row shift tables (n, h) and (n, w)
    of the three-shear rotation, in fp32 as the JAX package computes them
    (``torch.round`` rounds half to even, as ``jnp.round``)."""
    quarter = torch.round(angles_deg / 90.0)
    phi = (angles_deg - quarter * 90.0) * (math.pi / 180.0)
    a = -torch.tan(phi / 2.0)   # |a| <= tan(22.5 deg)
    b = torch.sin(phi)          # |b| <= sin(45 deg)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rows = _iota(n, h, angles_deg.device)
    cols = _iota(n, w, angles_deg.device)
    # ShearX: src_x = x + a*(y - cy); ShearY: src_y = y + b*(x - cx); the
    # shifts move out[j] = in[j - s], so s = -round(a*(y - cy)) etc.
    sx = -torch.round(a[:, None] * (rows - cy)).to(torch.int32)
    sy = -torch.round(b[:, None] * (cols - cx)).to(torch.int32)
    return quarter, sx, sy


def _rotate_shear3(stacked: torch.Tensor, angles_deg: torch.Tensor) -> torch.Tensor:
    """Per-sample nearest rotation as a quarter turn and three shears,
    R(phi) = ShearX(a) o ShearY(b) o ShearX(a) with a = -tan(phi/2),
    b = sin(phi) (:239-286).  A uint8 stack of 4 channels runs packed as
    int32 through the shift kernels; other stacks take the roll form."""
    n, h, w, c = stacked.shape
    if h != w:
        return _rotate_gather(stacked, angles_deg)
    quarter, sx, sy = _shear3_shifts(angles_deg, n, h, w)
    base = _quarter_turn(stacked, quarter)
    if stacked.dtype == torch.uint8 and c == 4:
        out = roll.row_shift(roll.pack_u8x4(base), sx)
        out = roll.col_shift(out, sy)
        return roll.unpack_u8x4(roll.row_shift(out, sx))
    mx = math.ceil(math.tan(math.pi / 8) * max(h, w) / 2) + 2
    my = math.ceil(math.sin(math.pi / 4) * max(h, w) / 2) + 2
    out = _row_shift(base, sx, mx)
    out = _row_shift(out.transpose(1, 2), sy, my).transpose(1, 2)
    return _row_shift(out, sx, mx)


def apply_geometric_packed(
    packed: torch.Tensor, flip: torch.Tensor, angles_deg: torch.Tensor
) -> torch.Tensor:
    """Per-sample flip and rotation of an (m, h, w) int32 stack of
    ``reps`` groups of the n samples, m = reps*n, ``packed[i]`` and
    ``packed[n + i]`` moved by sample i's transform
    (``random_geometric_packed`` :195-236): a quarter turn and the three
    shears through the shift kernels, on all m planes in one launch each.
    Whole 32-bit words move, so the prompt augmentor's groups (u8x4 image +
    mask, the fp32 heatmap's bits) come out bit for bit as the channels of
    one NHWC stack would.  A non-square stack takes the direct gather."""
    m, h, w = packed.shape
    n = flip.shape[0]
    if m % n:
        raise ValueError(f"apply_geometric_packed: {m} planes are not groups of {n} samples")
    flip, angles_deg = flip.repeat(m // n), angles_deg.repeat(m // n)
    x = torch.where(flip.view(-1, 1, 1), packed.flip(2), packed)
    if h != w:
        return _rotate_gather(x[..., None], angles_deg)[..., 0]
    quarter, sx, sy = _shear3_shifts(angles_deg, m, h, w)
    base = _quarter_turn(x, quarter).contiguous()
    out = roll.row_shift(base, sx)
    out = roll.col_shift(out, sy)
    return roll.row_shift(out, sx)


def apply_geometric(
    stacked: torch.Tensor, flip: torch.Tensor, angles_deg: torch.Tensor, method: str = "shear3"
) -> torch.Tensor:
    """Per-sample horizontal flip and rotation of an NHWC stack (image ||
    mask || ...), every channel of a sample moved alike (:289-319).
    ``method``: "shear3" (quarter turn + three shears), "gather" (direct
    2-D nearest map, the exactness oracle) or "two_pass" (two axis gathers)."""
    flipped = torch.where(flip.view(-1, 1, 1, 1), stacked.flip(2), stacked)
    if method == "shear3":
        return _rotate_shear3(flipped, angles_deg)
    if method == "two_pass":
        return _rotate_two_pass(flipped, angles_deg)
    if method == "gather":
        return _rotate_gather(flipped, angles_deg)
    raise ValueError(f"unknown geometry {method!r}; expected one of {GEOMETRIES}")


# --------------------------------------------------------------------------
# colour (image only)
# --------------------------------------------------------------------------

_GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def _gray(img: torch.Tensor) -> torch.Tensor:
    """``einsum("nhwc,c->nhw", img, fp32 gray weights)``, promoted as JAX
    promotes a bf16 image against the fp32 weights."""
    dt = torch.promote_types(img.dtype, torch.float32)
    wts = torch.tensor(_GRAY_WEIGHTS, dtype=dt, device=img.device)
    return torch.einsum("nhwc,c->nhw", img.to(dt), wts)


def _rgb_to_hsv(rgb: torch.Tensor):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-12), 0.0)
    safe = delta.clamp(min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    # the sextant by ORDER comparisons, not `maxc == r` (:346-352)
    is_r = (r >= g) & (r >= b)
    is_g = ~is_r & (g >= b)
    h = torch.where(is_r, bc - gc, torch.where(is_g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return h, s, v


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6

    def select(*cs):  # jnp.select over i == 0..5
        out = cs[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(i == k, cs[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def apply_color_jitter(images: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Apply (n, 4) jitter factors in the fixed order b -> c -> s -> h."""
    fb, fc, fs = (factors[:, k].view(-1, 1, 1, 1) for k in range(3))
    fh = factors[:, 3].view(-1, 1, 1)
    img = (images * fb).clamp(0.0, 1.0)
    gray_mean = _gray(img).mean(dim=(1, 2)).view(-1, 1, 1, 1)
    img = (fc * img + (1.0 - fc) * gray_mean).clamp(0.0, 1.0)
    gray = _gray(img)[..., None]
    img = (fs * img + (1.0 - fs) * gray).clamp(0.0, 1.0)
    h, s, v = _rgb_to_hsv(img)
    return _hsv_to_rgb((h + fh) % 1.0, s, v).clamp(0.0, 1.0)


def apply_gaussian_blur_5x5(images: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap blur of NHWC images with per-sample (n, 5) weights,
    reflect padding, H pass then W pass, taps summed 0..4 from zero."""
    def blur_axis(img, axis):
        pad = (0, 0, 2, 2) if axis == 1 else (2, 2, 0, 0)
        p = F.pad(img.permute(0, 3, 1, 2), pad, mode="reflect").permute(0, 2, 3, 1)
        length = img.shape[axis]
        total = torch.zeros_like(img)
        for tap in range(5):
            total = total + p.narrow(axis, tap, length) * weights[:, tap].view(-1, 1, 1, 1)
        return total

    return blur_axis(blur_axis(images, 1), 2)


# --------------------------------------------------------------------------
# the augmentor
# --------------------------------------------------------------------------

def _clean_slots(n: int, step: int, device, offset: int = 0) -> torch.Tensor:
    """The positions that keep their clean value: every ``step``-th of the
    global batch, whose rows ``[offset, offset + n)`` these are."""
    return (torch.arange(n, device=device) + offset) % step == 0


@dataclasses.dataclass(frozen=True)
class DataAugmentor:
    """The JAX ``DataAugmentor`` (:482) with sampling split from applying:
    ``params = aug.sample(n, generator)``, then ``aug.apply_u8(params,
    images_u8, masks_u8)`` or ``aug(params, images, masks)``."""

    augmentations_per_datapoint: int = 4
    max_degrees: float = 90.0
    backend: str = "xla"        # colour stage: torch ops, or the fused kernel
    geometry: str = "shear3"    # "shear3" | "gather" | "two_pass"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected one of {BACKENDS}")
        if self.geometry not in GEOMETRIES:
            raise ValueError(f"unknown geometry {self.geometry!r}; expected one of {GEOMETRIES}")

    def sample(self, n: int, generator: torch.Generator) -> AugmentParams:
        """The draws of one batch, on the generator's device."""
        flip, angles = sample_geometric(n, generator, self.max_degrees)
        return AugmentParams(flip, angles, sample_jitter_factors(n, generator),
                             sample_blur_weights(n, generator))

    def _colour_stage(self, params: AugmentParams, images, *, from_u8: bool, dtype):
        """normalize (if from u8) + jitter + blur via the selected backend,
        inside the profiler span ``augment.colour``."""
        with spans.span("augment.colour"):
            if self.backend == "pallas" and from_u8:
                return _preprocess.preprocess(images.contiguous(), params.jitter, params.blur,
                                              out_dtype=dtype)
            img = normalize_image(images, dtype) if from_u8 else images
            return apply_gaussian_blur_5x5(apply_color_jitter(img, params.jitter), params.blur)

    def __call__(
        self, params: AugmentParams, images: torch.Tensor, masks: torch.Tensor, *,
        offset: int = 0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Float NHWC images and integer (n, h, w) masks -> augmented pair of
        the same types; every (aug+1)-th position of the global batch keeps
        its clean value (``offset``: the first row's position there, for a
        rank's rows of a batch)."""
        params = params.to(images.device)
        with spans.span("augment.geometry"):
            stacked = torch.cat([images, masks.to(images.dtype)[..., None]], dim=-1)
            stacked = apply_geometric(stacked, params.flip, params.angles, self.geometry)
            aug_masks = stacked[..., 3].to(masks.dtype)
        aug_images = self._colour_stage(params, stacked[..., :3], from_u8=False,
                                        dtype=images.dtype)
        clean = _clean_slots(images.shape[0], self.augmentations_per_datapoint + 1, images.device,
                             offset)
        return (torch.where(clean[:, None, None, None], images, aug_images),
                torch.where(clean[:, None, None], masks, aug_masks))

    def apply_u8(
        self,
        params: AugmentParams,
        images_u8: torch.Tensor,
        masks_u8: torch.Tensor,
        dtype: torch.dtype = torch.float32,
        *,
        offset: int = 0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The geometry in uint8 (nearest resampling moves whole values, so
        the result equals ``__call__`` on the normalised images), then the
        colour stage in ``dtype``.  Returns ([0, 1] images in ``dtype``,
        int64 class-id masks); zero fill is class 0.  ``offset``: as
        ``__call__``'s."""
        params = params.to(images_u8.device)
        with spans.span("augment.geometry"):
            stacked = torch.cat([images_u8, masks_u8[..., None]], dim=-1)
            stacked = apply_geometric(stacked, params.flip, params.angles, self.geometry)
            aug_masks = stacked[..., 3].long()
        aug_images = self._colour_stage(params, stacked[..., :3], from_u8=True, dtype=dtype)
        clean = _clean_slots(images_u8.shape[0], self.augmentations_per_datapoint + 1,
                             images_u8.device, offset)
        return (torch.where(clean[:, None, None, None], normalize_image(images_u8, dtype), aug_images),
                torch.where(clean[:, None, None], masks_u8.long(), aug_masks))


@dataclasses.dataclass(frozen=True)
class DataAugmentorPrompt:
    """The JAX ``DataAugmentorPrompt`` (:572) with sampling split from
    applying: the geometry moves the image, the label mask and the prompt
    heatmap together; the colour stage (``color_jitter`` +
    ``gaussian_blur_5x5``, the xla form, :644-646) touches the image only.
    Its draws are a :class:`DataAugmentor`'s: ``sample`` is the same."""

    augmentations_per_datapoint: int = 4
    max_degrees: float = 90.0

    def sample(self, n: int, generator: torch.Generator) -> AugmentParams:
        return DataAugmentor(self.augmentations_per_datapoint, self.max_degrees).sample(
            n, generator)

    def apply_u8(
        self,
        params: AugmentParams,
        images_u8: torch.Tensor,
        masks_u8: torch.Tensor,
        prompts: torch.Tensor,
        dtype: torch.dtype = torch.float32,
        *,
        offset: int = 0,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """uint8 images (n, h, w, 3), uint8 label masks (n, h, w) and fp32
        prompts (n, h, w[, 1]) -> ([0, 1] images in ``dtype``, int64 masks,
        fp32 prompts (n, h, w, 1)) (:605-657).  The image and mask are
        packed as u8x4 and the heatmap's bits as int32 under them, one
        (2n, h, w) stack through :func:`apply_geometric_packed`; zero fill
        is class 0 and heat 0.0.  ``offset``: as ``DataAugmentor``'s."""
        params = params.to(images_u8.device)
        n = images_u8.shape[0]
        prompts_c = prompts if prompts.dim() == 4 else prompts[..., None]
        with spans.span("augment.geometry"):
            packed4 = roll.pack_u8x4(torch.cat([images_u8, masks_u8[..., None]], dim=-1))
            heat = prompts_c[..., 0].float().contiguous().view(torch.int32)
            out = apply_geometric_packed(torch.cat([packed4, heat]), params.flip, params.angles)
            four = roll.unpack_u8x4(out[:n])
            aug_prompts = out[n:].contiguous().view(torch.float32)[..., None]
        with spans.span("augment.colour"):
            aug_images = apply_gaussian_blur_5x5(
                apply_color_jitter(normalize_image(four[..., :3], dtype), params.jitter),
                params.blur)
        clean = _clean_slots(n, self.augmentations_per_datapoint + 1, images_u8.device, offset)
        return (torch.where(clean[:, None, None, None], normalize_image(images_u8, dtype),
                            aug_images),
                torch.where(clean[:, None, None], masks_u8.long(), four[..., 3].long()),
                torch.where(clean[:, None, None, None], prompts_c.float(), aug_prompts))
