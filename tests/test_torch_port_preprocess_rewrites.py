"""The numerical rewrites the colour kernel (csrc/preprocess.cu) makes of
the plain colour stage (ops/preprocess.py ``preprocess_plain``), checked on
the CPU in fp32, whose separately rounded ops are the kernel's:

- ``x % 1.0`` (``torch.remainder``) as ``x - floor(x)``;
- no clip of the HSV -> RGB result: v, p, q and t already lie in [0, 1];
- the sextant index ``floor(h * 6) % 6`` as a wrap of 6 to 0, since
  ``floor(h * 6)`` lies in 0 ... 6 for h in [0, 1];
- the hue from two divisions (the two of rc, gc, bc its sextant takes);
- and, all of these together with the per-image constants (1 - fc) * mean
  and 1 - fs taken once, the whole stage bit for bit;
- each division a / b as a reciprocal y of b refined by one Newton step and
  one correction of a*y by its residual (``divide`` in the kernel), run here
  in exact rational arithmetic rounded to fp32 at every step: the
  correctly rounded quotient for any starting reciprocal within 2 ulps of
  1/b (the bound of PTX's rcp.approx.f32), over the chain's operands.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_segmentation_tpu_torch.ops import preprocess as P
from image_segmentation_tpu_torch.ops.augment import DataAugmentor


def _near_integers() -> torch.Tensor:
    """-3 ... 3, four ulps either side of each, and tiny values of both signs."""
    k = torch.arange(-3.0, 4.0)
    xs, up, down = [k], k, k
    for _ in range(4):
        up, down = torch.nextafter(up, k + 1), torch.nextafter(down, k - 1)
        xs += [up, down]
    xs.append(torch.tensor([-1e-10, -1e-30, -1e-45, 1e-45, -0.0, 0.0]))
    return torch.cat(xs)


_RNG = np.random.default_rng(0)
MOD1_INPUTS = {
    "negatives": torch.from_numpy(-_RNG.uniform(0.0, 3.0, 100_000).astype(np.float32)),
    "near integers": _near_integers(),
    # h / 6 over the hue's [-1, 5] and h + fh with fh in [-0.5, 0.5]
    "the chain's range": torch.from_numpy(_RNG.uniform(-1.0, 2.0, 100_000).astype(np.float32)),
}


@pytest.mark.parametrize("which", sorted(MOD1_INPUTS))
def test_mod1_as_x_minus_floor_equals_remainder(which):
    x = MOD1_INPUTS[which].to(torch.float32)
    assert torch.equal(x - torch.floor(x), torch.remainder(x, 1.0))


def test_hsv_to_rgb_stays_in_the_unit_interval_unclipped():
    rng = np.random.default_rng(1)
    edge = np.array([0.0, 1e-30, 0.5, 1.0 - 2.0**-24, 1.0], np.float32)
    v, s, fr = (torch.from_numpy(np.concatenate([rng.uniform(0, 1, 200_000).astype(np.float32),
                                                  rng.choice(edge, 200_000)])) for _ in range(3))
    fr = fr.clamp(max=1.0 - 2.0**-24)  # h6 - floor(h6) < 1
    p = v * (1.0 - s)
    q = v * (1.0 - s * fr)
    t = v * (1.0 - s * (1.0 - fr))
    for x in (p, q, t):
        assert bool(((x >= 0) & (x <= 1)).all())


def test_sextant_index_wraps_six_to_zero():
    h = torch.cat([torch.linspace(0.0, 1.0, 100_001),
                   torch.nextafter(torch.tensor([1.0] * 3), torch.tensor([0.0] * 3)),
                   torch.tensor([1.0])])
    fi = torch.floor(h * 6.0).to(torch.int32)
    assert int(fi.min()) >= 0 and int(fi.max()) <= 6
    assert torch.equal(torch.where(fi >= 6, fi - 6, fi), fi % 6)


def _kernel_order(images_u8, jitter, blur):
    """The kernel's arithmetic, op for op, on (n, h, w) planes in fp32."""
    n = images_u8.shape[0]
    fb, fc, fs, fh = (jitter[:, k].view(n, 1, 1) for k in range(4))
    taps = blur

    def gray(r, g, b):
        return 0.299 * r + 0.587 * g + 0.114 * b

    r, g, b = (images_u8[..., c].to(torch.float32) * (1.0 / 255.0) for c in range(3))
    r, g, b = ((x * fb).clamp(0.0, 1.0) for x in (r, g, b))
    cm = (1.0 - fc) * gray(r, g, b).mean((1, 2)).view(n, 1, 1)
    r, g, b = ((fc * x + cm).clamp(0.0, 1.0) for x in (r, g, b))
    sg = (1.0 - fs) * gray(r, g, b)
    r, g, b = ((fs * x + sg).clamp(0.0, 1.0) for x in (r, g, b))
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v, delta = maxc, maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-12), 0.0)
    safe = delta.clamp(min=1e-12)
    is_r = (r >= g) & (r >= b)
    is_g = ~is_r & (g >= b)
    d1 = (maxc - torch.where(is_r, b, torch.where(is_g, r, g))) / safe
    d2 = (maxc - torch.where(is_r, g, torch.where(is_g, b, r))) / safe
    h = torch.where(is_r, d1 - d2, torch.where(is_g, 2.0, 4.0) + d1 - d2)

    def mod1(x):
        return x - torch.floor(x)

    h = torch.where(delta > 0, mod1(h / 6.0), 0.0)
    h = mod1(h + fh)
    fi = torch.floor(h * 6.0)
    fr = h * 6.0 - fi
    p, q, t = v * (1.0 - s), v * (1.0 - s * fr), v * (1.0 - s * (1.0 - fr))
    i = fi.to(torch.int32)
    i = torch.where(i >= 6, i - 6, i)

    def sextant(*cs):
        out = cs[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(i == k, cs[k], out)
        return out

    planes = [sextant(v, q, p, p, t, v), sextant(t, v, v, q, p, p), sextant(p, p, t, v, v, q)]

    def blur_axis(x, axis):
        length = x.shape[axis]
        padded = F.pad(x, (0, 0, 2, 2) if axis == 1 else (2, 2), mode="reflect")
        total = torch.zeros_like(x)
        for tap in range(5):
            total = total + padded.narrow(axis, tap, length) * taps[:, tap].view(n, 1, 1)
        return total

    return torch.stack([blur_axis(blur_axis(x, 1), 2) for x in planes], dim=-1)


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_order_of_the_colour_stage_equals_the_plain_version_bit_for_bit(seed):
    """Random pixels, gray pixels (delta 0), black and white ones, under
    factors from the augmentor's own draws."""
    rng = np.random.default_rng(seed)
    n, h, w = 8, 24, 20
    u8 = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    u8[:, :4] = rng.integers(0, 256, (n, 4, w, 1), dtype=np.uint8)  # gray rows
    u8[:, 4, :, :] = 0
    u8[:, 5, :, :] = 255
    images = torch.from_numpy(u8)
    p = DataAugmentor(4).sample(n, torch.Generator().manual_seed(seed))
    got = _kernel_order(images, p.jitter.float(), p.blur.float())
    assert torch.equal(got, P.preprocess_plain(images, p.jitter, p.blur))


def _rn32(q: Fraction) -> Fraction:
    """The fp32 nearest to q, ties to even (normal range)."""
    if q == 0:
        return Fraction(0)
    sign, q = (-1 if q < 0 else 1), abs(q)
    e = math.floor(math.log2(q.numerator) - math.log2(q.denominator))
    while Fraction(2) ** e > q:
        e -= 1
    while Fraction(2) ** (e + 1) <= q:
        e += 1
    scale = Fraction(2) ** (23 - e)
    m = q * scale
    f, rem = divmod(m.numerator, m.denominator)
    rem = Fraction(rem, m.denominator)
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and f % 2):
        f += 1
    return sign * Fraction(f) / scale


def _ulp(x: Fraction) -> Fraction:
    return _rn32(x * (1 + Fraction(1, 2**23))) - x if x else Fraction(0)


def _divide(a: Fraction, b: Fraction, y: Fraction) -> Fraction:
    q = _rn32(a * y)
    return _rn32(_rn32(a - b * q) * y + q)  # fma(fma(-b, q, a), y, q)


def _f32(x) -> Fraction:
    return Fraction(float(np.float32(x)))


@pytest.mark.parametrize("case", ["(maxc - x) / safe and delta / maxc", "h / 6"])
def test_reciprocal_division_is_correctly_rounded(case):
    rng = np.random.default_rng(3)
    pairs = []
    for _ in range(800):
        if case == "h / 6":
            pairs.append((_f32(rng.uniform(-1.0, 5.0)), Fraction(6)))
        else:
            b = _f32(np.exp(rng.uniform(math.log(1e-12), 0.0)))  # safe, maxc in [1e-12, 1]
            pairs.append((_f32(rng.uniform(0.0, 1.0) * float(b)), b))  # 0 <= a <= b
    if case == "h / 6":
        pairs += [(Fraction(k), Fraction(6)) for k in (-1, 0, 3, 5)]
    else:
        pairs += [(Fraction(0), _f32(1 / 3)), (_f32(0.7), _f32(0.7)), (_f32(1e-12), _f32(1e-12))]
    for a, b in pairs:
        want = _rn32(a / b)
        if case == "h / 6":  # the kernel's y is 1/6 rounded, unrefined
            assert _divide(a, b, _rn32(Fraction(1, 6))) == want, (a, b)
            continue
        r1 = _rn32(1 / b)
        for k in (-2, -1, 0, 1, 2):
            y0 = r1 + k * _ulp(r1)
            y = _rn32(_rn32(1 - b * y0) * y0 + y0)  # fma(fma(-b, y0, 1), y0, y0)
            assert _divide(a, b, y) == want, (a, b, k)
