"""The augmentor's fused colour stage, uint8 -> jittered and blurred float
image; counterpart of ``image_segmentation_tpu/ops/pallas_preprocess.py``.

Wrapper (``WRAPPERS``): :func:`preprocess` — ``pallas_preprocess`` :147
(body ``_kernel`` :52); ``csrc/preprocess.cu``.  Per image, with
per-sample factors drawn outside (``augment.DataAugmentor.sample``)::

    normalize (*1/255) -> brightness -> contrast (per-image gray mean)
    -> saturation -> hue (HSV round trip) -> separable 5-tap blur

A CPU tensor takes :func:`preprocess_plain`, a transcription of the Pallas
``_kernel`` on (n, h, w) planes, all in fp32 and rounded to ``out_dtype``
at the end; a CUDA tensor launches the kernel or raises.  The kernel counts
its launches in ``preprocess.launches``.  The plain version is not the
``"xla"`` colour stage of ``augment.py`` (the JAX package's other backend,
which normalises with a division and in ``dtype``): the tests hold the two
together.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import launch, on_cpu, ptr, scratch

_GRAY_R, _GRAY_G, _GRAY_B = 0.299, 0.587, 0.114


def preprocess_plain(
    images_u8: torch.Tensor,
    jitter: torch.Tensor,
    blur: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Fused normalize + jitter + blur of an (n, h, w, 3) uint8 batch with
    (n, 4) jitter factors [brightness, contrast, saturation, hue] and (n, 5)
    blur weights; see :func:`preprocess`."""
    n = images_u8.shape[0]
    dev = images_u8.device
    f = jitter.to(device=dev, dtype=torch.float32)
    fb, fc, fs, fh = (f[:, k].view(n, 1, 1) for k in range(4))
    taps = blur.to(device=dev, dtype=torch.float32)

    def plane(c):
        return images_u8[..., c].to(torch.int32).to(torch.float32) * (1.0 / 255.0)

    r, g, b = plane(0), plane(1), plane(2)
    # brightness
    r, g, b = ((x * fb).clamp(0.0, 1.0) for x in (r, g, b))
    # contrast: blend with the mean gray of the brightened image
    gray = _GRAY_R * r + _GRAY_G * g + _GRAY_B * b
    gray_mean = gray.mean((1, 2)).view(n, 1, 1)
    r, g, b = ((fc * x + (1.0 - fc) * gray_mean).clamp(0.0, 1.0) for x in (r, g, b))
    # saturation: blend with the per-pixel gray
    gray = _GRAY_R * r + _GRAY_G * g + _GRAY_B * b
    r, g, b = ((fs * x + (1.0 - fs) * gray).clamp(0.0, 1.0) for x in (r, g, b))

    # hue: RGB -> HSV -> +fh -> RGB, the sextant by order comparisons
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-12), 0.0)
    safe = delta.clamp(min=1e-12)
    rc, gc, bc = ((maxc - x) / safe for x in (r, g, b))
    is_r = (r >= g) & (r >= b)
    is_g = ~is_r & (g >= b)
    h = torch.where(is_r, bc - gc, torch.where(is_g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    h = (h + fh) % 1.0
    i = torch.floor(h * 6.0)
    frac = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * frac)
    t = v * (1.0 - s * (1.0 - frac))
    i = i.to(torch.int32) % 6

    def sextant(*cs):
        out = cs[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(i == k, cs[k], out)
        return out

    r = sextant(v, q, p, p, t, v).clamp(0.0, 1.0)
    g = sextant(t, v, v, q, p, p).clamp(0.0, 1.0)
    b = sextant(p, p, t, v, v, q).clamp(0.0, 1.0)

    # separable 5-tap blur per plane, reflect padding, H pass then W pass
    def blur_axis(x, axis):
        length = x.shape[axis]
        padded = F.pad(x, (0, 0, 2, 2) if axis == 1 else (2, 2), mode="reflect")
        total = torch.zeros_like(x)
        for tap in range(5):
            total = total + padded.narrow(axis, tap, length) * taps[:, tap].view(n, 1, 1)
        return total

    out = [blur_axis(blur_axis(x, 1), 2) for x in (r, g, b)]
    return torch.stack(out, dim=-1).to(out_dtype)


def preprocess(
    images_u8: torch.Tensor,
    jitter: torch.Tensor,
    blur: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Fused normalize + colour jitter + 5x5 blur: images (n, h, w, 3)
    uint8, h and w at least 3; jitter (n, 4) [brightness, contrast,
    saturation, hue] from ``augment.sample_jitter_factors``; blur (n, 5)
    normalised tap weights from ``augment.sample_blur_weights``.  Returns
    (n, h, w, 3) in ``out_dtype`` (fp32 or bf16), computed in fp32."""
    name = "preprocess"
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"{name}: images must be (n, h, w, 3) uint8, got "
                         f"{tuple(images_u8.shape)} {images_u8.dtype}")
    n, h, w, _ = images_u8.shape
    if h < 3 or w < 3:
        raise ValueError(f"{name}: the reflect padding needs h, w >= 3, got {h}x{w}")
    if tuple(jitter.shape) != (n, 4) or tuple(blur.shape) != (n, 5):
        raise ValueError(f"{name}: jitter must be ({n}, 4) and blur ({n}, 5), got "
                         f"{tuple(jitter.shape)} and {tuple(blur.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if on_cpu(images_u8):
        return preprocess_plain(images_u8, jitter, blur, out_dtype)
    for t in (jitter, blur):
        if t.device != images_u8.device:
            raise ValueError(f"{name}: factors on {t.device}, images on {images_u8.device}")
    if not images_u8.is_contiguous():
        raise ValueError(f"{name}: images must be contiguous")
    jitter, blur = jitter.float().contiguous(), blur.float().contiguous()
    out = torch.empty((n, h, w, 3), dtype=out_dtype, device=images_u8.device)
    part = scratch("imgseg_preprocess_scratch", images_u8, n, h, w)
    launch(preprocess, "imgseg_preprocess", ptr(images_u8), ptr(jitter), ptr(blur), ptr(out),
           ptr(part), n, h, w, int(out_dtype == torch.bfloat16))
    return out


WRAPPERS = (preprocess,)
preprocess.launches = 0
