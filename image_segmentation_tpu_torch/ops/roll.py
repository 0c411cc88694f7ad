"""Per-row / per-column variable shift of packed pixels, the three shears of
the augmentor's rotation; counterpart of
``image_segmentation_tpu/ops/pallas_roll.py``.

Wrappers (``WRAPPERS``), the TPU kernel each replaces, and its source:

- :func:`row_shift` — ``_make_shift`` :55 with ``axis=1``
  (``pallas_row_shift`` :78); ``csrc/shift.cu``;
- :func:`col_shift` — ``_make_shift`` :55 with ``axis=0``
  (``pallas_col_shift`` :87); ``csrc/shift.cu``.

``out[n, i, j] = x[n, i, j - s[n, i]]`` (row) and ``x[n, i - s[n, j], j]``
(col), zero where the source lies outside the plane.  The TPU kernel rolls
by ``s mod size`` and masks with ``(idx >= s) & (idx < size + s)``; that
predicate is ``0 <= idx - s < size``, the source index being in range, so
reading the source directly gives the same words for any shift, and for
``|s| < size`` the same as the XLA form ``augment._row_shift``.

A CPU tensor takes the plain version (a ``torch.gather`` with a clamped
index and that mask), a CUDA tensor launches the kernel or raises.  Each
wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from ._build import launch, on_cpu, ptr


def pack_u8x4(x_u8: torch.Tensor) -> torch.Tensor:
    """(n, h, w, 4) uint8 -> (n, h, w) int32, one pixel per element
    (little endian, as ``lax.bitcast_convert_type``)."""
    if x_u8.dtype != torch.uint8 or x_u8.shape[-1] != 4:
        raise ValueError(f"pack_u8x4: expected (..., 4) uint8, got {tuple(x_u8.shape)} {x_u8.dtype}")
    return x_u8.contiguous().view(torch.int32)[..., 0]


def unpack_u8x4(x_i32: torch.Tensor) -> torch.Tensor:
    """(n, h, w) int32 -> (n, h, w, 4) uint8."""
    return x_i32.contiguous()[..., None].view(torch.uint8)


def _shift_plain(x: torch.Tensor, shifts: torch.Tensor, axis: int) -> torch.Tensor:
    n, h, w = x.shape
    size = w if axis == 2 else h
    s = shifts.to(device=x.device, dtype=torch.int64)
    s = s[:, :, None] if axis == 2 else s[:, None, :]
    idx = torch.arange(size, device=x.device).view((1, 1, size) if axis == 2 else (1, size, 1))
    src = idx - s
    valid = (src >= 0) & (src < size)
    out = torch.gather(x, axis, src.clamp(0, size - 1).expand(n, h, w))
    return torch.where(valid, out, torch.zeros((), dtype=x.dtype, device=x.device))


def row_shift_plain(x_i32: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """``out[n, i, j] = x[n, i, j - shifts[n, i]]``, zero fill."""
    return _shift_plain(x_i32, shifts, 2)


def col_shift_plain(x_i32: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """``out[n, i, j] = x[n, i - shifts[n, j], j]``, zero fill."""
    return _shift_plain(x_i32, shifts, 1)


def _shift(wrapper, x: torch.Tensor, shifts: torch.Tensor, axis: int) -> torch.Tensor:
    name = wrapper.__name__
    if x.dtype != torch.int32 or x.dim() != 3:
        raise ValueError(f"{name}: x must be (n, h, w) int32, got {tuple(x.shape)} {x.dtype}")
    n, h, w = x.shape
    want = (n, h) if axis == 2 else (n, w)
    if tuple(shifts.shape) != want:
        raise ValueError(f"{name}: shifts must have shape {want}, got {tuple(shifts.shape)}")
    if on_cpu(x):
        return _shift_plain(x, shifts, axis)
    if shifts.device != x.device:
        raise ValueError(f"{name}: shifts on {shifts.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    s = shifts.to(torch.int32).contiguous()
    out = torch.empty_like(x)
    launch(wrapper, "imgseg_shift", ptr(x), ptr(s), ptr(out), n, h, w, 1 if axis == 2 else 0)
    return out


def row_shift(x_i32: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Per-row shift of an (n, h, w) int32 stack by ``shifts`` (n, h):
    ``out[n, i, j] = x[n, i, j - shifts[n, i]]``, zero fill."""
    return _shift(row_shift, x_i32, shifts, 2)


def col_shift(x_i32: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Per-column shift of an (n, h, w) int32 stack by ``shifts`` (n, w):
    ``out[n, i, j] = x[n, i - shifts[n, j], j]``, zero fill."""
    return _shift(col_shift, x_i32, shifts, 1)


WRAPPERS = (row_shift, col_shift)
for _w in WRAPPERS:
    _w.launches = 0
