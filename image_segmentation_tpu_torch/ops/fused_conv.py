"""The kernels of the ``large_unet`` preset's serving and training paths,
each a wrapper beside its plain PyTorch version, and the three
``torch.autograd.Function``s built on them; counterpart of
``image_segmentation_tpu/ops/pallas_conv.py``.

Wrappers (``WRAPPERS``), the TPU kernel each replaces, and its source:

- :func:`conv3x3` — ``_folded_conv_pallas`` :568 in the forms
  ``make_folded_conv_bn3x3`` :2033 (eval) and ``make_folded_block`` :2227
  (``stats``) reach; ``csrc/conv3x3.cu``;
- :func:`conv3x3_dgrad` and :func:`conv3x3_wgrad` — the merged dx + wgrad
  ``_folded_bwd_fused_pallas`` :1139, as two kernels (``csrc/conv3x3.cu``
  and ``csrc/conv3x3_bwd.cu``); the wgrad alone is ``_folded_wgrad_pallas``
  :822;
- the three in their plain forms (no affine, no statistics, no cotangent
  transform) — ``make_folded_conv3x3`` :1932, the conv of a block that
  applies its BatchNorm outside the kernels (``w2d_impl="pallas"``):
  forward :1978, dx :2005, dw and db :2016;
- :func:`bn_relu_bwd_reduce` — ``_bn_relu_bwd_reduce_pallas`` :1462
  (``csrc/bn_relu_bwd.cu``);
- :func:`maxpool2x2_affine_relu` and :func:`maxpool2x2_affine_relu_bwd` —
  ``make_folded_pool`` :1608, ``_fwd_pallas`` :1629 and ``_bwd_pallas``
  :1665 with ``with_ab=True`` (``csrc/pool.cu``);
- :func:`convtranspose2x2` and :func:`convtranspose2x2_bwd` —
  ``make_folded_convtranspose2x2`` :1795, ``_fwd_pallas`` :1852 and
  ``ct_bwd`` :1888 (``csrc/convtranspose.cu``).

The JAX kernels work on width-folded tensors to fill the TPU's 128 lanes;
at fold 1 they compute the plain NHWC ops, and that is what is ported.

Dispatch is by the device of the input: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (bf16 activations, fp32 sums)
and raises if the build or the launch fails.  Any other device raises.
Each wrapper counts its kernel launches in ``<wrapper>.launches``, and
the three conv wrappers those on their deep path in ``.deep_launches``.  On a
CUDA tensor the wrappers are not differentiable themselves: an input that
requires grad while grad mode is on raises (they are forward-only).
Gradients go through the Functions, whose backwards call the backward
wrappers: :class:`FusedBlockFunction` (a whole BatchNorm'd block),
:class:`Conv3x3Function` (one conv), :class:`PoolFunction` and
:class:`ConvTransposeFunction`.

The plain versions compute in fp32 from the same operands the kernels see
(weights and affines rounded to the activation dtype, bias in fp32) and
round bf16 results the same way, so on the card they are the reference for
the kernels, and in fp32 on the CPU they are the JAX kernels' math (a
float64 operand keeps float64, :func:`~.precision.wide`).  Sums
over pixels are fp32 in both; the kernels take them as per-block partial
sums added in a fixed order, by a second pass or (K3 and the pool
backward) inside the same launch, so they are reproducible but not in
``torch.sum``'s order.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel import mesh
from ..parallel import tensor as tp
from ._build import launch as _launch
from ._build import library as _library
from ._build import on_cpu as _on_cpu
from ._build import ptr as _ptr
from ._build import scratch as _scratch
from .precision import wide


def _round(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``v`` rounded to ``dtype`` and held in fp32 (float64 if ``dtype`` is)."""
    return wide(v.to(dtype))


def _channel_sum(t: torch.Tensor) -> torch.Tensor:
    return t.sum((0, 1, 2))


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _activate(x, x_b, a, b):
    """fp32 operand of a conv: ``[x | x_b]``, or ``round(relu(x*a + b))``."""
    dt = x.dtype
    xin = x if x_b is None else torch.cat([x, x_b.to(dt)], dim=-1)
    xf = wide(xin)
    if a is not None:
        # SAME padding pads the ACTIVATED tensor with zeros (pallas_conv.py
        # _build_aug :288-290), which F.conv2d's zero padding does.
        xf = wide(F.relu(xf * _round(a, dt) + _round(b, dt)).to(dt))
    return xf


def _gfold(g, y, c1, c2, a, b):
    """The transformed cotangent ``ge`` of ``_gfold_transform`` :249, rounded
    to g's dtype: ``g*a*[y*a + b > 0] + c1 + 2*y*c2`` with ``a, b`` (the
    bn2 affine, rounded) or ``g + c1 + 2*y*c2`` without; g itself without
    ``c1`` (no transform: ``y``, ``c2``, ``a``, ``b`` are None too)."""
    if c1 is None:
        return g
    dt = g.dtype
    gf, yf = wide(g), wide(y)
    if a is not None:
        af, bf = _round(a, dt), _round(b, dt)
        gf = torch.where(yf * af + bf > 0, gf * af, 0.0)
    return (gf + c1 + 2.0 * yf * c2).to(dt)


def conv3x3_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    *,
    x_b: Optional[torch.Tensor] = None,
    a: Optional[torch.Tensor] = None,
    b: Optional[torch.Tensor] = None,
    stats: bool = False,
):
    """3x3 SAME conv of ``act([x | x_b])``; see :func:`conv3x3`."""
    dt = x.dtype
    xf = _activate(x, x_b, a, b)
    y = F.conv2d(xf.permute(0, 3, 1, 2), _round(w, dt), bias.to(xf.dtype), padding=1)
    y = y.permute(0, 2, 3, 1).to(dt)
    if not stats:
        return y
    yf = wide(y)
    return y, _channel_sum(yf), _channel_sum(yf * yf)


def conv3x3_dgrad_plain(
    g, y, w, c1, c2, *, a=None, b=None, x_post=None, a_post=None, b_post=None,
    split=None,
):
    """Input gradient of a 3x3 SAME conv; see :func:`conv3x3_dgrad`."""
    dt = g.dtype
    ge = wide(_gfold(g, y, c1, c2, a, b))
    wt = _round(w, dt).flip(2, 3).transpose(0, 1)  # the flipped, transposed kernel
    acc = F.conv2d(ge.permute(0, 3, 1, 2), wt, padding=1).permute(0, 2, 3, 1)
    if x_post is not None:
        xf = wide(x_post)
        ap, bp = _round(a_post, dt), _round(b_post, dt)
        gu = torch.where(xf * ap + bp > 0, acc, 0.0)
        return (gu * ap).to(dt), _channel_sum(gu * xf), _channel_sum(gu)
    if split is not None:
        return acc[..., :split].to(dt), acc[..., split:].to(dt)
    return acc.to(dt)


def conv3x3_wgrad_plain(
    g, y, x, c1, c2, *, a=None, b=None, x_b=None, a_pre=None, b_pre=None,
):
    """Weight and bias gradient of a 3x3 SAME conv; see :func:`conv3x3_wgrad`."""
    ge = wide(_gfold(g, y, c1, c2, a, b)).permute(0, 3, 1, 2)
    xf = _activate(x, x_b, a_pre, b_pre).permute(0, 3, 1, 2)
    dw = torch.nn.grad.conv2d_weight(xf, (ge.shape[1], xf.shape[1], 3, 3), ge, padding=1)
    return dw, ge.sum((0, 2, 3))


def bn_relu_bwd_reduce_plain(g, y, a, b):
    """``(sum P*y, sum P)`` per channel; see :func:`bn_relu_bwd_reduce`."""
    dt = y.dtype
    yf = wide(y)
    p = torch.where(yf * _round(a, dt) + _round(b, dt) > 0, wide(g), 0.0)
    return _channel_sum(p * yf), _channel_sum(p)


def maxpool2x2_affine_relu_plain(
    z: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """2x2/2 max-pool of ``relu(z*a + b)``; see :func:`maxpool2x2_affine_relu`."""
    dt = z.dtype
    u = F.relu(wide(z) * _round(a, dt) + _round(b, dt))
    return F.max_pool2d(u.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).to(dt)


def maxpool2x2_affine_relu_bwd_plain(z, a, b, dp):
    """``(dz, da, db)``; see :func:`maxpool2x2_affine_relu_bwd`."""
    dt = z.dtype
    bsz, h, wd, c = z.shape
    af, bf = _round(a, dt), _round(b, dt)
    zf = wide(z)
    pre = zf * af + bf
    u = F.relu(pre).view(bsz, h // 2, 2, wd // 2, 2, c)
    u00, u01, u10, u11 = u[:, :, 0, :, 0], u[:, :, 0, :, 1], u[:, :, 1, :, 0], u[:, :, 1, :, 1]
    # the first maximum in row-major order: the top row if it holds one,
    # then the left column within the row (pallas_conv.py:1569-1588)
    top = torch.maximum(u00, u01) >= torch.maximum(u10, u11)
    left0, left1 = u00 >= u01, u10 >= u11
    g, zero = wide(dp), torch.zeros((), device=z.device)
    routed = torch.stack([
        torch.stack([torch.where(top & left0, g, zero), torch.where(top & ~left0, g, zero)], 3),
        torch.stack([torch.where(~top & left1, g, zero), torch.where(~top & ~left1, g, zero)], 3),
    ], 2).reshape(bsz, h, wd, c)
    p = torch.where(pre > 0, routed, zero)
    return (p * af).to(dt), _channel_sum(p * zf), _channel_sum(p)


def convtranspose2x2_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """ConvTranspose(k=2, s=2); see :func:`convtranspose2x2`."""
    dt = x.dtype
    xf = wide(x)
    y = F.conv_transpose2d(
        xf.permute(0, 3, 1, 2), _round(w, dt), bias.to(xf.dtype), stride=2
    )
    return y.permute(0, 2, 3, 1).to(dt)


def convtranspose2x2_bwd_plain(x, w, g):
    """``(dx, dw, dbias)``; see :func:`convtranspose2x2_bwd`."""
    dt = x.dtype
    bsz, h, wd, ci = x.shape
    co = w.shape[1]
    gf = wide(g)
    dx = F.conv2d(gf.permute(0, 3, 1, 2), _round(w, dt), stride=2).permute(0, 2, 3, 1)
    g6 = gf.view(bsz, h, 2, wd, 2, co)
    dw = torch.einsum("bijc,biyjxo->coyx", wide(x), g6)
    return dx.to(dt), dw, _channel_sum(gf)


# --------------------------------------------------------------------------
# the conv kernels' paths
# --------------------------------------------------------------------------

# the most K channels the vector kernel takes: a block holds the 9 x K x N
# weights of its N tile (N 32 on 64-pixel strips, or N 16 on 128-pixel
# strips where N <= 16) beside four operand rows.  The forward's K is Cin
# and its N is Co; the dgrad's K is Co and its N is Cin (it convolves the
# cotangent with the flipped, transposed weights).
VECTOR_CIN, VECTOR_CIN_N16 = 192, 160
VECTOR_DGRAD_CO, VECTOR_DGRAD_CO_N16 = 192, 160


def _vector_fits(k: int, n: int, most: int, most_n16: int) -> bool:
    """Whether the vector kernel's weights of a K -> N conv fit: K, padded
    to 16, at most ``most``, or ``most_n16`` where N <= 16."""
    return -(-k // 16) * 16 <= (most if n > 16 else most_n16)


def conv_path(ca: int, cb: int, co: int) -> str:
    """The path of the 3x3 conv kernels for a conv of ``[Ca | Cb] -> Co``
    channels, in its forward, dx and wgrad alike: ``"deep"`` where Ca, Cb
    and Co are multiples of 64 and 256 or more channels go in or come out
    (the fold-1 blocks' levels, wgmma tiles of 64-channel K stages); else
    ``"vector"`` where all are multiples of 8 and the vector kernel's
    weights fit its shared memory in the forward and in the dgrad (Ca + Cb,
    padded to 16, at most VECTOR_CIN, or VECTOR_CIN_N16 where Co <= 16; Co,
    padded to 16, at most VECTOR_DGRAD_CO, or VECTOR_DGRAD_CO_N16 where
    Ca + Cb <= 16: ``csrc/conv3x3.cu`` asserts the same limits); else
    ``"narrow"``.  :func:`_path_arg` adds the operands' alignment."""
    if ca % 64 == 0 and cb % 64 == 0 and co % 64 == 0 and (ca + cb >= 256 or co >= 256):
        return "deep"
    if ca % 8 or cb % 8 or co % 8:
        return "narrow"
    cin = ca + cb
    fits = (_vector_fits(cin, co, VECTOR_CIN, VECTOR_CIN_N16)
            and _vector_fits(co, cin, VECTOR_DGRAD_CO, VECTOR_DGRAD_CO_N16))
    return "vector" if fits else "narrow"


def _path_arg(ca: int, cb: int, co: int, n: int, *operands) -> tuple:
    """The path a conv of ``[Ca | Cb] -> Co`` channels takes on these
    operands, and the C library's argument that names it: 0 the narrow
    path, 1 the vector path, 64 or 128 the deep path's N tile over n
    channels.  It is :func:`conv_path`'s, but that the vector path's shapes
    take the narrow path where an operand is off 16 bytes (the library
    refuses the deep path on one).  The library only checks the choice."""
    path = conv_path(ca, cb, co)
    if path == "vector" and not _aligned(*operands):
        path = "narrow"
    if path == "deep":
        return path, 128 if n % 128 == 0 else 64
    return path, int(path == "vector")


def vector_pack(w: torch.Tensor, dgrad: bool = False) -> torch.Tensor:
    """Weights (Co, Cin, 3, 3) in the vector kernel's order, bf16: for the
    forward N = Co, K = Cin; with ``dgrad`` the flipped, transposed kernel
    (N = Cin, K = Co, the taps in reverse order).  K zero-padded to Kp, a
    multiple of 16 (one k16 step is two 8-channel planes), then for each
    tap the (N x Kp) matrix as the wgmma's K-major core matrices
    ([N/8][Kp/8][8 of N][8 of K]), so a block's N tile of a tap is one bulk
    copy."""
    if dgrad:
        w = w.transpose(0, 1)
    n, k = w.shape[0], w.shape[1]
    kp = -(-k // 16) * 16
    if kp != k:
        w = F.pad(w, (0, 0, 0, 0, 0, kp - k))
    tiles = w.reshape(n // 8, 8, kp // 8, 8, 9)
    if dgrad:
        tiles = tiles.flip(4)
    return tiles.permute(4, 0, 2, 1, 3).to(torch.bfloat16, memory_format=torch.contiguous_format)


def _aligned(*tensors) -> bool:
    """Whether every given tensor starts on a 16-byte boundary."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def deep_pack(wk: torch.Tensor, n: int) -> torch.Tensor:
    """Weights (3, 3, K, N) in the deep kernel's order: for each N tile of n
    channels, 64-channel K stage and tap, the (n x 64) tile as the wgmma's
    K-major core matrices ([n/8][8][8 of N][8 of K]), one bulk copy each."""
    k, nn = wk.shape[2], wk.shape[3]
    tiles = wk.reshape(9, k // 64, 8, 8, nn // n, n // 8, 8)
    return tiles.permute(4, 1, 0, 5, 2, 6, 3).contiguous()


# --------------------------------------------------------------------------
# checks shared by the wrappers
# --------------------------------------------------------------------------

def _check_cuda_operands(name: str, x: torch.Tensor, *others) -> None:
    tensors = [x, *(t for t in others if t is not None)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA wrapper is forward-only; call it under "
            "torch.no_grad() or through its autograd Function"
        )
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and {x.device}")


def _check_activation(name: str, t: torch.Tensor, what: str, shape=None) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: {what} must be bfloat16, got {t.dtype}")
    if t.dim() != 4:
        raise ValueError(f"{name}: {what} must be NHWC, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_transform(name: str, y, c1, c2, a, b) -> bool:
    """True with a cotangent transform (``y``, ``c1``, ``c2``), False for the
    raw cotangent (all of ``y``, ``c1``, ``c2``, ``a``, ``b`` None)."""
    if y is None and c1 is None and c2 is None:
        if a is not None or b is not None:
            raise ValueError(f"{name}: the affine a, b comes with y, c1 and c2")
        return False
    if y is None or c1 is None or c2 is None:
        raise ValueError(f"{name}: pass y, c1 and c2 together, or none of them")
    return True


def _check_vector(name: str, t: torch.Tensor, n: int, what: str) -> None:
    if t.shape != (n,):
        raise ValueError(f"{name}: {what} must have shape ({n},), got {tuple(t.shape)}")


def _check_fp32_vector(name: str, t: torch.Tensor, n: int, what: str) -> None:
    """A per-channel vector that a kernel reads as it is: (n,), fp32,
    contiguous."""
    _check_vector(name, t, n, what)
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


@functools.lru_cache(maxsize=None)
def _sums_floats(query: str, *dims: int) -> int:
    """The C library's ``query`` for these dims, asked once: the size of a
    one-launch reduction's buffer depends on the card and the shape only."""
    n = int(getattr(_library(), query)(*dims))
    if n < 0:
        raise ValueError(f"{query}{dims}: the kernel takes no such shape")
    return n


def _sums_buffer(like: torch.Tensor, query: str, *dims: int) -> torch.Tensor:
    """fp32 buffer of a one-launch reduction: its sums, then one row of
    partials per block of its grid."""
    return torch.empty(_sums_floats(query, *dims), dtype=torch.float32, device=like.device)


def _check_pair(name: str, a, b, what: str) -> None:
    if (a is None) != (b is None):
        raise ValueError(f"{name}: pass both {what}, or neither")


def _ab(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(2, C) fp32 rows [a, b], rounded to ``dtype``."""
    return torch.stack([_round(a, dtype), _round(b, dtype)]).contiguous()


def _gf(c1, c2, a, b, dtype) -> Optional[torch.Tensor]:
    """The cotangent transform's per-channel rows: [c1, c2], or
    [a, b, c1, c2] with the affine rounded to ``dtype``; None without c1
    (no transform)."""
    if c1 is None:
        return None
    rows = [c1.float(), c2.float()]
    if a is not None:
        rows = [_round(a, dtype), _round(b, dtype)] + rows
    return torch.stack(rows).contiguous()


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def conv3x3(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    *,
    x_b: Optional[torch.Tensor] = None,
    a: Optional[torch.Tensor] = None,
    b: Optional[torch.Tensor] = None,
    stats: bool = False,
):
    """3x3 SAME conv with optional BN-affine + ReLU on load.

    x (B,H,W,Ca) and optional x_b (B,H,W,Cb): the input is the channel
    concat ``[x | x_b]`` (the decoder's [up | skip]).  w is the torch
    layout (Co, Ca+Cb, 3, 3), bias (Co,).  ``a, b`` (Ca,), only without
    ``x_b`` (pallas_conv.py:2097): the conv reads ``act(t) =
    round(max(t*a + b, 0))`` with ``a, b`` rounded to the activation dtype
    first (``_ab_pre`` :2103-2105); positions outside the image are zero
    after activation.  Output y (B,H,W,Co) = round(bias + sum), fp32 sum.

    ``stats``: also return the per-channel fp32 sums ``S = sum y`` and
    ``Q = sum y*y`` of the ROUNDED output (the BN batch statistics,
    ``_conv_kernel_body`` :557-565): ``(y, S, Q)``.
    """
    name = "conv3x3"
    _check_pair(name, a, b, "a and b")
    if x_b is not None and a is not None:
        raise ValueError("conv3x3: the pre-affine is not taken with a second input")
    if _routed and not stats:
        return torch.ops.imgseg.conv3x3(x, w, bias, x_b, a, b)
    if _on_cpu(x):
        return conv3x3_plain(x, w, bias, x_b=x_b, a=a, b=b, stats=stats)
    _check_cuda_operands(name, x, w, bias, x_b, a, b)
    _check_activation(name, x, "x")
    bsz, h, wd, ca = x.shape
    cb = 0
    if x_b is not None:
        cb = x_b.shape[-1]
        _check_activation(name, x_b, "x_b", (bsz, h, wd, cb))
    co = w.shape[0]
    if w.shape != (co, ca + cb, 3, 3):
        raise ValueError(f"{name}: w must be ({co}, {ca + cb}, 3, 3), got {tuple(w.shape)}")
    _check_vector(name, bias, co, "bias")
    ab = None
    if a is not None:
        _check_vector(name, a, ca, "a")
        _check_vector(name, b, ca, "b")
        ab = _ab(a, b, x.dtype)
    path, arg = _path_arg(ca, cb, co, co, x, x_b)
    if path == "vector":
        wk = vector_pack(w)
    else:
        wk = w.to(torch.bfloat16).permute(2, 3, 1, 0)  # (3, 3, Cin, Co)
        wk = deep_pack(wk, arg) if path == "deep" else wk.contiguous()
    out = torch.empty((bsz, h, wd, co), dtype=x.dtype, device=x.device)
    sums = scratch = None
    if stats:
        sums = torch.empty((2, co), dtype=torch.float32, device=x.device)
        scratch = _scratch("imgseg_conv3x3_scratch", x, bsz, h, wd, co)
    _launch(conv3x3, "imgseg_conv3x3", _ptr(x), _ptr(x_b), _ptr(wk),
            _ptr(bias.float().contiguous()), _ptr(ab), _ptr(out), _ptr(sums), _ptr(scratch),
            bsz, h, wd, ca, cb, co, arg)
    conv3x3.deep_launches += path == "deep"
    return (out, sums[0], sums[1]) if stats else out


def conv3x3_dgrad(
    g: torch.Tensor,
    y: Optional[torch.Tensor],
    w: torch.Tensor,
    c1: Optional[torch.Tensor],
    c2: Optional[torch.Tensor],
    *,
    a: Optional[torch.Tensor] = None,
    b: Optional[torch.Tensor] = None,
    x_post: Optional[torch.Tensor] = None,
    a_post: Optional[torch.Tensor] = None,
    b_post: Optional[torch.Tensor] = None,
    split: Optional[int] = None,
):
    """Input gradient of the 3x3 SAME conv ``y = conv3x3(x, w, ...)`` of a
    BatchNorm'd block (the dx half of ``_bwd_fused_kernel_body`` :938).

    g, y (B,H,W,Co): the cotangent and the conv's output.  The kernel reads
    the transformed cotangent ``ge = round(g + c1 + 2*y*c2)``, or with the
    bn affine ``a, b`` (Co,) ``ge = round(g*a*[y*a + b > 0] + c1 + 2*y*c2)``
    (``_gfold_transform`` :249; ``a, b`` rounded to the activation dtype,
    c1, c2 (Co,) fp32), zero outside the image AFTER the transform.  With
    ``y``, ``c1`` and ``c2`` None, ``ge = g`` (no transform, y unread: the
    dx of ``make_folded_conv3x3`` :2005; neither post nor split).
    ``dx = round(conv of ge with the flipped, transposed w)``; w (Co, Cin,
    3, 3) as in :func:`conv3x3`.

    ``x_post`` (B,H,W,Cin) with ``a_post, b_post`` (Cin,): the conv's input
    was ``relu(x_post*a + b)``; return ``(round(gu*a), sum gu*x_post, sum
    gu)`` with ``gu = dx_acc * [x_post*a + b > 0]`` (the ``post`` epilogue
    :1033-1048).  ``split`` = Ca: return dx as ``(dx[..., :Ca],
    dx[..., Ca:])`` (``split_out`` :1049-1053).
    """
    name = "conv3x3_dgrad"
    _check_pair(name, a, b, "a and b")
    _check_pair(name, a_post, b_post, "a_post and b_post")
    if (x_post is None) != (a_post is None):
        raise ValueError(f"{name}: x_post comes with a_post and b_post")
    if x_post is not None and split is not None:
        raise ValueError(f"{name}: post and split do not go together")
    if not _check_transform(name, y, c1, c2, a, b) and (x_post is not None or split is not None):
        raise ValueError(f"{name}: the raw cotangent takes neither post nor split")
    if _on_cpu(g):
        return conv3x3_dgrad_plain(g, y, w, c1, c2, a=a, b=b, x_post=x_post,
                                   a_post=a_post, b_post=b_post, split=split)
    _check_cuda_operands(name, g, y, w, c1, c2, a, b, x_post, a_post, b_post)
    _check_activation(name, g, "g")
    bsz, h, wd, co = g.shape
    if y is not None:
        _check_activation(name, y, "y", g.shape)
    cin = w.shape[1]
    if w.shape != (co, cin, 3, 3):
        raise ValueError(f"{name}: w must be ({co}, Cin, 3, 3), got {tuple(w.shape)}")
    for t, what in ((c1, "c1"), (c2, "c2"), (a, "a"), (b, "b")):
        if t is not None:
            _check_vector(name, t, co, what)
    gf = _gf(c1, c2, a, b, g.dtype)
    ca = cin if split is None else split
    path, arg = _path_arg(ca, cin - ca, co, cin, g, y, x_post)
    if path == "vector":
        wk = vector_pack(w, dgrad=True)
    else:  # the flipped, transposed kernel in conv3x3's (3, 3, Cin', Co') layout
        wk = w.to(torch.bfloat16).flip(2, 3).permute(2, 3, 0, 1)
        wk = deep_pack(wk, arg) if path == "deep" else wk.contiguous()
    ab_post = sums = scratch = out_b = None
    na = cin
    if x_post is not None:
        _check_activation(name, x_post, "x_post", (bsz, h, wd, cin))
        _check_vector(name, a_post, cin, "a_post")
        _check_vector(name, b_post, cin, "b_post")
        ab_post = _ab(a_post, b_post, g.dtype)
        sums = torch.empty((2, cin), dtype=torch.float32, device=g.device)
        scratch = _scratch("imgseg_conv3x3_scratch", g, bsz, h, wd, cin)
    if split is not None:
        if not 0 < split < cin:
            raise ValueError(f"{name}: split {split} must lie in (0, {cin})")
        na = split
        out_b = torch.empty((bsz, h, wd, cin - na), dtype=g.dtype, device=g.device)
    out = torch.empty((bsz, h, wd, na), dtype=g.dtype, device=g.device)
    _launch(conv3x3_dgrad, "imgseg_conv3x3_dgrad", _ptr(g), _ptr(y), _ptr(gf), _ptr(wk),
            _ptr(x_post), _ptr(ab_post), _ptr(out), _ptr(out_b), _ptr(sums), _ptr(scratch),
            bsz, h, wd, co, cin, na, int(a is not None), arg)
    conv3x3_dgrad.deep_launches += path == "deep"
    if x_post is not None:
        return out, sums[0], sums[1]
    return (out, out_b) if split is not None else out


def conv3x3_wgrad(
    g: torch.Tensor,
    y: Optional[torch.Tensor],
    x: torch.Tensor,
    c1: Optional[torch.Tensor],
    c2: Optional[torch.Tensor],
    *,
    a: Optional[torch.Tensor] = None,
    b: Optional[torch.Tensor] = None,
    x_b: Optional[torch.Tensor] = None,
    a_pre: Optional[torch.Tensor] = None,
    b_pre: Optional[torch.Tensor] = None,
):
    """Weight and bias gradient of the 3x3 SAME conv of a BatchNorm'd block
    (the wgrad half of ``_bwd_fused_kernel_body`` :1057-1109).

    g, y, c1, c2, a, b: the transformed cotangent ``ge`` as in
    :func:`conv3x3_dgrad` (``ge = g`` with y, c1, c2 None: the dw and db of
    ``make_folded_conv3x3``, ``_folded_wgrad_pallas`` :822).  x (B,H,W,Ca) [with x_b (B,H,W,Cb)] or with
    ``a_pre, b_pre`` (Ca,): the conv's operand as :func:`conv3x3` read it.
    Returns fp32 ``dw`` (Co, Ca+Cb, 3, 3) = sum over pixels of
    ``act(x)[p + tap] * ge[p]`` and ``db`` (Co,) = sum ``ge``.
    """
    name = "conv3x3_wgrad"
    _check_pair(name, a, b, "a and b")
    _check_pair(name, a_pre, b_pre, "a_pre and b_pre")
    _check_transform(name, y, c1, c2, a, b)
    if x_b is not None and a_pre is not None:
        raise ValueError(f"{name}: the pre-affine is not taken with a second input")
    if _on_cpu(g):
        return conv3x3_wgrad_plain(g, y, x, c1, c2, a=a, b=b, x_b=x_b,
                                   a_pre=a_pre, b_pre=b_pre)
    _check_cuda_operands(name, g, y, x, c1, c2, a, b, x_b, a_pre, b_pre)
    _check_activation(name, g, "g")
    bsz, h, wd, co = g.shape
    if y is not None:
        _check_activation(name, y, "y", g.shape)
    ca = x.shape[-1]
    _check_activation(name, x, "x", (bsz, h, wd, ca))
    cb = 0
    if x_b is not None:
        cb = x_b.shape[-1]
        _check_activation(name, x_b, "x_b", (bsz, h, wd, cb))
    for t, what in ((c1, "c1"), (c2, "c2"), (a, "a"), (b, "b")):
        if t is not None:
            _check_vector(name, t, co, what)
    ab = None
    if a_pre is not None:
        _check_vector(name, a_pre, ca, "a_pre")
        _check_vector(name, b_pre, ca, "b_pre")
        ab = _ab(a_pre, b_pre, g.dtype)
    gf = _gf(c1, c2, a, b, g.dtype)
    cin = ca + cb
    dw = torch.empty((9, cin, co), dtype=torch.float32, device=g.device)
    db = torch.empty((co,), dtype=torch.float32, device=g.device)
    path, arg = _path_arg(ca, cb, co, co, g, y, x, x_b)
    deep = int(path == "deep")
    scratch = _scratch("imgseg_conv3x3_wgrad_scratch", g, bsz, h, wd, cin, co, deep)
    _launch(conv3x3_wgrad, "imgseg_conv3x3_wgrad", _ptr(g), _ptr(y), _ptr(gf), _ptr(x),
            _ptr(x_b), _ptr(ab), _ptr(dw), _ptr(db), _ptr(scratch),
            bsz, h, wd, ca, cb, co, int(a is not None), arg)
    conv3x3_wgrad.deep_launches += deep
    return dw.view(3, 3, cin, co).permute(3, 2, 0, 1).contiguous(), db


def last_path(wrapper) -> str:
    """``"vector"``, ``"narrow"`` or ``"deep"``: the path that the latest
    kernel launch of :func:`conv3x3` and :func:`conv3x3_dgrad` (one kernel),
    or of :func:`conv3x3_wgrad`, took (:func:`conv_path`)."""
    from ._build import library

    query = {conv3x3: "imgseg_conv3x3_path", conv3x3_dgrad: "imgseg_conv3x3_path",
             conv3x3_wgrad: "imgseg_conv3x3_wgrad_path"}[wrapper]
    return ("vector", "narrow", "deep")[getattr(library(), query)()]


def bn_relu_bwd_reduce(
    g: torch.Tensor, y: torch.Tensor, a: torch.Tensor, b: torch.Tensor
):
    """Per-channel fp32 ``(sum P*y, sum P)`` with ``P = g*[y*a + b > 0]``:
    the affine cotangent of ``z = relu(y*a + b)`` (``_bnred_kernel_body``
    :1439).  g, y (B,H,W,C); a, b (C,), rounded to the activation dtype and
    held in fp32 (pallas_conv.py:2389-2391).  On the card: g, y bf16 and
    16-byte aligned, a, b fp32 and contiguous (the kernel rounds them), one
    launch that sums across its blocks in a fixed order."""
    name = "bn_relu_bwd_reduce"
    if _on_cpu(y):
        return bn_relu_bwd_reduce_plain(g, y, a, b)
    _check_cuda_operands(name, y, g, a, b)
    _check_activation(name, y, "y")
    _check_activation(name, g, "g", y.shape)
    bsz, h, wd, c = y.shape
    _check_fp32_vector(name, a, c, "a")
    _check_fp32_vector(name, b, c, "b")
    sums = _sums_buffer(y, "imgseg_bn_relu_bwd_reduce_floats", c)
    _launch(bn_relu_bwd_reduce, "imgseg_bn_relu_bwd_reduce", _ptr(g), _ptr(y), _ptr(a), _ptr(b),
            _ptr(sums), bsz, h, wd, c)
    return sums[:c], sums[c:2 * c]


def maxpool2x2_affine_relu(
    z: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """2x2/2 max-pool of ``relu(z*a + b)``: z (B,H,W,C) is a block's raw
    second-conv output and ``a, b`` (C,) its bn2 affine, rounded to the
    activation dtype and applied in fp32 (``_ab_lanes``, folded.py:477-482).
    Output (B,H//2,W//2,C), rounded to z's dtype."""
    if _routed:
        return torch.ops.imgseg.maxpool2x2_affine_relu(z, a, b)
    if _on_cpu(z):
        return maxpool2x2_affine_relu_plain(z, a, b)
    name = "maxpool2x2_affine_relu"
    _check_cuda_operands(name, z, a, b)
    _check_activation(name, z, "z")
    bsz, h, wd, c = z.shape
    _check_vector(name, a, c, "a")
    _check_vector(name, b, c, "b")
    out = torch.empty((bsz, h // 2, wd // 2, c), dtype=z.dtype, device=z.device)
    _launch(maxpool2x2_affine_relu, "imgseg_maxpool2x2_affine_relu", _ptr(z),
            _ptr(_ab(a, b, z.dtype)), _ptr(out), bsz, h, wd, c)
    return out


def maxpool2x2_affine_relu_bwd(
    z: torch.Tensor, a: torch.Tensor, b: torch.Tensor, dp: torch.Tensor
):
    """Backward of :func:`maxpool2x2_affine_relu` (``_pool_bwd_kernel_body``
    :1540): each window's cotangent dp (B,H/2,W/2,C) goes to the window's
    FIRST maximum in row-major order of the fp32 ``relu(z*a + b)``; with
    ``P = routed*[z*a + b > 0]`` it returns ``(round(P*a), sum P*z, sum P)``.
    H and W must be even.  On the card: z, dp bf16 and 16-byte aligned, a, b
    fp32 and contiguous (the kernel rounds them), one launch that sums
    across its blocks in a fixed order."""
    name = "maxpool2x2_affine_relu_bwd"
    bsz, h, wd, c = z.shape
    if h % 2 or wd % 2:
        raise ValueError(f"{name}: H and W must be even, got {h}x{wd}")
    if _on_cpu(z):
        return maxpool2x2_affine_relu_bwd_plain(z, a, b, dp)
    _check_cuda_operands(name, z, a, b, dp)
    _check_activation(name, z, "z")
    _check_activation(name, dp, "dp", (bsz, h // 2, wd // 2, c))
    _check_fp32_vector(name, a, c, "a")
    _check_fp32_vector(name, b, c, "b")
    dz = torch.empty_like(z)
    sums = _sums_buffer(z, "imgseg_maxpool2x2_affine_relu_bwd_floats", wd, c, bsz * (h // 2))
    _launch(maxpool2x2_affine_relu_bwd, "imgseg_maxpool2x2_affine_relu_bwd", _ptr(z), _ptr(a),
            _ptr(b), _ptr(dp), _ptr(dz), _ptr(sums), bsz, h, wd, c)
    return dz, sums[:c], sums[c:2 * c]


def convtranspose2x2(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """ConvTranspose(k=2, s=2): x (B,Hin,Win,Cin), w the torch
    ``ConvTranspose2d`` weight (Cin, Co, 2, 2) — flax's flip is undone by
    ``utils.convert.state_dict_from_jax`` — and bias (Co,).
    ``y[b, 2i+dy, 2j+dx, o] = round(bias[o] + sum_c x[b,i,j,c] w[c,o,dy,dx])``."""
    if _routed:
        return torch.ops.imgseg.convtranspose2x2(x, w, bias)
    if _on_cpu(x):
        return convtranspose2x2_plain(x, w, bias)
    name = "convtranspose2x2"
    _check_cuda_operands(name, x, w, bias)
    _check_activation(name, x, "x")
    bsz, h, wd, ci = x.shape
    co = w.shape[1]
    if w.shape != (ci, co, 2, 2):
        raise ValueError(f"{name}: w must be ({ci}, {co}, 2, 2), got {tuple(w.shape)}")
    _check_vector(name, bias, co, "bias")
    wk = w.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()  # (Cin, 2, 2, Co)
    out = torch.empty((bsz, 2 * h, 2 * wd, co), dtype=x.dtype, device=x.device)
    _launch(convtranspose2x2, "imgseg_convtranspose2x2", _ptr(x), _ptr(wk),
            _ptr(bias.float().contiguous()), _ptr(out), bsz, h, wd, ci, co)
    return out


def convtranspose2x2_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """Backward of :func:`convtranspose2x2` (``_ct_bwd_kernel_body`` :1761):
    ``dx[b,i,j,c] = round(sum_{dy,dx,o} g[b,2i+dy,2j+dx,o] w[c,o,dy,dx])``
    and the fp32 sums over (b, i, j) ``dw`` (Cin, Co, 2, 2) and ``dbias``
    (Co,).  The kernel holds dw's 4*Co columns in one block: Co <= 64."""
    if _on_cpu(x):
        return convtranspose2x2_bwd_plain(x, w, g)
    name = "convtranspose2x2_bwd"
    _check_cuda_operands(name, x, w, g)
    _check_activation(name, x, "x")
    bsz, h, wd, ci = x.shape
    co = w.shape[1]
    if w.shape != (ci, co, 2, 2):
        raise ValueError(f"{name}: w must be ({ci}, {co}, 2, 2), got {tuple(w.shape)}")
    if co > 64:
        raise ValueError(f"{name}: the kernel takes Co <= 64, got {co}")
    _check_activation(name, g, "g", (bsz, 2 * h, 2 * wd, co))
    wk = w.to(torch.bfloat16).permute(2, 3, 1, 0).contiguous()  # (2, 2, Co, Cin)
    dx = torch.empty_like(x)
    dw = torch.empty((ci, 4 * co), dtype=torch.float32, device=x.device)
    db = torch.empty((4 * co,), dtype=torch.float32, device=x.device)
    scratch = _scratch("imgseg_convtranspose2x2_bwd_scratch", x, bsz, h, wd, ci, co)
    _launch(convtranspose2x2_bwd, "imgseg_convtranspose2x2_bwd", _ptr(x), _ptr(wk),
            _ptr(g), _ptr(dx), _ptr(dw), _ptr(db), _ptr(scratch), bsz, h, wd, ci, co)
    # dw columns are (dy, dx, o); db is per (dy, dx, o), summed over the taps
    return dx, dw.view(ci, 2, 2, co).permute(0, 3, 1, 2).contiguous(), db.view(4, co).sum(0)


WRAPPERS = (conv3x3, conv3x3_dgrad, conv3x3_wgrad, bn_relu_bwd_reduce,
            maxpool2x2_affine_relu, maxpool2x2_affine_relu_bwd,
            convtranspose2x2, convtranspose2x2_bwd)
for _w in WRAPPERS:
    _w.launches = 0
# the conv wrappers' launches on the deep path (conv_path), within .launches
CONV_WRAPPERS = (conv3x3, conv3x3_dgrad, conv3x3_wgrad)
for _w in CONV_WRAPPERS:
    _w.deep_launches = 0


# --------------------------------------------------------------------------
# registered operators: the eval forward's kernels as graph nodes
# --------------------------------------------------------------------------
#
# ``torch.export`` cannot trace through a ctypes launch, so inside
# :func:`operators` the eval forward's three wrappers call the operators
# ``imgseg::conv3x3`` (any eval form: the [x | x_b] pair or the pre-affine,
# the ClipRes narrow path included), ``imgseg::maxpool2x2_affine_relu`` and
# ``imgseg::convtranspose2x2`` instead, and an exported program holds those
# nodes (``engine/export.export_program``).  Each operator's implementation
# is its wrapper: on a CPU tensor the plain version, on a CUDA tensor the
# kernel (counted in the wrapper's ``launches``); its fake implementation
# gives the output's shape and dtype.  Outside :func:`operators` (the eager
# forward) the wrappers launch directly, with no dispatcher in between.

_routed = False


@contextmanager
def operators():
    """Route the eval forward's wrappers through the ``imgseg::``
    operators while the block runs (for ``torch.export``)."""
    global _routed
    before, _routed = _routed, True
    try:
        yield
    finally:
        _routed = before


@contextmanager
def _direct():
    global _routed
    before, _routed = _routed, False
    try:
        yield
    finally:
        _routed = before


@torch.library.custom_op("imgseg::conv3x3", mutates_args=())
def conv3x3_op(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               x_b: Optional[torch.Tensor], a: Optional[torch.Tensor],
               b: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`conv3x3` in an eval form, as an operator."""
    with _direct():
        return conv3x3(x, w, bias, x_b=x_b, a=a, b=b)


@conv3x3_op.register_fake
def _(x, w, bias, x_b, a, b):
    return x.new_empty(tuple(x.shape[:3]) + (w.shape[0],))


@torch.library.custom_op("imgseg::maxpool2x2_affine_relu", mutates_args=())
def maxpool2x2_affine_relu_op(z: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`maxpool2x2_affine_relu` as an operator."""
    with _direct():
        return maxpool2x2_affine_relu(z, a, b)


@maxpool2x2_affine_relu_op.register_fake
def _(z, a, b):
    return z.new_empty((z.shape[0], z.shape[1] // 2, z.shape[2] // 2, z.shape[3]))


@torch.library.custom_op("imgseg::convtranspose2x2", mutates_args=())
def convtranspose2x2_op(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """:func:`convtranspose2x2` as an operator."""
    with _direct():
        return convtranspose2x2(x, w, bias)


@convtranspose2x2_op.register_fake
def _(x, w, bias):
    return x.new_empty((x.shape[0], 2 * x.shape[1], 2 * x.shape[2], w.shape[1]))



# --------------------------------------------------------------------------
# autograd Functions
# --------------------------------------------------------------------------

def bn_scalars(S, Q, scale, bias, n: int, eps: float):
    """Batch statistics -> the BN affine, flax's semantics (pallas_conv.py
    :2307): biased ``var = max(0, E[y^2] - mean^2)``, ``y*a + b`` with
    ``a = rsqrt(var + eps)*scale``, ``b = bias - mean*a``.
    Returns ``(a, b, mean, var)``."""
    mean = S / n
    var = torch.clamp(Q / n - mean * mean, min=0.0)
    a = torch.rsqrt(var + eps) * scale
    return a, bias - mean * a, mean, var


def _bn_scalars_vjp(S, Q, scale, bias, n, eps, cts):
    """Cotangents of ``(S, Q, scale, bias)`` from those of
    :func:`bn_scalars`' outputs, by autograd on the (C,) vectors (as JAX
    differentiates the same chain with ``jax.vjp``)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (S, Q, scale, bias)]
        return torch.autograd.grad(bn_scalars(*ins, n, eps), ins, cts)


def _global_stats(y, S, Q):
    """``(y, S, Q)`` with the statistics summed over ranks (the global
    batch's, ``parallel.mesh``); unchanged at world size 1."""
    if not mesh.active():
        return y, S, Q
    sq = mesh.reduce_sum_(torch.stack([S, Q]))
    return y, sq[0], sq[1]


def _global_cotangents(dS, dQ):
    """The cotangents of the global ``(S, Q)``, summed over ranks: each
    rank's local sums feed the one global sum, so each takes the whole
    cotangent.  ``dscale``/``dbias`` stay local (they are averaged with
    the other gradients); summing ``da, db`` before the VJP instead would
    make them R times too large."""
    if not mesh.active():
        return dS, dQ
    sq = mesh.reduce_sum_(torch.stack([dS, dQ]))
    return sq[0], sq[1]


class FusedBlockFunction(torch.autograd.Function):
    """The training-mode [Conv3x3-BN-ReLU] x2 block as ONE autograd node,
    mirroring ``make_folded_block`` (pallas_conv.py:2227).

    ``apply(x, x_b, w1, c1b, w2, c2b, scale1, bias1, scale2, bias2, raw_out,
    eps, input_grad, shard1, shard2) -> (z, mean1, var1, mean2, var2)``.
    Forward: conv1
    with the stats epilogue, bn1's affine from (S1, Q1), conv2 with bn1 +
    ReLU on load and its own stats, bn2's affine; ``z = round(relu(y2*a2 +
    b2))`` in fp32 with ``a2, b2`` rounded to the activation dtype, or with
    ``raw_out`` ``z = y2`` for a consumer that applies bn2 itself.  The
    backward follows ``block_bwd`` :2368-2526: the bn2 reduction (without
    ``raw_out``), the per-channel scalar chain by autograd, conv2's dgrad
    with bn1's ReLU adjoint and wgrad, then conv1's (dx split into [x |
    x_b]).  With ``input_grad=False`` conv1 gets its wgrad alone, no dgrad,
    and the block input no gradient (``None``), as ``make_folded_block(
    input_grad=False)`` runs ``_folded_wgrad_pallas`` alone (:2465-2481);
    the caller guarantees the input needs none (``models/fused.py`` raises
    otherwise).

    Several ranks (``parallel.mesh``): the statistics are the global
    batch's.  The forward sums ``(S1, Q1)`` and ``(S2, Q2)`` over the data
    group (and counts every data row's pixels in ``n``) before each affine;
    the backward sums the ``(dS, dQ)`` that the scalar chain's VJP returns
    over the data group before the dgrad and wgrad kernels consume them.
    At world size 1 no collective runs.

    Tensor parallelism (``shard1``/``shard2``, the :class:`~..parallel.
    tensor.Shard` of w1/w2, or None): a sharded conv runs on its ``Co/M``
    slice of w (the weight given IS the slice), of its bias and of its
    BatchNorm's scale and bias (given whole), and its statistics and affine
    are the slice's.  Conv1's slice ``y1`` and ``(a1, b1)`` are gathered
    over the model group for conv2, which reads every input channel.  The
    outputs of a sharded conv2 (``z``, ``mean2``, ``var2``) and a sharded
    conv1's ``mean1``, ``var1`` are the slices; the caller gathers them.
    In the backward, conv2's dgrad with the bn1-ReLU adjoint and its
    ``(da1, db1)`` epilogue is linear in the cotangent, so with conv2
    sharded each rank's ``gy1, da1, db1`` are partials over its output
    channels: summed over the model group, and reduced to conv1's slice
    when conv1 is sharded (a reduce-scatter); conv1's input gradient is a
    partial the same way and is summed.  The wgrads stay local (they are
    the slices' gradients), and the gradients of the whole per-channel
    vectors (conv biases, BatchNorm scales and biases) are gathered, so
    every model rank applies the same update.
    """

    @staticmethod
    def forward(ctx, x, x_b, w1, c1b, w2, c2b, scale1, bias1, scale2, bias2, raw_out, eps,
                input_grad=True, shard1=None, shard2=None):
        dt = x.dtype
        n = x.shape[0] * x.shape[1] * x.shape[2] * (mesh.data_size() if mesh.active() else 1)
        c1b, scale1, bias1 = (tp.take(t, shard1) for t in (c1b, scale1, bias1))
        c2b, scale2, bias2 = (tp.take(t, shard2) for t in (c2b, scale2, bias2))
        y1l, s1, q1 = _global_stats(*conv3x3(x, w1, c1b, x_b=x_b, stats=True))
        a1, b1, mean1, var1 = bn_scalars(s1, q1, scale1, bias1, n, eps)
        y1 = y1l
        if shard1 is not None:  # conv2 reads every channel of bn1's output
            y1, a1, b1 = tp.gather(y1l), tp.gather(a1), tp.gather(b1)
        y2, s2, q2 = _global_stats(*conv3x3(y1, w2, c2b, a=a1, b=b1, stats=True))
        a2, b2, mean2, var2 = bn_scalars(s2, q2, scale2, bias2, n, eps)
        if raw_out:
            z = y2
        else:
            z = F.relu(wide(y2) * _round(a2, dt) + _round(b2, dt)).to(dt)
        ctx.save_for_backward(x, x_b, y1l, y1, y2, w1, w2, s1, q1, s2, q2,
                              scale1, bias1, scale2, bias2, a1, b1, a2, b2)
        ctx.raw_out, ctx.eps, ctx.n, ctx.input_grad = raw_out, eps, n, input_grad
        ctx.shards = shard1, shard2
        return z, mean1, var1, mean2, var2

    @staticmethod
    def backward(ctx, dz, dmean1, dvar1, dmean2, dvar2):
        (x, x_b, y1l, y1, y2, w1, w2, s1, q1, s2, q2,
         scale1, bias1, scale2, bias2, a1, b1, a2, b2) = ctx.saved_tensors
        n, eps = ctx.n, ctx.eps
        shard1, shard2 = ctx.shards

        def ct(t, like):
            return torch.zeros_like(like) if t is None else t

        def whole(t, s):  # a per-channel vector's gradient, on every model rank
            return t if s is None else tp.gather(t)

        dz = torch.zeros_like(y2) if dz is None else dz.contiguous()
        aff = {}
        if ctx.raw_out:
            # bn2's affine + ReLU adjoint ran in the consumer's backward:
            # dz is the cotangent of raw y2, bn2 gets mean2/var2 cotangents.
            da2 = db2 = torch.zeros_like(s2)
        else:
            da2, db2 = bn_relu_bwd_reduce(dz, y2, a2, b2)
            aff = dict(a=a2, b=b2)
        ds2, dq2, dscale2, dbias2 = _bn_scalars_vjp(
            s2, q2, scale2, bias2, n, eps, (da2, db2, ct(dmean2, s2), ct(dvar2, s2)))
        ds2, dq2 = _global_cotangents(ds2, dq2)
        gy1, da1, db1 = conv3x3_dgrad(dz, y2, w2, ds2, dq2, **aff,
                                      x_post=y1, a_post=a1, b_post=b1)
        if shard2 is not None or shard1 is not None:
            gy1, da1, db1 = _to_conv1(gy1, da1, db1, shard1, shard2)
        dw2, dc2b = conv3x3_wgrad(dz, y2, y1, ds2, dq2, **aff, a_pre=a1, b_pre=b1)
        ds1, dq1, dscale1, dbias1 = _bn_scalars_vjp(
            s1, q1, scale1, bias1, n, eps, (da1, db1, ct(dmean1, s1), ct(dvar1, s1)))
        ds1, dq1 = _global_cotangents(ds1, dq1)
        dx = dxb = None  # input_grad=False: conv1's wgrad alone
        if ctx.input_grad and x_b is None:
            dx = conv3x3_dgrad(gy1, y1l, w1, ds1, dq1)
        elif ctx.input_grad:
            dx, dxb = conv3x3_dgrad(gy1, y1l, w1, ds1, dq1, split=x.shape[-1])
        if shard1 is not None and dx is not None:  # partials over conv1's output channels
            dx = tp.all_reduce(dx)
            dxb = None if dxb is None else tp.all_reduce(dxb)
        dw1, dc1b = conv3x3_wgrad(gy1, y1l, x, ds1, dq1, x_b=x_b)
        return (dx, dxb, dw1, whole(dc1b, shard1), dw2, whole(dc2b, shard2),
                whole(dscale1, shard1), whole(dbias1, shard1), whole(dscale2, shard2),
                whole(dbias2, shard2), None, None, None, None, None)


def _to_conv1(gy1, da1, db1, shard1, shard2):
    """conv2's dgrad outputs (every channel of conv1's output) -> conv1's
    part of them: summed over the model group when conv2 is sharded (each
    rank's is a partial), then conv1's slice when conv1 is."""
    ab = torch.stack([da1, db1])
    if shard2 is None:  # whole on every rank: the slice
        gy1 = gy1.narrow(-1, shard1.offset, shard1.local).contiguous()
        ab = ab.narrow(-1, shard1.offset, shard1.local)
    elif shard1 is None:
        gy1, ab = tp.all_reduce(gy1), tp.all_reduce(ab)
    else:
        gy1, ab = tp.reduce_scatter(gy1), tp.reduce_scatter(ab)
    return gy1, ab[0], ab[1]


class Conv3x3Function(torch.autograd.Function):
    """One 3x3 SAME conv with bias and nothing fused into it, mirroring
    ``make_folded_conv3x3`` (pallas_conv.py:1932-2029): ``apply(x, w, bias)
    -> y``.  The forward is :func:`conv3x3` in its plain form; the backward
    runs :func:`conv3x3_dgrad` on the raw cotangent (skipped when x needs no
    gradient) and :func:`conv3x3_wgrad` for dw and db."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        return conv3x3(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = conv3x3_dgrad(g, None, w, None, None) if ctx.needs_input_grad[0] else None
        dw, db = conv3x3_wgrad(g, None, x, None, None)
        return dx, dw, db


class PoolFunction(torch.autograd.Function):
    """``maxpool2x2_affine_relu`` with its backward kernel, mirroring
    ``pool_ab`` (pallas_conv.py:1714-1728): ``apply(z, a, b) -> p``, and
    the backward returns ``(dz, da, db)``."""

    @staticmethod
    def forward(ctx, z, a, b):
        ctx.save_for_backward(z, a, b)
        return maxpool2x2_affine_relu(z, a, b)

    @staticmethod
    def backward(ctx, dp):
        z, a, b = ctx.saved_tensors
        return maxpool2x2_affine_relu_bwd(z, a, b, dp.contiguous())


class ConvTransposeFunction(torch.autograd.Function):
    """``convtranspose2x2`` with its backward kernel, mirroring ``ct``
    (pallas_conv.py:1878-1927): ``apply(x, w, bias) -> y``."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        return convtranspose2x2(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return convtranspose2x2_bwd(x, w, g.contiguous())
