"""The three kernels of the serving path, each a wrapper beside its plain
PyTorch version; counterpart of ``image_segmentation_tpu/ops/pallas_conv.py``.

- :func:`conv3x3` (``csrc/conv3x3.cu``) replaces ``_folded_conv_pallas``
  :568 in the eval form ``make_folded_conv_bn3x3`` :2033 reaches;
- :func:`maxpool2x2_affine_relu` (``csrc/pool.cu``) replaces
  ``make_folded_pool`` :1608, ``_fwd_pallas`` :1629 with ``with_ab=True``;
- :func:`convtranspose2x2` (``csrc/convtranspose.cu``) replaces
  ``make_folded_convtranspose2x2`` :1795, ``_fwd_pallas`` :1852.

The JAX kernels work on width-folded tensors to fill the TPU's 128 lanes;
at fold 1 they compute the plain NHWC ops, and that is what is ported.

Dispatch is by the device of the input: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (bf16 in and out, fp32 sums) and
raises if the build or the launch fails.  Any other device raises.  Each
wrapper counts its kernel launches in ``<wrapper>.launches``.  The kernels
are forward-only: on a CUDA tensor, an input that requires grad while grad
mode is on raises.

The plain versions compute in fp32 from the same operands the kernels see
(weights and pre-affine rounded to the activation dtype, bias in fp32) and
round the result to the activation dtype, so on the card they are the
reference for the kernels, and in fp32 on the CPU they are the JAX
kernels' math.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build


def _round(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``v`` rounded to ``dtype`` and held in fp32."""
    return v.to(dtype).float()


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def conv3x3_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    *,
    x_b: Optional[torch.Tensor] = None,
    a: Optional[torch.Tensor] = None,
    b: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """3x3 SAME conv of ``act([x | x_b])``; see :func:`conv3x3`."""
    dt = x.dtype
    xin = x if x_b is None else torch.cat([x, x_b.to(dt)], dim=-1)
    xf = xin.float()
    if a is not None:
        # SAME padding pads the ACTIVATED tensor with zeros (pallas_conv.py
        # _build_aug :288-290), which F.conv2d's zero padding does.
        xf = F.relu(xf * _round(a, dt) + _round(b, dt)).to(dt).float()
    y = F.conv2d(xf.permute(0, 3, 1, 2), _round(w, dt), bias.float(), padding=1)
    return y.permute(0, 2, 3, 1).to(dt)


def maxpool2x2_affine_relu_plain(
    z: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """2x2/2 max-pool of ``relu(z*a + b)``; see :func:`maxpool2x2_affine_relu`."""
    dt = z.dtype
    u = F.relu(z.float() * _round(a, dt) + _round(b, dt))
    return F.max_pool2d(u.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).to(dt)


def convtranspose2x2_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """ConvTranspose(k=2, s=2); see :func:`convtranspose2x2`."""
    dt = x.dtype
    y = F.conv_transpose2d(
        x.float().permute(0, 3, 1, 2), _round(w, dt), bias.float(), stride=2
    )
    return y.permute(0, 2, 3, 1).to(dt)


# --------------------------------------------------------------------------
# checks shared by the wrappers
# --------------------------------------------------------------------------

def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}: expected cpu or cuda")
    return False


def _check_cuda_operands(name: str, x: torch.Tensor, *others) -> None:
    tensors = [x, *(t for t in others if t is not None)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel is forward-only; call it under "
            "torch.no_grad() or torch.inference_mode()"
        )
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and {x.device}")


def _check_activation(name: str, t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: {what} must be bfloat16, got {t.dtype}")
    if t.dim() != 4:
        raise ValueError(f"{name}: {what} must be NHWC, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _check_vector(name: str, t: torch.Tensor, n: int, what: str) -> None:
    if t.shape != (n,):
        raise ValueError(f"{name}: {what} must have shape ({n},), got {tuple(t.shape)}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ab(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(2, C) fp32 pre-affine rows [a, b], rounded to ``dtype``."""
    return torch.stack([_round(a, dtype), _round(b, dtype)]).contiguous()


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
) -> torch.Tensor:
    """3x3 SAME conv with optional BN-affine + ReLU on load.

    x (B,H,W,Ca) and optional x_b (B,H,W,Cb): the input is the channel
    concat ``[x | x_b]`` (the decoder's [up | skip]).  w is the torch
    layout (Co, Ca+Cb, 3, 3), bias (Co,).  ``a, b`` (Ca,), only without
    ``x_b`` (pallas_conv.py:2097): the conv reads ``act(t) =
    round(max(t*a + b, 0))`` with ``a, b`` rounded to the activation dtype
    first (``_ab_pre`` :2103-2105); positions outside the image are zero
    after activation.  Output (B,H,W,Co) = round(bias + sum), fp32 sum.
    """
    if (a is None) != (b is None):
        raise ValueError("conv3x3: pass both a and b, or neither")
    if x_b is not None and a is not None:
        raise ValueError("conv3x3: the pre-affine is not taken with a second input")
    if _on_cpu(x):
        return conv3x3_plain(x, w, bias, x_b=x_b, a=a, b=b)
    name = "conv3x3"
    _check_cuda_operands(name, x, w, bias, x_b, a, b)
    _check_activation(name, x, "x")
    bsz, h, wd, ca = x.shape
    cb = 0
    if x_b is not None:
        _check_activation(name, x_b, "x_b")
        if x_b.shape[:3] != x.shape[:3]:
            raise ValueError(f"{name}: x {tuple(x.shape)} and x_b {tuple(x_b.shape)}")
        cb = x_b.shape[-1]
    co = w.shape[0]
    if w.shape != (co, ca + cb, 3, 3):
        raise ValueError(f"{name}: w must be ({co}, {ca + cb}, 3, 3), got {tuple(w.shape)}")
    _check_vector(name, bias, co, "bias")
    ab = None
    if a is not None:
        _check_vector(name, a, ca, "a")
        _check_vector(name, b, ca, "b")
        ab = _ab(a, b, x.dtype)
    wk = w.to(torch.bfloat16).permute(2, 3, 1, 0).contiguous()  # (3, 3, Cin, Co)
    bias32 = bias.float().contiguous()
    out = torch.empty((bsz, h, wd, co), dtype=x.dtype, device=x.device)
    lib = _build.library()
    err = lib.imgseg_conv3x3(
        _ptr(x), _ptr(x_b), _ptr(wk), _ptr(bias32), _ptr(ab), _ptr(out),
        bsz, h, wd, ca, cb, co, _stream(),
    )
    _build.check(err, name)
    conv3x3.launches += 1
    return out


conv3x3.launches = 0


def maxpool2x2_affine_relu(
    z: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """2x2/2 max-pool of ``relu(z*a + b)``: z (B,H,W,C) is a block's raw
    second-conv output and ``a, b`` (C,) its bn2 affine, rounded to the
    activation dtype and applied in fp32 (``_ab_lanes``, folded.py:477-482).
    Output (B,H//2,W//2,C), rounded to z's dtype."""
    if _on_cpu(z):
        return maxpool2x2_affine_relu_plain(z, a, b)
    name = "maxpool2x2_affine_relu"
    _check_cuda_operands(name, z, a, b)
    _check_activation(name, z, "z")
    bsz, h, wd, c = z.shape
    _check_vector(name, a, c, "a")
    _check_vector(name, b, c, "b")
    ab = _ab(a, b, z.dtype)
    out = torch.empty((bsz, h // 2, wd // 2, c), dtype=z.dtype, device=z.device)
    lib = _build.library()
    err = lib.imgseg_maxpool2x2_affine_relu(
        _ptr(z), _ptr(ab), _ptr(out), bsz, h, wd, c, _stream()
    )
    _build.check(err, name)
    maxpool2x2_affine_relu.launches += 1
    return out


maxpool2x2_affine_relu.launches = 0


def convtranspose2x2(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """ConvTranspose(k=2, s=2): x (B,Hin,Win,Cin), w the torch
    ``ConvTranspose2d`` weight (Cin, Co, 2, 2) — flax's flip is undone by
    ``utils.convert.state_dict_from_jax`` — and bias (Co,).
    ``y[b, 2i+dy, 2j+dx, o] = round(bias[o] + sum_c x[b,i,j,c] w[c,o,dy,dx])``."""
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
    bias32 = bias.float().contiguous()
    out = torch.empty((bsz, 2 * h, 2 * wd, co), dtype=x.dtype, device=x.device)
    lib = _build.library()
    err = lib.imgseg_convtranspose2x2(
        _ptr(x), _ptr(wk), _ptr(bias32), _ptr(out), bsz, h, wd, ci, co, _stream()
    )
    _build.check(err, name)
    convtranspose2x2.launches += 1
    return out


convtranspose2x2.launches = 0

WRAPPERS = (conv3x3, maxpool2x2_affine_relu, convtranspose2x2)
