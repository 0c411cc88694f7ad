"""The 1x1 conv of the folded paths' stem and output, with its merged
backward kernel (K11); counterpart of ``make_folded_1x1``
(``image_segmentation_tpu/ops/pallas_conv.py:1394``) and
``_folded_1x1_bwd_pallas`` (:1343) behind ``models/folded.Folded1x1``.

- :func:`conv1x1_bwd` — the wrapper of ``csrc/conv1x1_bwd.cu``: dx, dw and
  db of ``y = x @ w^T + bias`` in one pass over (x, g);
- :func:`conv1x1_bwd_plain` — its plain PyTorch version;
- :class:`Conv1x1Function` — the conv as an autograd node whose backward
  is :func:`conv1x1_bwd`.

JAX takes the kernel only under ``IMGSEG_PALLAS_1X1_BWD=1`` (it lost on
the TPU, folded.py:254-264).  The port has no such switch: every 1x1 conv
that JAX builds as a ``Folded1x1`` without ``in_perm`` (the stem and the
output conv of the folded paths) trains through :class:`Conv1x1Function`,
whose values are those of JAX's default autodiff backward.

Dispatch is by the device of the input, as in :mod:`.fused_conv`: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel (bf16
operands, fp32 sums) and raises if the build or the launch fails.
``conv1x1_bwd.launches`` counts the launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import launch as _launch
from ._build import on_cpu as _on_cpu
from ._build import ptr as _ptr
from ._build import scratch as _scratch
from .fused_conv import _check_activation, _check_cuda_operands

# the kernel keeps up to 8 of the (Co, Ci + 1) sums per thread of 256, and
# its smallest tile (8 pixels of x and g) with the weight in shared memory
MAX_SUMS = 2048
MAX_CHANNELS = 1024

Grads = Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]


def conv1x1_bwd_plain(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor, *,
                      input_grad: bool = True) -> Grads:
    """``(dx, dw, db)``; see :func:`conv1x1_bwd`."""
    dt = g.dtype
    co, ci = w.shape[:2]
    gf, xf = g.float().reshape(-1, co), x.float().reshape(-1, ci)
    dx = None
    if input_grad:
        dx = (gf @ w[:, :, 0, 0].to(dt).float()).to(dt).view(x.shape)
    return dx, (gf.t() @ xf).view(co, ci, 1, 1), gf.sum(0)


def conv1x1_bwd(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor, *,
                input_grad: bool = True) -> Grads:
    """Backward of the 1x1 conv ``y = x @ w^T + bias`` on NHWC tensors
    (``_1x1_bwd_kernel_body`` :1306 at fold 1).

    x (B,H,W,Ci), g (B,H,W,Co), w the torch layout (Co, Ci, 1, 1).
    Returns ``dx = round(g @ round(w))`` (B,H,W,Ci) in g's dtype — ``None``
    without ``input_grad`` — and the fp32 sums over pixels ``dw`` (Co, Ci,
    1, 1) = ``sum g^T x`` and ``db`` (Co,) = ``sum g``.
    """
    name = "conv1x1_bwd"
    if _on_cpu(g):
        return conv1x1_bwd_plain(x, g, w, input_grad=input_grad)
    _check_cuda_operands(name, g, x, w)
    _check_activation(name, x, "x")
    bsz, h, wd, ci = x.shape
    co = w.shape[0]
    _check_activation(name, g, "g", (bsz, h, wd, co))
    if w.shape != (co, ci, 1, 1):
        raise ValueError(f"{name}: w must be ({co}, {ci}, 1, 1), got {tuple(w.shape)}")
    if co * (ci + 1) > MAX_SUMS or ci + co > MAX_CHANNELS:
        raise ValueError(f"{name}: {ci} -> {co} channels is more than the kernel takes")
    npix = bsz * h * wd
    wk = w[:, :, 0, 0].to(torch.bfloat16).contiguous()
    dx = torch.empty_like(x) if input_grad else None
    dwb = torch.empty((co, ci + 1), dtype=torch.float32, device=g.device)
    scratch = _scratch("imgseg_conv1x1_bwd_scratch", g, npix, ci, co)
    _launch(conv1x1_bwd, "imgseg_conv1x1_bwd", _ptr(x), _ptr(g), _ptr(wk), _ptr(dx),
            _ptr(dwb), _ptr(scratch), npix, ci, co)
    return dx, dwb[:, :ci].reshape(co, ci, 1, 1).contiguous(), dwb[:, ci].contiguous()


WRAPPERS = (conv1x1_bwd,)
for _w in WRAPPERS:
    _w.launches = 0


class Conv1x1Function(torch.autograd.Function):
    """``apply(x, w, bias) -> y``: the 1x1 conv on NHWC x (B,H,W,Ci) in x's
    dtype, the same expression as ``blocks.conv1x1_nhwc`` (JAX keeps the
    forward the identical matmul, pallas_conv.py:1412-1415); the backward
    is :func:`conv1x1_bwd`, with no dx when x needs no gradient (the stem,
    whose input is the image)."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        return F.linear(x, w[:, :, 0, 0].to(x.dtype), bias.to(x.dtype))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return conv1x1_bwd(x, g.contiguous(), w, input_grad=ctx.needs_input_grad[0])
