"""Inference artifacts and standalone prediction; counterpart of
``image_segmentation_tpu/engine/export.py`` (export_model :46,
export_stablehlo :102, load_stablehlo :141, load_model :154, predict :177).

The artifact format is the JAX package's: ``config.json`` (registry name +
model args) and ``model.npz`` (flat ``params/...``, ``batch_stats/...``
keys), so an artifact written by either package loads in the other, for
every registry model.  ``predict`` serves the single-input models whose
output is class logits, as JAX's does; it refuses the two-input prompt
models and the two-output ``clip_res_class`` with a ``TypeError``.

Extras, as JAX's: ``torch_format`` also writes ``model_torch.pt``, the
state dict in the reference's key layout (the port's own layout,
``utils/convert.py``), for the six names JAX's exporter takes
(``TORCH_FORMAT_MODELS``); ``exported_program`` also writes ``model.pt2``,
the counterpart of JAX's ``model.stablehlo``: :func:`export_program`
(``torch.export`` of the eval forward, the weights inside) and
:func:`load_program`.  In the program the kernels are the registered
operators ``imgseg::conv3x3``, ``imgseg::maxpool2x2_affine_relu`` and
``imgseg::convtranspose2x2`` (``ops/fused_conv.py``), so unlike a StableHLO
module it loads only where this package is installed.  The model card
(JAX's README.md) is not written.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.clip_models import ClipResSegmentationClassification, ClipUnetPrompt
from ..models.prompt_fusion import SegmentationModelWithPrompt
from ..models.registry import MODEL_NAMES, build_model
from ..ops import fused_conv
from ..utils import convert

PREDICT_SIZE = 256
# the names JAX's torch_format takes (utils/torch_export.py:299-306)
TORCH_FORMAT_MODELS = ("unet", "large_unet", "clip_unet", "clip_res", "clip_autoencoder",
                       "clip_unet_prompt")
# models predict cannot serve, and why (JAX's predict cannot either)
_NOT_SERVED = {
    ClipUnetPrompt: "it takes a prompt map as a second input",
    SegmentationModelWithPrompt: "it takes a prompt map as a second input",
    ClipResSegmentationClassification: "it returns (mask logits, class logits), not class logits",
}


def export_model(
    model: nn.Module,
    model_name: str,
    model_args: Optional[Dict[str, Any]] = None,
    out_dir: str = "exported-model",
    torch_format: bool = False,
    exported_program: bool = False,
    image_size: int = 256,
) -> str:
    """Write ``model``'s weights and its registry name/args as an artifact
    directory that both packages' ``load_model`` read; with
    ``torch_format`` also ``model_torch.pt`` (the reference-layout state
    dict; a name outside ``TORCH_FORMAT_MODELS`` raises ``ValueError``, as
    in JAX), with ``exported_program`` also ``model.pt2``
    (:func:`export_program` at ``image_size``, batch dimension dynamic)."""
    if model_name not in MODEL_NAMES:  # load_model could not rebuild it
        raise KeyError(f"unknown model {model_name!r}; known: {sorted(MODEL_NAMES)}")
    if torch_format and model_name not in TORCH_FORMAT_MODELS:
        raise ValueError(f"torch_format supports {sorted(TORCH_FORMAT_MODELS)}, "
                         f"not {model_name!r}")
    os.makedirs(out_dir, exist_ok=True)
    params, batch_stats = convert.jax_from_state_dict(model.state_dict())
    convert.write_flat_npz(
        os.path.join(out_dir, "model.npz"),
        {"params": params, "batch_stats": batch_stats},
    )
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({"model": model_name, "model_args": model_args or {}}, f, indent=2)
    if torch_format:
        torch.save(torch_state_dict(model), os.path.join(out_dir, "model_torch.pt"))
    if exported_program:
        export_program(model, os.path.join(out_dir, "model.pt2"), image_size=image_size)
    return out_dir


def torch_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict on the host, contiguous: the reference's key
    layout, which the port's modules keep."""
    return {k: v.detach().cpu().contiguous().clone() for k, v in model.state_dict().items()}


def export_program(
    model: nn.Module,
    out_path: str,
    *,
    image_size: int = 256,
    batch_size: Optional[int] = None,
) -> str:
    """Save ``model``'s eval forward (no autograd) as a ``torch.export``
    program at ``out_path`` (``.pt2``), JAX's ``export_stablehlo``
    (:102): one argument, a float32 NHWC batch of ``image_size`` images
    (its batch dimension dynamic unless ``batch_size`` is given), the
    class logits out, the weights inside; on the model's device.  The
    kernels are ``imgseg::`` operators in the graph."""
    check_servable(model)
    device = next(model.parameters()).device
    n = 2 if batch_size is None else batch_size
    example = torch.zeros((n, image_size, image_size, 3), device=device)
    dims = None
    if batch_size is None:
        dims = ({0: torch.export.Dim("batch", min=1, max=1024)},)
    with torch.no_grad(), fused_conv.operators():
        program = torch.export.export(_EvalForward(model), (example,), dynamic_shapes=dims)
    torch.export.save(program, out_path)
    return out_path


class _EvalForward(nn.Module):
    """``model(x, train=False)`` as a one-argument module."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x, train=False)


def load_program(path: str):
    """A :func:`export_program` artifact as a callable ``f(images_f32_nhwc)
    -> logits`` on the device it was exported on (JAX's ``load_stablehlo``,
    :141).  The ``imgseg::`` operators are registered by importing
    ``ops.fused_conv``, which this module does."""
    program = torch.export.load(path)
    module = program.module()

    @torch.no_grad()
    def call(x: torch.Tensor) -> torch.Tensor:
        return module(x)

    call.program = program
    return call


def load_model(
    artifact_dir: str, *, device="cuda", dtype: torch.dtype = torch.bfloat16
) -> nn.Module:
    """Rebuild the model of an artifact directory on ``device`` (the card
    unless the caller asks for the CPU), in eval mode, computing in
    ``dtype``.  Its parameters do not require grad: an
    artifact is for inference."""
    with open(os.path.join(artifact_dir, "config.json")) as f:
        cfg = json.load(f)
    model = build_model(
        cfg["model"], device=device, dtype=dtype, **cfg.get("model_args", {})
    )
    tree = convert.read_flat_npz(os.path.join(artifact_dir, "model.npz"))
    sd = convert.state_dict_from_jax(tree["params"], tree.get("batch_stats", {}))
    model.load_state_dict(sd, strict=True)
    return model.eval().requires_grad_(False)


def check_servable(model: nn.Module) -> None:
    """Raise ``TypeError`` for a model whose forward takes a second input
    or returns more than the class logits: ``predict`` and the
    ``Evaluator`` serve neither."""
    for cls, why in _NOT_SERVED.items():
        if isinstance(model, cls):
            raise TypeError(f"cannot serve {type(model).__name__}: {why}")


@torch.inference_mode()
def predict(model: nn.Module, image) -> np.ndarray:
    """PIL image or HWC array -> (256, 256) class-id mask.

    As the JAX ``predict``: uint8-range input (max > 1.5) is scaled to
    [0, 1], grey becomes 3 channels, other sizes are resized bilinearly to
    256x256 (antialiased when shrinking, as ``jax.image.resize`` is), then
    the forward and an argmax over classes.  A model whose forward takes a
    second input or returns more than the logits raises ``TypeError``.
    """
    check_servable(model)
    arr = np.asarray(image, dtype=np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    device = next(model.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(arr)).to(device)[None]
    if x.shape[1:3] != (PREDICT_SIZE, PREDICT_SIZE):
        x = F.interpolate(
            x.permute(0, 3, 1, 2), size=(PREDICT_SIZE, PREDICT_SIZE),
            mode="bilinear", align_corners=False, antialias=True,
        ).permute(0, 2, 3, 1)
    logits = model(x)
    return logits.argmax(dim=-1)[0].cpu().numpy()
