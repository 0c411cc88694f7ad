"""Inference artifacts and standalone prediction; counterpart of
``image_segmentation_tpu/engine/export.py`` (export_model :46,
load_model :154, predict :177).

The artifact format is the JAX package's: ``config.json`` (registry name +
model args) and ``model.npz`` (flat ``params/...``, ``batch_stats/...``
keys), so an artifact written by either package loads in the other, for
every registry model.  ``predict`` serves the single-input models whose
output is class logits, as JAX's does; it refuses the two-input prompt
models and the two-output ``clip_res_class`` with a ``TypeError``.  The
torch-format, StableHLO and model-card extras of the JAX exporter are not
ported (ROADMAP.md Queue 1 item 11).
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
from ..utils import convert

PREDICT_SIZE = 256
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
) -> str:
    """Write ``model``'s weights and its registry name/args as an artifact
    directory that both packages' ``load_model`` read."""
    if model_name not in MODEL_NAMES:  # load_model could not rebuild it
        raise KeyError(f"unknown model {model_name!r}; known: {sorted(MODEL_NAMES)}")
    os.makedirs(out_dir, exist_ok=True)
    params, batch_stats = convert.jax_from_state_dict(model.state_dict())
    convert.write_flat_npz(
        os.path.join(out_dir, "model.npz"),
        {"params": params, "batch_stats": batch_stats},
    )
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({"model": model_name, "model_args": model_args or {}}, f, indent=2)
    return out_dir


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
