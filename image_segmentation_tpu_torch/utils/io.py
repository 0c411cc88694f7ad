"""Run-folder allocation and CSV/JSON training artifacts; counterpart of
``image_segmentation_tpu/utils/io.py``, copied whole (it imports no JAX),
so the port loads nothing of the JAX package.

The reference's observable artifact schemas (models/helperFunctions.py):

- ``run-%03d/`` folders under ``saved-models/<ModelName>/``
  (helperFunctions.py:127-153)
- ``loss.csv`` header: Epoch, Train Loss, Validation Loss,
  Val Pixel Accuracy, Val Mean Dice, Val IoU (helperFunctions.py:155-208)
- ``model_settings.json`` settings dump (helperFunctions.py:10-125),
  generated from the typed config and the parameter tree in the JAX
  layout (``utils/convert.jax_from_state_dict``), so the file equals the
  JAX package's for the same config
- ``augmentation-results/<name>.csv`` per-corruption sweep CSVs
  (model_wrappers.py:480-521) and ``results/robustness_scores.csv``
  (robustness_evaluation.py:96-99).
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
from typing import Any, Dict, Iterable, Mapping, Optional

LOSS_CSV_HEADER = [
    "Epoch",
    "Train Loss",
    "Validation Loss",
    "Val Pixel Accuracy",
    "Val Mean Dice",
    "Val IoU",
]

ROBUSTNESS_CSV_HEADER = ["perturbation_type", "param_value", "mean_dice"]

AUGMENTATION_CSV_HEADER = ["param", "iou", "pixel_accuracy", "dice"]


def get_next_run_folder(base_path: str) -> str:
    """Allocate saved-models/<Model>/run-001, run-002, ... (helperFunctions.py:127-153)."""
    i = 1
    while True:
        folder = os.path.join(base_path, f"run-{i:03d}")
        if not os.path.isdir(folder):
            os.makedirs(folder)
            return folder + os.sep
        i += 1


def write_csv_header(run_dir: str) -> None:
    path = os.path.join(run_dir, "loss.csv")
    if not os.path.exists(path):
        with open(path, "w", newline="") as f:
            csv.writer(f).writerow(LOSS_CSV_HEADER)


def log_loss_to_csv(
    epoch: int,
    train_loss: float,
    val_loss: float,
    val_pixel_acc: float,
    val_dice: float,
    val_iou: float,
    run_dir: str,
) -> None:
    with open(os.path.join(run_dir, "loss.csv"), "a", newline="") as f:
        csv.writer(f).writerow(
            [epoch, train_loss, val_loss, val_pixel_acc, val_dice, val_iou]
        )


def write_rows_csv(path: str, header: Iterable[str], rows: Iterable[Iterable]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(header))
        for row in rows:
            w.writerow(list(row))


def _jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def layer_settings(params: Any) -> Dict[str, Dict[str, Any]]:
    """Per-layer hyperparameter dump, derived from the parameter tree.

    The reference introspects live ``nn.Module`` objects for each layer's
    hyperparameters (helperFunctions.py:10-125: Conv2d in/out channels,
    kernel size, BatchNorm features, Linear dims...).  In the functional
    design the parameter shapes carry the same information, so we walk the
    pytree instead: every module whose leaf dict holds a ``kernel`` /
    ``scale`` is reported with its inferred type and dimensions.
    """

    layers: Dict[str, Dict[str, Any]] = {}

    def visit(path: str, node: Any) -> None:
        if not isinstance(node, Mapping):
            return
        arrays = {
            k: v for k, v in node.items() if hasattr(v, "shape")
        }
        if "kernel" in arrays:
            shape = tuple(int(s) for s in arrays["kernel"].shape)
            entry: Dict[str, Any] = {"use_bias": "bias" in arrays}
            if len(shape) == 4:
                entry.update(
                    type="Conv",
                    kernel_size=list(shape[:2]),
                    in_features=shape[2],
                    out_features=shape[3],
                )
            elif len(shape) == 2:
                entry.update(
                    type="Dense", in_features=shape[0], out_features=shape[1]
                )
            else:
                entry.update(type="Param", shape=list(shape))
            layers[path] = entry
        elif "scale" in arrays:
            layers[path] = {
                "type": "Norm",
                "features": int(arrays["scale"].shape[-1]),
                "use_bias": "bias" in arrays,
            }
        elif arrays:
            layers[path] = {
                k: list(int(s) for s in v.shape) for k, v in arrays.items()
            }
        for k, v in node.items():
            if isinstance(v, Mapping):
                visit(f"{path}/{k}" if path else str(k), v)

    visit("", params if isinstance(params, Mapping) else {})
    return layers


def save_training_info(
    run_dir: str,
    *,
    model_name: str,
    config: Any,
    num_params: int,
    train_dataset_size: int,
    val_dataset_size: int,
    extra_params: Optional[Dict[str, Any]] = None,
    params: Any = None,
) -> None:
    """Write model_settings.json (helperFunctions.py:10-125 equivalent)."""
    payload = {
        "model": model_name,
        "config": _jsonable(config),
        "num_params": int(num_params),
        "train_dataloader": {"dataset_size": int(train_dataset_size)},
        "val_dataloader": {"dataset_size": int(val_dataset_size)},
    }
    if params is not None:
        payload["layers"] = layer_settings(params)
    if extra_params:
        payload["extra_params"] = _jsonable(extra_params)
    with open(os.path.join(run_dir, "model_settings.json"), "w") as f:
        json.dump(payload, f, indent=4)
