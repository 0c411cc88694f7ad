"""Typed training configuration; counterpart of
``image_segmentation_tpu/config.py`` (DataConfig :16, OptimizerConfig :33,
TrainConfig :46, preset :84), field for field and preset for preset, so
that ``dataclasses.asdict(preset(name))`` is equal in both packages.

Fields that only the JAX package acts on are still declared so that the
presets compare equal: ``compile_cache`` (XLA's compilation cache; nothing
to cache here) and ``debug_nans``.  ``n_model_shards`` (tensor
parallelism) is ported for ``unet``, ``large_unet``, ``clip_unet`` and
``clip_unet_prompt``; the Trainer raises ``NotImplementedError`` for it
with another model, ``fused_deep`` or ``remat``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class DataConfig:
    dataset: str = "oxford-pet"          # "oxford-pet" | "synthetic"
    dataset_loc: str = "Data/Oxford-IIIT-Pet-Augmented"
    train_split: str = "train"
    val_split: str = "validation"
    augmentations_per_datapoint: int = 4
    cache: bool = True
    image_size: int = 256
    # Prompt task: Gaussian heatmap sigma (None = binary one-hot point).
    prompt_gaussian_sigma: Optional[float] = 10.0
    # synthetic fixture knobs
    synthetic_length: int = 100
    num_classes: int = 3


@dataclasses.dataclass
class OptimizerConfig:
    """torch.optim.Adam(lr=1e-3, weight_decay=1e-4): L2 added to the
    gradient BEFORE the Adam moments (not AdamW)."""

    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


@dataclasses.dataclass
class TrainConfig:
    model: str = "unet"                  # registry key, see models/registry.py
    model_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    loss: str = "hybrid"                 # "hybrid"(=CE) | "dice_ce" | "hybrid_binary" | "mse"
    batch_size: int = 16
    num_epochs: int = 2
    seed: int = 0
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    save_dir: str = "saved-models"
    checkpoint_every: int = 1            # epochs
    bf16: bool = True
    # Rematerialize the forward pass in the backward (torch.utils.checkpoint).
    remat: bool = False
    # Fail fast on NaNs (a JAX debug switch); the port does not act on it.
    debug_nans: bool = False
    # XLA's persistent compilation cache directory; the port compiles
    # nothing through XLA and ignores it.
    compile_cache: Optional[str] = None
    # The C++ background-thread batch loader (data/native_loader.py).
    native_loader: bool = False
    # Tensor-parallel weight shards: ranks per model group (parallel/tensor.py).
    n_model_shards: int = 1


def preset(name: str) -> TrainConfig:
    """The production configs of ``image_segmentation_tpu/config.py:84``.

    The kernel-path model args (``w2d_level0`` + ``w2d_impl="pallas_fused"``
    + ``w2d_level1_fold2``) put the port's levels 0 and 1 on the
    hand-written kernels (``models/unet.py``)."""
    _w2d = {
        "w2d_level0": True,
        "w2d_impl": "pallas_fused",
        "w2d_level1_fold2": True,
    }
    presets = {
        "unet": TrainConfig(
            model="unet", batch_size=250, num_epochs=200,
            model_args=dict(_w2d),
            data=DataConfig(augmentations_per_datapoint=4),
        ),
        "large_unet": TrainConfig(
            model="large_unet", batch_size=150, num_epochs=200,
            model_args=dict(_w2d),
            data=DataConfig(augmentations_per_datapoint=4),
        ),
        "clip_unet": TrainConfig(
            model="clip_unet", batch_size=100, num_epochs=200,
            model_args=dict(_w2d),
            data=DataConfig(augmentations_per_datapoint=4),
        ),
        "clip_res": TrainConfig(
            model="clip_res", batch_size=100, num_epochs=200,
            model_args={"w2d_level0": True, "w2d_impl": "pallas_fused"},
            data=DataConfig(augmentations_per_datapoint=4),
        ),
        "clip_autoencoder": TrainConfig(
            model="clip_autoencoder", batch_size=150, num_epochs=200,
            data=DataConfig(augmentations_per_datapoint=4),
        ),
        "autoencoder": TrainConfig(
            model="autoencoder", loss="mse", batch_size=16, num_epochs=200,
            model_args=dict(_w2d, w2d_level2_fold2=True),
            data=DataConfig(augmentations_per_datapoint=0),
        ),
        "segment_classifier": TrainConfig(
            model="clip_res_class", loss="class_binary", batch_size=16,
            num_epochs=200,
            model_args={"w2d_level0": True, "w2d_impl": "pallas_fused"},
            data=DataConfig(augmentations_per_datapoint=2),
        ),
        "prompt": TrainConfig(
            model="clip_unet_prompt", loss="hybrid_binary", batch_size=32,
            num_epochs=100, checkpoint_every=5,
            model_args=dict(_w2d),
            data=DataConfig(augmentations_per_datapoint=4),
        ),
        # CPU-sized smoke config.
        "smoke": TrainConfig(
            model="unet", batch_size=8, num_epochs=1,
            model_args={"stem_features": 8, "encoder_features": (16, 32)},
            data=DataConfig(
                dataset="synthetic", synthetic_length=8, image_size=32,
                augmentations_per_datapoint=1,
            ),
        ),
    }
    return presets[name]
