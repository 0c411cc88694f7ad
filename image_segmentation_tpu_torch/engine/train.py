"""Training engine; counterpart of ``image_segmentation_tpu/engine/train.py``
(adam_l2 :52, build_optimizer :62, make_loss_fn :84, Trainer :131).

One train step: uint8 batch -> ``DataAugmentor.apply_u8`` (flip, rotation,
colour jitter, blur, clean slots; with ``augmentations_per_datapoint > 0``)
or normalisation, on the device -> forward in the compute dtype (bf16 on
the card, fp32 parameters) -> CE loss -> backward -> ``torch.optim.Adam``
with L2 added to the gradient before the moments, and the BatchNorm
running averages committed by the forward.  Batch statistics are over the
whole batch, as in the JAX Trainer.  The loss of each step stays on the
device and is read once per epoch.

The augmentation of a step is drawn on the host from a ``torch.Generator``
seeded by ``(config.seed, step_key)``, with ``step_key = epoch*100003 +
batch`` as the JAX Trainer folds its key (:439), so the CPU and the card
draw the same augmentation; the draws go to the card from pinned memory
without a wait.  torch's draws are not JAX's: the tests hold the step to
JAX by feeding both augmentors the same draws.

Ported for the segmentation task on the U-Nets, with synthetic data.  What
is not ported raises ``NotImplementedError`` naming its ROADMAP.md item:
run artifacts (run folder, ``loss.csv``, checkpoints), the Oxford-IIIT-Pet
loader, the other losses, ``remat``, ``native_loader`` and
``n_model_shards``.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config import TrainConfig
from ..data.datasets import ArrayDataset, synthetic_dataset
from ..data.pipeline import BatchPipeline
from ..models.registry import build_model
from ..ops import losses as L
from ..ops.augment import AugmentParams, DataAugmentor, normalize_image

# flax's lecun_normal: a normal truncated at two standard deviations, its
# scale corrected so the variance is 1/fan_in (jax.nn.initializers).
_TRUNC_STD = 0.87962566103423978


def adam_l2(cfg, params) -> torch.optim.Optimizer:
    """torch.optim.Adam(lr, betas, eps, weight_decay): L2 added to the raw
    gradient BEFORE the Adam moments (the JAX ``adam_l2`` :52 is built to
    equal it)."""
    return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(cfg.b1, cfg.b2),
                            eps=cfg.eps, weight_decay=cfg.weight_decay)


def build_optimizer(opt_cfg, model: nn.Module) -> torch.optim.Optimizer:
    """``adam_l2`` over every parameter.  The JAX version also masks frozen
    subtrees (the CLIP tower, the ResNet backbone); the U-Nets have none, and
    the mask comes with the CLIP models (ROADMAP.md Queue 1 item 6)."""
    return adam_l2(opt_cfg, model.parameters())


def make_loss_fn(name: str) -> Callable:
    if name in ("hybrid", "ce"):
        return lambda logits, batch: L.hybrid_loss(logits, batch["masks"])
    if name in ("dice_ce", "hybrid_binary", "mse", "class_binary"):
        raise NotImplementedError(
            f"loss {name!r} is not ported yet; see ROADMAP.md Queue 1 item 2"
        )
    raise KeyError(f"unknown loss {name!r}")


def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers, drawn on the CPU from ``generator`` whatever
    the model's device: lecun-normal conv and ConvTranspose kernels, zero
    biases, BatchNorm scale 1, bias 0, mean 0, var 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                cin = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
                std = math.sqrt(1.0 / (cin * w.shape[2] * w.shape[3])) / _TRUNC_STD
                t = torch.empty(w.shape)
                nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
                w.copy_(t)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


def _dataset_from_config(cfg: TrainConfig, train: bool) -> ArrayDataset:
    d = cfg.data
    if d.dataset != "synthetic":
        raise NotImplementedError(
            f"dataset {d.dataset!r}: loading it needs the network and is not "
            "ported; see ROADMAP.md Queue 1 item 10 (synthetic data is)"
        )
    return synthetic_dataset(
        length=d.synthetic_length, height=d.image_size, width=d.image_size,
        num_classes=d.num_classes, seed=cfg.seed + (0 if train else 1),
    )


class Trainer:
    """The JAX ``Trainer`` (:131) for one device.

    ``device`` is where the model, the optimizer state and the batches live
    (the card unless the caller asks for the CPU); the initial weights are
    drawn from a ``torch.Generator`` seeded with ``config.seed``, so they do
    not depend on the device.  With ``augmentations_per_datapoint > 0`` the
    train batches go through a ``DataAugmentor`` with the JAX Trainer's
    backend and geometry (:190-196).
    """

    def __init__(
        self,
        config: TrainConfig,
        *,
        device="cuda",
        train_data: Optional[ArrayDataset] = None,
        val_data: Optional[ArrayDataset] = None,
        make_artifacts: bool = True,
    ):
        if make_artifacts:
            raise NotImplementedError(
                "run artifacts (run folder, loss.csv, checkpoints) are not ported; "
                "pass make_artifacts=False (ROADMAP.md Queue 1 item 11)"
            )
        for field, default, item in (("remat", False, 5), ("native_loader", False, 10),
                                     ("n_model_shards", 1, 10)):
            if getattr(config, field) != default:
                raise NotImplementedError(
                    f"{field}={getattr(config, field)!r} is not ported; "
                    f"see ROADMAP.md Queue 1 item {item}"
                )
        self.config = config
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if config.bf16 else torch.float32
        self.model = build_model(config.model, device=self.device, dtype=self.dtype,
                                 **config.model_args)
        init_weights_(self.model, torch.Generator().manual_seed(config.seed))
        self.num_params = sum(p.numel() for p in self.model.parameters())
        self.optimizer = build_optimizer(config.optimizer, self.model)
        self.loss_fn = make_loss_fn(config.loss)
        aug_n = config.data.augmentations_per_datapoint
        self.augmentor = DataAugmentor(aug_n) if aug_n > 0 else None
        self.train_data = train_data or _dataset_from_config(config, True)
        self.val_data = val_data or _dataset_from_config(config, False)

    def augment_params(self, n: int, step_key: int) -> AugmentParams:
        """The augmentation draws of the step ``step_key`` for a batch of n,
        on the host, from a generator seeded by ``(config.seed, step_key)``."""
        seed = np.random.SeedSequence([self.config.seed, step_key]).generate_state(1)[0]
        return self.augmentor.sample(n, torch.Generator().manual_seed(int(seed)))

    def _prepare_batch(self, images_u8: torch.Tensor, masks_u8: torch.Tensor, *,
                       augment: bool, params: Optional[AugmentParams] = None):
        """uint8 device batch -> ([0, 1] fp32 images, {"masks": int64 class
        ids}), through the augmentor with ``params`` when ``augment`` and
        the Trainer has one."""
        if augment and self.augmentor is not None:
            if params is None:
                raise ValueError("an augmented batch needs its AugmentParams")
            if self.device.type == "cuda":
                params = params.pin_memory().to(self.device, non_blocking=True)
            images, masks = self.augmentor.apply_u8(params, images_u8, masks_u8)
            return images, {"masks": masks}
        return normalize_image(images_u8), {"masks": masks_u8.long()}

    def train_step(self, images_u8: torch.Tensor, masks_u8: torch.Tensor,
                   step_key: int = 0) -> torch.Tensor:
        """One optimizer step on one batch, augmented with the draws of
        ``step_key``; returns the loss, on the device."""
        params = None
        if self.augmentor is not None:
            params = self.augment_params(images_u8.shape[0], step_key)
        images, batch = self._prepare_batch(images_u8, masks_u8, augment=True, params=params)
        return self.optimize(images, batch)

    def optimize(self, images: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Forward, loss, backward and Adam on a prepared batch; returns the
        loss, on the device."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.model(images, train=True), batch)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, images_u8: torch.Tensor, masks_u8: torch.Tensor):
        """(loss, IoU, pixel accuracy, dice) of one batch with the running
        statistics, on the device."""
        images, batch = self._prepare_batch(images_u8, masks_u8, augment=False)
        logits = self.model(images, train=False)
        masks = batch["masks"]
        return (self.loss_fn(logits, batch), L.iou(logits, masks),
                L.pixel_accuracy(logits, masks), L.dice_score(logits, masks))

    def _pipelines(self):
        cfg = self.config
        train_pipe = BatchPipeline(
            self.train_data, cfg.batch_size, device=self.device,
            augmentations_per_datapoint=cfg.data.augmentations_per_datapoint,
            shuffle=True, drop_last=True, seed=cfg.seed)
        val_pipe = BatchPipeline(self.val_data, cfg.batch_size, device=self.device,
                                 shuffle=False, drop_last=False, seed=cfg.seed)
        return train_pipe, val_pipe

    def train(self, num_epochs: Optional[int] = None, *, verbose: bool = False) -> Dict[str, Any]:
        """``num_epochs`` epochs, each followed by :meth:`evaluate`; returns
        ``{"history": [{epoch, train_loss, rate, val_*}, ...]}``."""
        cfg = self.config
        num_epochs = num_epochs if num_epochs is not None else cfg.num_epochs
        train_pipe, val_pipe = self._pipelines()
        history = []
        for epoch in range(num_epochs):
            t0 = time.perf_counter()
            loss_sum = torch.zeros((), device=self.device)
            n_batches = 0
            for images, masks in train_pipe.epoch(epoch):
                loss_sum += self.train_step(images, masks, epoch * 100003 + n_batches)
                n_batches += 1
            train_loss = float(loss_sum / max(n_batches, 1))  # one sync per epoch
            dt = time.perf_counter() - t0
            rate = n_batches * cfg.batch_size / dt if dt > 0 else 0.0
            row = dict(epoch=epoch, train_loss=train_loss, rate=rate, **self.evaluate(val_pipe))
            history.append(row)
            if verbose:
                print(f"Epoch: {epoch}\nRate: {rate:.1f} datapoints/s\n"
                      f"Train Loss: {train_loss:.4f}\n"
                      f"Validation Loss: {row['val_loss']:.4f}\n"
                      f"Val IoU: {row['val_iou']:.4f}\n"
                      f"Val Pixel Accuracy: {row['val_pixel_accuracy']:.4f}\n"
                      f"Val Dice: {row['val_dice']:.4f}", flush=True)
        return {"history": history}

    def evaluate(self, val_pipe: Optional[BatchPipeline] = None) -> Dict[str, float]:
        """Mean over the validation batches of the eval step's metrics."""
        if val_pipe is None:
            _, val_pipe = self._pipelines()
        sums, n = None, 0
        for images, masks in val_pipe.epoch(0):
            out = self.eval_step(images, masks)
            sums = out if sums is None else tuple(a + b for a, b in zip(sums, out))
            n += 1
        if n == 0:
            return dict(val_loss=0.0, val_iou=0.0, val_pixel_accuracy=0.0, val_dice=0.0)
        loss, iou_v, pa, dice = (float(s / n) for s in sums)
        return dict(val_loss=loss, val_iou=iou_v, val_pixel_accuracy=pa, val_dice=dice)
