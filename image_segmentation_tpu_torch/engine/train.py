"""Training engine; counterpart of ``image_segmentation_tpu/engine/train.py``
(adam_l2 :52, build_optimizer :62, make_loss_fn :84, Trainer :131).

One train step: uint8 batch -> the task's inputs on the device (the
segmentation task: ``DataAugmentor.apply_u8`` with
``augmentations_per_datapoint > 0``, else normalisation; the prompt task:
point prompts and labels from the palette masks, then
``DataAugmentorPrompt.apply_u8``; the class task: the binary any-animal
mask and the cat/dog label from the palette masks, then
``DataAugmentor.apply_u8`` on image and mask; the reconstruction task:
the normalised images, never augmented, are the targets too) -> forward
in the compute dtype (bf16 on the card, fp32 parameters) -> loss ->
backward -> ``torch.optim.Adam``
with L2 added to the gradient before the moments, and the BatchNorm
running averages committed by the forward.  Batch statistics are over the
whole batch, as in the JAX Trainer.  The loss of each step stays on the
device and is read once per epoch.

Two rules keep the optimizer JAX's.  Frozen subtrees (the CLIP tower,
``FROZEN_PREFIXES``, and the ClipRes models' ResNet backbone, whose
parameters do not require grad) are not in the optimizer: neither decayed
nor updated, as JAX's ``set_to_zero`` mask on ``clip_tower`` and
``resnet_backbone``.  Every other parameter is in it, and one that
autograd leaves without a gradient (in ClipUnet and ClipUnetPrompt the
bottleneck block, whose output the one-token fusion does not read) gets a
zero gradient, so L2 decay and Adam move it as they move JAX's
zero-gradient leaves.

The random draws of a step (the augmentation; the prompt task's class and
pixel uniforms) are made on the host from ``torch.Generator``s seeded by
``(config.seed, step_key)``, with ``step_key = epoch*100003 + batch`` as
the JAX Trainer folds its key (:439; eval batches ``7919 + batch``), so the
CPU and the card draw the same ones; they go to the card from pinned
memory without a wait.  torch's draws are not JAX's: the tests hold the
step to JAX by feeding both sides the same draws.

Run artifacts as JAX's (:227-245, :470-485): with ``make_artifacts`` a
run folder ``save_dir/<ModelName>/run-NNN/`` (or ``run_dir``) gets the
``loss.csv`` header and ``model_settings.json`` at construction, then one
``loss.csv`` row per epoch and ``model_<epoch+1>.npz`` every
``checkpoint_every`` epochs: the JAX Trainer's state in its own layout
(``utils/checkpoint.py``), which :meth:`Trainer.restore` loads, from either
package.  Training then goes on as if it had not stopped: the Trainer
counts its epochs, ``train(n)`` runs the next n, and ``restore`` puts the
count where the checkpoint's step is (``step // steps per epoch``, a
checkpoint taken mid-epoch going on at its next batch), so the step keys,
the shuffle order and the draws continue and ``model_<epoch+1>.npz``
numbers on.  This departs from the JAX Trainer on purpose: its ``train``
starts again at epoch 0 whatever the step, and replays that epoch's keys.

Data parallelism (JAX :11-21, :152-161): one process a rank, in the
process group of ``parallel.mesh`` (``cli/train_distributed.py``), every
rank with the same weights (drawn from the same seed, then broadcast from
rank 0) and its rows ``[r*b/R, (r+1)*b/R)`` of each global batch.  The
draws of a step (augmentation, prompts) are made for the whole global
batch from the step key and sliced to the rank's rows, and the clean slots
are positions in the global batch, so the draws do not depend on R.  Every
batch-wide statistic is the global batch's: the BatchNorm statistics
(``blocks.batch_stats``; the kernel blocks sum their ``(S, Q)`` and
``(dS, dQ)`` over ranks, ``ops/fused_conv.FusedBlockFunction``), the
losses and the metrics (``ops/losses``), so the running averages and the
loss are equal on every rank; after the backward the trainable
parameters' gradients are averaged over ranks in one all-reduce.  One
step at R ranks is thus the one-process step on the global batch.  Only
rank 0 writes artifacts; every rank holds rank 0's run folder and calls
:meth:`Trainer.save` at each checkpoint, which waits for the write on
every rank, and :meth:`Trainer.restore` reads on every rank.  At world
size 1 no collective runs.

Tensor parallelism (JAX :155, :219-223, :507-510): with ``n_model_shards``
M > 1 the R ranks form the ``(data=R/M, model=M)`` grid of
``parallel.mesh.make_grid``, rank r on data row ``r // M``; every "over
ranks" above is over the data group, and the M ranks of a data row hold
its rows.  After the initial weights are drawn (whole, from the seed, as
at M = 1) each parameter that JAX's ``shard_params_tp`` shards
(``utils.convert.tp_plan``) is replaced by this rank's slice of its output
channels (``parallel.tensor.shard_module_``), so Adam's moments are the
slice's, and the layers that hold one are column-parallel
(``parallel/tensor.py``) in the training and the evaluation forwards.
:meth:`Trainer.save` makes the sharded leaves and their moments whole over
the model group (rank 0 writes JAX's layout unchanged), and
:meth:`Trainer.restore` slices them again.  Every model and option
trains so, as in JAX: the frozen parts are sharded too (the ClipRes
models' ResNet-34, the CLIP tower), since JAX's rule places the whole
state and its mask only skips their update; the reconstruction and class
tasks' losses and metrics are the data group's, like the others'; under
``remat`` the recomputed forward repeats the model group's gathers, in
the same order on every rank (every rank runs the same graph, so the
recomputation stops at the same place on each).  The only refusal is
``make_grid``'s: a world size that M does not divide.

Ported: the segmentation task on the U-Nets, ClipUnet, ClipRes and
ClipAutoencoder, the prompt task on ClipUnetPrompt, the class task
(``loss="class_binary"``) on ClipResSegmentationClassification, the
reconstruction task (``loss="mse"``) on the autoencoder, every JAX loss;
synthetic data or the Oxford-IIIT-Pet split on disk
(``data.datasets.load_pet_dataset``); the Python pipeline or, with
``native_loader``, the C++ one; ``n_model_shards`` (tensor parallelism,
above).  ``prompt_fusion`` (two inputs and no task in the JAX Trainer
either) is a model only: a Trainer builds it at any M, and its first step
raises the forward's ``TypeError`` (the missing prompt), as JAX's
Trainer cannot train it.

``remat`` (JAX :249-261, ``jax.checkpoint`` around the whole training
apply): the training forward runs under ``torch.utils.checkpoint``
(non-reentrant), which keeps the model's inputs and recomputes the forward
in the backward.  The recomputation commits no running average a second
time (``blocks.no_commits``), and at R ranks it repeats the statistics'
all-reduces in the same order on every rank, so the step equals the one
without ``remat``.  A model built with ``freeze_clip=False`` differentiates
its tower (JAX drops the ``stop_gradient``), but the Trainer's backward
goes to the trainable parameters alone (``backward(inputs=...)``), so the
tower's backward is not run and no gradient piles up on it: JAX's mask
makes that gradient dead code, and the step equals the frozen one.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import math
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import TrainConfig
from ..data.datasets import (
    CAT_PALETTE,
    DOG_PALETTE,
    UNCERTAIN_PALETTE,
    ArrayDataset,
    load_pet_dataset,
    synthetic_dataset,
)
from ..data.pipeline import BatchPipeline
from ..data.prompts import PromptDraws, prompt_maps, prompt_points, sample_prompt_draws
from ..models.blocks import no_commits
from ..models.clip import ClipEmbeddings
from ..models.clip_models import FROZEN_PREFIXES
from ..models.registry import build_model
from ..ops import losses as L
from ..ops.augment import AugmentParams, DataAugmentor, DataAugmentorPrompt, normalize_image
from ..ops.cross_attention import CrossAttentionFusion
from ..parallel import mesh
from ..parallel import tensor
from ..utils import checkpoint as ckpt_lib
from ..utils import io as io_lib
from ..utils import spans
from ..utils.profiling import format_memory_report
from ..utils.convert import jax_from_state_dict, tp_plan

# flax's lecun_normal: a normal truncated at two standard deviations, its
# scale corrected so the variance is 1/fan_in (jax.nn.initializers).
_TRUNC_STD = 0.87962566103423978
# the CLIP embeddings' initialiser, flax's normal(0.02) (models/clip.py:131-140)
_EMBED_STD = 0.02
# fold_in data of the JAX Trainer's eval batches (:493)
EVAL_STEP_KEY = 7919


def adam_l2(cfg, params) -> torch.optim.Optimizer:
    """torch.optim.Adam(lr, betas, eps, weight_decay): L2 added to the raw
    gradient BEFORE the Adam moments (the JAX ``adam_l2`` :52 is built to
    equal it)."""
    return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(cfg.b1, cfg.b2),
                            eps=cfg.eps, weight_decay=cfg.weight_decay)


def trainable_parameters(model: nn.Module):
    """Every parameter outside the frozen subtrees: those under
    ``FROZEN_PREFIXES`` and those a frozen module keeps from requiring grad
    (the ClipRes backbone)."""
    return [p for name, p in model.named_parameters()
            if p.requires_grad and not name.startswith(FROZEN_PREFIXES)]


def build_optimizer(opt_cfg, model: nn.Module) -> torch.optim.Optimizer:
    """``adam_l2`` over the trainable parameters; the frozen subtrees are
    left out, the torch form of the JAX mask's ``set_to_zero``."""
    return adam_l2(opt_cfg, trainable_parameters(model))


def make_loss_fn(name: str) -> Callable:
    if name in ("hybrid", "ce"):
        return lambda logits, batch: L.hybrid_loss(logits, batch["masks"])
    if name == "dice_ce":
        return lambda logits, batch: L.dice_ce_loss(logits, batch["masks"])
    if name == "hybrid_binary":
        return lambda logits, batch: L.hybrid_loss_binary(logits, batch["masks"])
    if name == "mse":
        return lambda out, batch: mesh.global_mean((out.float() - batch["images"]) ** 2)
    if name == "class_binary":
        return _class_loss
    raise KeyError(f"unknown loss {name!r}")


def _class_loss(outputs, batch) -> torch.Tensor:
    """Mask BCE + class BCE on ``(mask_logits, class_logits)`` (:95-108)."""
    mask_logits, class_logits = outputs
    return (L.bce_with_logits(mask_logits[..., 0], batch["masks"].float())
            + L.bce_with_logits(class_logits[..., 0], batch["labels"].float()))


def class_targets(masks_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Palette masks -> the class task's targets (:281-291,
    ``ClassImageDataset``): the uint8 any-animal mask (cat, dog or the
    uncertain border) and the fp32 label, 0 for an image with a cat pixel,
    1 without."""
    seg = ((masks_u8 == CAT_PALETTE) | (masks_u8 == DOG_PALETTE)
           | (masks_u8 == UNCERTAIN_PALETTE)).to(torch.uint8)
    labels = 1.0 - (masks_u8 == CAT_PALETTE).flatten(1).any(1).float()
    return seg, labels


def _lecun_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    t = torch.empty(w.shape)
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
    w.copy_(t)


def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers, drawn on the CPU from ``generator`` whatever
    the model's device: lecun-normal conv, ConvTranspose and Dense kernels
    (the patch conv's too, which has no bias), zero biases, BatchNorm scale
    1, bias 0, mean 0, var 1, LayerNorm scale 1, bias 0, and normal(0.02)
    class and position embeddings.  The cross-attention fusion's q_proj and
    k_proj are zero: the JAX models call it with one context token and
    never create them, as their exported trees say."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                cin = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
                _lecun_(w, cin * w.shape[2] * w.shape[3], generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Linear):
                _lecun_(m.weight, m.in_features, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.reset_parameters()
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * _EMBED_STD)
            elif isinstance(m, ClipEmbeddings):
                e = m.class_embedding
                e.copy_(torch.randn(e.shape, generator=generator) * _EMBED_STD)
            elif isinstance(m, CrossAttentionFusion):
                for i in (0, 1):
                    m.proj_weight(i).zero_()
                _lecun_(m.proj_weight(2), m.kv_dim, generator)
                m.cross_attn.in_proj_bias.zero_()  # out_proj: the nn.Linear branch


def jax_param_count(model: nn.Module) -> int:
    """The number of parameters of the model's JAX tree
    (``jax_from_state_dict``): every parameter, less the cross-attention
    fusion's q_proj and k_proj, which the JAX models, calling it with one
    context token, never create."""
    n = sum(p.numel() for p in model.parameters())
    for m in model.modules():
        if isinstance(m, CrossAttentionFusion):
            n -= sum(m.proj_weight(i).numel() for i in (0, 1)) + 2 * m.embed_dim
    return n


def _dataset_from_config(cfg: TrainConfig, train: bool, keep_raw_masks: bool = False,
                         split: Optional[str] = None) -> ArrayDataset:
    """The split of ``cfg.data`` (JAX :112-128): synthetic data from the
    seed (one evaluation split, whatever ``split`` names), or the
    Oxford-IIIT-Pet split ``split`` (default the config's train or
    validation split) through ``load_pet_dataset``."""
    d = cfg.data
    if d.dataset != "synthetic":
        split = split or (d.train_split if train else d.val_split)
        return load_pet_dataset(split=split,
                                dataset_loc=d.dataset_loc, cache=d.cache,
                                keep_raw_masks=keep_raw_masks)
    return synthetic_dataset(
        length=d.synthetic_length, height=d.image_size, width=d.image_size,
        num_classes=d.num_classes, seed=cfg.seed + (0 if train else 1),
        keep_raw_masks=keep_raw_masks,
    )


Inputs = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


class Trainer:
    """The JAX ``Trainer`` (:131): one device a process, any number of
    ranks (the module doc).

    ``device`` is where the model, the optimizer state and the batches live
    (the card unless the caller asks for the CPU); the initial weights are
    drawn from a ``torch.Generator`` seeded with ``config.seed``, so they do
    not depend on the device.  The task follows the model and the loss as
    in JAX (:170-177): ``clip_unet_prompt`` trains the prompt task and
    ``clip_res_class`` the class task, both on the raw palette masks,
    ``loss="mse"`` the reconstruction task, everything else the
    segmentation task.  With ``augmentations_per_datapoint > 0``
    the train batches go through the task's augmentor with the JAX
    Trainer's backend and geometry (:190-196) — except for reconstruction,
    which JAX never augments (:313) while its pipeline still repeats each
    image ``aug + 1`` times an epoch.
    """

    def __init__(
        self,
        config: TrainConfig,
        *,
        device="cuda",
        train_data: Optional[ArrayDataset] = None,
        val_data: Optional[ArrayDataset] = None,
        run_dir: Optional[str] = None,
        make_artifacts: bool = True,
    ):
        self.grid = mesh.make_grid(config.n_model_shards)
        if config.batch_size % self.grid.n_data:
            raise ValueError(f"batch_size {config.batch_size} must be divisible by the "
                             f"{self.grid.n_data} data rows ({mesh.world_size()} ranks, "
                             f"{self.grid.n_model} a model group)")
        self.config = config
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if config.bf16 else torch.float32
        self.model = build_model(config.model, device=self.device, dtype=self.dtype,
                                 **config.model_args)
        init_weights_(self.model, torch.Generator().manual_seed(config.seed))
        mesh.broadcast_(self.model.state_dict().values())  # the same on every rank
        if config.model == "clip_unet_prompt":
            self.task = "prompt"
        elif config.model == "clip_res_class":
            self.task = "class"
        elif config.loss == "mse":
            self.task = "reconstruction"
        else:
            self.task = "segmentation"
        self.model_name = type(self.model).__name__
        self.num_params = jax_param_count(self.model)
        info_params = None
        if make_artifacts and mesh.is_main():
            info_params = jax_from_state_dict(self.model.state_dict())[0]
        # tensor parallelism: this rank's slices of the sharded weights
        self.tp_plan = tp_plan({k: tuple(p.shape) for k, p in self.model.named_parameters()},
                               self.grid.n_model)
        tensor.shard_module_(self.model, self.tp_plan, self.grid.model_rank, self.grid.n_model)
        self.optimizer = build_optimizer(config.optimizer, self.model)
        self.trainable = trainable_parameters(self.model)
        self.frozen = len(self.trainable) < len(list(self.model.parameters()))
        # an unfrozen tower (freeze_clip=False) requires grad outside the
        # optimizer: the backward then goes to the trainable leaves alone
        self._backward_inputs = None
        if sum(p.requires_grad for p in self.model.parameters()) > len(self.trainable):
            self._backward_inputs = self.trainable
        self.step = 0
        # where train() goes on: the next epoch and its next batch
        self.epoch, self.batch = 0, 0
        self.loss_fn = make_loss_fn(config.loss)
        self.is_binary = config.loss == "hybrid_binary"
        aug_n = config.data.augmentations_per_datapoint
        aug_cls = DataAugmentorPrompt if self.task == "prompt" else DataAugmentor
        augments = aug_n > 0 and self.task != "reconstruction"
        self.augmentor = aug_cls(aug_n) if augments else None
        raw = self.task in ("prompt", "class")
        self.train_data = train_data or _dataset_from_config(config, True, raw)
        self.val_data = val_data or _dataset_from_config(config, False, raw)

        self.run_dir = run_dir
        if make_artifacts and mesh.is_main():
            if run_dir is None:
                self.run_dir = io_lib.get_next_run_folder(
                    os.path.join(config.save_dir, self.model_name))
            os.makedirs(self.run_dir, exist_ok=True)
            io_lib.write_csv_header(self.run_dir)
            io_lib.save_training_info(
                self.run_dir, model_name=self.model_name, config=config,
                num_params=self.num_params,
                train_dataset_size=len(self.train_data) * (aug_n + 1),
                val_dataset_size=len(self.val_data),
                params=info_params)
        # every rank checkpoints where rank 0 writes (save waits on all)
        self.run_dir = mesh.broadcast_object(self.run_dir)

    def _generator(self, step_key: int, stream: int) -> torch.Generator:
        """The host generator of one step's draws; ``stream`` tells the
        augmentation (0) and the prompts (1) apart."""
        words = [self.config.seed, step_key] + ([stream] if stream else [])
        seed = np.random.SeedSequence(words).generate_state(1)[0]
        return torch.Generator().manual_seed(int(seed))

    def augment_params(self, n: int, step_key: int) -> AugmentParams:
        """The augmentation draws of the step ``step_key`` for a batch of n,
        on the host, from a generator seeded by ``(config.seed, step_key)``."""
        return self.augmentor.sample(n, self._generator(step_key, 0))

    def prompt_draws(self, n: int, step_key: int) -> PromptDraws:
        """The prompt draws (two uniforms per image) of the step
        ``step_key``, on the host."""
        return sample_prompt_draws(n, self._generator(step_key, 1))

    def _to_device(self, draws):
        """Host draws to the device: from pinned memory, without a wait, to a card."""
        if self.device.type == "cuda":
            return draws.pin_memory().to(self.device, non_blocking=True)
        return draws.to(self.device)

    @staticmethod
    def _rows(n: int) -> Tuple[int, slice]:
        """The global batch's rows and this rank's slice of them (its data
        row's), for a rank holding n rows (the global batch itself with one
        data row and inside ``mesh.local``)."""
        if not mesh.active():
            return n, slice(0, n)
        r = mesh.data_rank()
        return n * mesh.data_size(), slice(r * n, (r + 1) * n)

    def prompt_points(self, masks_u8: torch.Tensor, step_key: int):
        """``(choice, cy, cx)`` of the step's prompts, on the device: the
        draws of the global batch, sliced to this rank's rows."""
        n, rows = self._rows(masks_u8.shape[0])
        draws = self.prompt_draws(n, step_key).rows(rows)
        return prompt_points(masks_u8, self._to_device(draws))

    def _prepare_batch(self, images_u8: torch.Tensor, masks_u8: torch.Tensor, *,
                       augment: bool, params: Optional[AugmentParams] = None,
                       points=None, offset: int = 0) -> Tuple[Inputs, Dict[str, torch.Tensor]]:
        """uint8 device batch -> (model inputs, {"masks": int64 targets}).

        reconstruction: inputs the [0, 1] fp32 images, targets
        ``{"images": the same}``; segmentation: inputs the [0, 1] fp32
        images, targets the class ids,
        through the augmentor with ``params`` when ``augment`` and the
        Trainer has one; class: the same on the any-animal mask of the
        palette masks, and ``"labels"`` (:func:`class_targets`, taken
        before the augmentation); prompt: inputs ``(images, prompt maps)``,
        targets the binary labels of the prompts at ``points`` =
        ``(choice, cy, cx)`` made from the palette masks (:299-312), the
        three through the prompt augmentor likewise.  ``offset``: the
        first row's position in the global batch (the clean slots')."""
        augmenting = augment and self.augmentor is not None
        if augmenting:
            if params is None:
                raise ValueError("an augmented batch needs its AugmentParams")
            params = self._to_device(params)
        if self.task == "reconstruction":
            images = normalize_image(images_u8)
            return images, {"images": images}
        if self.task == "prompt":
            if points is None:
                raise ValueError("a prompt batch needs its points")
            heat, labels = prompt_maps(masks_u8, *points, self.config.data.prompt_gaussian_sigma)
            if augmenting:
                images, masks, heat = self.augmentor.apply_u8(
                    params, images_u8, labels.to(torch.uint8), heat, offset=offset)
                return (images, heat), {"masks": masks}
            return (normalize_image(images_u8), heat), {"masks": labels.long()}
        extra = {}
        if self.task == "class":
            masks_u8, extra["labels"] = class_targets(masks_u8)
        if augmenting:
            images, masks = self.augmentor.apply_u8(params, images_u8, masks_u8, offset=offset)
            return images, {"masks": masks, **extra}
        return normalize_image(images_u8), {"masks": masks_u8.long(), **extra}

    def train_step(self, images_u8: torch.Tensor, masks_u8: torch.Tensor,
                   step_key: int = 0) -> torch.Tensor:
        """One optimizer step on one batch (this rank's rows of the global
        batch) with the draws of ``step_key``; returns the global batch's
        loss, on the device.  Profiler spans (``utils.spans``):
        ``train_step`` (the step key its argument), ``prepare``, the model's
        blocks, ``loss`` and ``optimizer``."""
        with spans.span("train_step", str(step_key)):
            with spans.span("prepare"):
                n, rows = self._rows(images_u8.shape[0])
                params = None
                if self.augmentor is not None:
                    params = self.augment_params(n, step_key).rows(rows)
                points = (self.prompt_points(masks_u8, step_key) if self.task == "prompt"
                          else None)
                inputs, batch = self._prepare_batch(images_u8, masks_u8, augment=True,
                                                    params=params, points=points,
                                                    offset=rows.start)
            return self.optimize(inputs, batch)

    def optimize(self, inputs: Inputs, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Forward, loss, backward, the gradients averaged over ranks, and
        Adam on a prepared batch; returns the loss, on the device.  A
        trainable parameter without a gradient gets a zero one (see the
        module doc)."""
        inputs = inputs if isinstance(inputs, tuple) else (inputs,)
        self.optimizer.zero_grad(set_to_none=True)
        loss = spans.block("loss", self.loss_fn, self._train_forward(inputs), batch)
        loss.backward(inputs=self._backward_inputs)
        with spans.span("optimizer"):
            for p in self.trainable:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            mesh.average_gradients(self.trainable)
            self.optimizer.step()
        self.step += 1
        return loss.detach()

    def _train_forward(self, inputs: Tuple[torch.Tensor, ...]):
        """The training forward; under ``remat`` checkpointed whole, its
        recomputation committing no running average (module doc)."""
        forward = functools.partial(self.model, train=True)
        if not self.config.remat:
            return forward(*inputs)
        return checkpoint(
            forward, *inputs, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), no_commits()))

    @torch.no_grad()
    def eval_step(self, images_u8: torch.Tensor, masks_u8: torch.Tensor,
                  step_key: int = EVAL_STEP_KEY):
        """(loss, IoU, pixel accuracy, dice) of one batch with the running
        statistics, on the device; the binary metrics for the binary loss
        and, on the mask logits, for the class task; for reconstruction the
        loss and three zeros (:364-374).  Profiler spans (``utils.spans``):
        ``eval_step`` (the step key its argument), ``prepare``, the model's
        blocks and ``metrics``."""
        with spans.span("eval_step", str(step_key)):
            with spans.span("prepare"):
                points = (self.prompt_points(masks_u8, step_key) if self.task == "prompt"
                          else None)
                inputs, batch = self._prepare_batch(images_u8, masks_u8, augment=False,
                                                    points=points)
            inputs = inputs if isinstance(inputs, tuple) else (inputs,)
            logits = self.model(*inputs, train=False)
            with spans.span("metrics"):
                return self._metrics(logits, batch)

    def _metrics(self, logits, batch: Dict[str, torch.Tensor]):
        """(loss, IoU, pixel accuracy, dice) of the eval step (its doc)."""
        if self.task == "reconstruction":
            zero = torch.zeros((), device=logits.device)
            return self.loss_fn(logits, batch), zero, zero, zero
        masks, loss = batch["masks"], self.loss_fn(logits, batch)
        if self.task == "class":
            logits = logits[0]
        if self.is_binary or self.task == "class":
            metrics = (L.iou_binary, L.pixel_accuracy_binary, L.dice_score_binary)
        else:
            metrics = (L.iou, L.pixel_accuracy, L.dice_score)
        return (loss, *(f(logits, masks) for f in metrics))

    def _pipelines(self):
        """The train pipeline (the C++ loader with ``native_loader`` where
        it builds, else the Python one, as JAX :394-401) and the
        validation pipeline."""
        cfg = self.config
        train_cls = BatchPipeline
        if cfg.native_loader:
            from ..data import native_loader

            if native_loader.native_loader_available():
                train_cls = native_loader.NativeBatchPipeline
            if mesh.is_main():
                print("train loader: native" if train_cls is not BatchPipeline
                      else "train loader: python (the native one did not build)", flush=True)
        val_pipe = BatchPipeline(self.val_data, cfg.batch_size, device=self.device,
                                 shuffle=False, drop_last=False, seed=cfg.seed,
                                 mask_attr=self._mask_attr())
        return self._train_pipeline(train_cls), val_pipe

    def _mask_attr(self) -> str:
        return "raw_masks" if self.task in ("prompt", "class") else "masks"

    def _train_pipeline(self, cls=BatchPipeline) -> BatchPipeline:
        cfg = self.config
        return cls(self.train_data, cfg.batch_size, device=self.device,
                   augmentations_per_datapoint=cfg.data.augmentations_per_datapoint,
                   shuffle=True, drop_last=True, seed=cfg.seed, mask_attr=self._mask_attr())

    def train(self, num_epochs: Optional[int] = None, *, verbose: bool = False) -> Dict[str, Any]:
        """The next ``num_epochs`` epochs, each followed by :meth:`evaluate`
        (after :meth:`restore`, from the checkpoint's next batch on; the
        train loss of that first epoch is the mean of the batches run here);
        returns ``{"history": [{epoch, train_loss, rate, val_*}, ...]}``."""
        cfg = self.config
        num_epochs = num_epochs if num_epochs is not None else cfg.num_epochs
        train_pipe, val_pipe = self._pipelines()
        history = []
        for _ in range(num_epochs):
            epoch, first = self.epoch, self.batch
            t0 = time.perf_counter()
            loss_sum = torch.zeros((), device=self.device)
            n_batches = 0
            for n, (images, masks) in enumerate(
                    itertools.islice(train_pipe.epoch(epoch), first, None), first):
                loss_sum += self.train_step(images, masks, epoch * 100003 + n)
                n_batches += 1
            self.epoch, self.batch = epoch + 1, 0
            train_loss = float(loss_sum / max(n_batches, 1))  # one sync per epoch
            dt = time.perf_counter() - t0
            rate = n_batches * cfg.batch_size / dt if dt > 0 else 0.0
            row = dict(epoch=epoch, train_loss=train_loss, rate=rate, **self.evaluate(val_pipe))
            history.append(row)
            if verbose and mesh.is_main():
                print(f"Epoch: {epoch}\nRate: {rate:.1f} datapoints/s\n"
                      f"Train Loss: {train_loss:.4f}\n"
                      f"Validation Loss: {row['val_loss']:.4f}\n"
                      f"Val IoU: {row['val_iou']:.4f}\n"
                      f"Val Pixel Accuracy: {row['val_pixel_accuracy']:.4f}\n"
                      f"Val Dice: {row['val_dice']:.4f}\n" + format_memory_report(), flush=True)
            if self.run_dir and mesh.is_main():
                io_lib.log_loss_to_csv(epoch, train_loss, row["val_loss"],
                                       row["val_pixel_accuracy"], row["val_dice"],
                                       row["val_iou"], self.run_dir)
            if self.run_dir and (epoch + 1) % cfg.checkpoint_every == 0:
                self.save(os.path.join(self.run_dir, f"model_{epoch + 1}.npz"))
        return {"history": history}

    def evaluate(self, val_pipe: Optional[BatchPipeline] = None) -> Dict[str, float]:
        """Mean over the validation batches of the eval step's metrics, each
        the global batch's (a remainder batch that the ranks do not divide
        is whole on every rank, and its metrics are taken there alone)."""
        if val_pipe is None:
            _, val_pipe = self._pipelines()
        sums, n = None, 0
        for images, masks in val_pipe.epoch(0):
            with mesh.local() if val_pipe.replicated(n) else contextlib.nullcontext():
                out = self.eval_step(images, masks, EVAL_STEP_KEY + n)
            sums = out if sums is None else tuple(a + b for a, b in zip(sums, out))
            n += 1
        if n == 0:
            return dict(val_loss=0.0, val_iou=0.0, val_pixel_accuracy=0.0, val_dice=0.0)
        loss, iou_v, pa, dice = (float(s / n) for s in sums)
        return dict(val_loss=loss, val_iou=iou_v, val_pixel_accuracy=pa, val_dice=dice)

    # ------------------------------------------------------------- resume
    def state_tree(self) -> Dict[str, Any]:
        """The JAX Trainer state of this Trainer (params, batch_stats, the
        Adam state, step) as nested numpy dicts (``utils/checkpoint.py``),
        the sharded leaves and their moments made whole (every rank of the
        model group must call)."""
        whole = functools.partial(tensor.full_state, self.model) if self.tp_plan else None
        return ckpt_lib.state_tree(self.model, self.optimizer, self.step, self.frozen,
                                   whole=whole)

    def save(self, path: str) -> None:
        """Write :meth:`state_tree` as a checkpoint in JAX's ``.npz`` layout:
        rank 0 writes (the state is the same on every rank; sharded leaves
        are gathered on every rank first), every rank returns once the file
        is there."""
        tree = self.state_tree() if mesh.is_main() or self.tp_plan else None
        if mesh.is_main():
            ckpt_lib.save_checkpoint(path, tree)
        mesh.barrier()

    def restore(self, path: str) -> None:
        """Load a checkpoint of either package (JAX :505): the parameters,
        the BatchNorm running statistics, Adam's moments and count, and the
        step, from which :meth:`train` goes on (the module doc), each
        sharded leaf sliced to this rank (JAX :507-510).  Strict: a missing
        key or a wrong shape raises."""
        tree = ckpt_lib.restore_into(self.state_tree(), path)
        local = functools.partial(tensor.local_state, self.model) if self.tp_plan else None
        self.step = ckpt_lib.load_state_tree(tree, self.model, self.optimizer, self.frozen,
                                             local=local)
        # the Python pipeline counts the batches the native one gives
        per_epoch = self._train_pipeline().batches_per_epoch()
        self.epoch, self.batch = divmod(self.step, max(per_epoch, 1))
