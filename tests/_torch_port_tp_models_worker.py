"""The work of one rank for tests/test_torch_port_tensor_parallel_models.py:
the port only (torch, no jax), run either in the test process at world
size 1 or in each of the ranks that ``parallel.mesh.launch`` starts.

``run(out_dir, n_model)`` trains one step of each of ``CONFIGS`` on one
global batch and writes ``<out_dir>/tpm<R>_<r>.npz`` (gradients,
parameters and buffers after the step, the sharded leaves made whole over
the model group, and at M > 1 the initial state of the models held to
JAX), and
returns the small results as JSON-able values: the losses, the evaluation
of the reconstruction and class tasks, the frozen backbone's checks, a
checkpoint of ``clip_res`` restored and stepped against the unbroken run,
the blocks that ``fused_deep`` picks, and ``prompt_fusion``'s first step.

The configurations: the ``autoencoder`` preset's model args (its own
widths, 32/64), and the same with ``w2d_impl="pallas"`` (the unfused
blocks, each conv one ``Conv3x3Function``), the ``clip_res``, ``segment_classifier`` and
``clip_autoencoder`` presets' with the small tower of ``__graft_entry__.py``,
and the ``unet`` preset's at stem 16, encoders 16/32/64 with
``fused_deep=True`` and ``remat=True``, together and each alone; 32x32
images, a global batch of 8, ``bf16=False``, Adam eps 1e-3.  The
segmentation and class tasks take one augmented step, and the ClipRes
models one more unaugmented (``*_noaug``, the step held to JAX); the
reconstruction task never augments, and ``clip_autoencoder`` steps
unaugmented, as the JAX Trainer it is held to does there.

The step held to world 1 computes in float64 (``build_model(dtype=
torch.float64)`` under the Trainer, its parameters, gradients and Adam
state fp32).  In fp32 a step at (2, 2) is not world 1's to STEP_TOL in
every model: the data rows' partial sums of the BatchNorm statistics,
added in another order, move a value within rounding of a ReLU's kink
to its other side (the autoencoder at (2, 1) alone, with no model axis,
is 0.6 % off world 1 so), which float64 leaves far out of reach.  The
same float64 step at (2, 2) is the one held to JAX's Trainer in float64.
"""

import os

import numpy as np
import torch

from image_segmentation_tpu_torch import config
from image_segmentation_tpu_torch.data.datasets import (
    CAT_PALETTE,
    DOG_PALETTE,
    UNCERTAIN_PALETTE,
    ArrayDataset,
)
from image_segmentation_tpu_torch.engine.train import Trainer
from image_segmentation_tpu_torch.entry import SMALL_TOWER
from image_segmentation_tpu_torch.models.resnet import BasicBlock
from image_segmentation_tpu_torch.parallel import mesh, tensor
from image_segmentation_tpu_torch.utils.convert import leaves
from tests._torch_port_tp_worker import _mine, float64_compute
from tests._torch_port_tp_worker import _state as state

GLOBAL_BATCH = 8
SIZE = 32
ADAM_EPS = 1e-3
STEP_KEYS = (5, 6)
EVAL_LENGTH = 12
UNET = dict(stem_features=16, encoder_features=(16, 32, 64))
# name: (preset, model args over the preset's, TrainConfig fields, augmentations)
CONFIGS = {
    "autoencoder": ("autoencoder", {}, {}, 0),
    "autoencoder_unfused": ("autoencoder", {"w2d_impl": "pallas"}, {}, 0),
    "clip_res": ("clip_res", {"clip_kwargs": SMALL_TOWER}, {}, 1),
    "clip_res_class": ("segment_classifier", {"clip_kwargs": SMALL_TOWER}, {}, 1),
    "clip_autoencoder": ("clip_autoencoder", {"clip_kwargs": SMALL_TOWER}, {}, 0),
    # unaugmented, for JAX's Trainer
    "clip_res_noaug": ("clip_res", {"clip_kwargs": SMALL_TOWER}, {}, 0),
    "clip_res_class_noaug": ("segment_classifier", {"clip_kwargs": SMALL_TOWER}, {}, 0),
    "unet_fused_deep_remat": ("unet", dict(UNET, fused_deep=True), {"remat": True}, 1),
    "unet_fused_deep": ("unet", dict(UNET, fused_deep=True), {}, 1),
    "unet_remat": ("unet", UNET, {"remat": True}, 1),
}
# held to JAX's Trainer on a (2, 2) mesh too: their initial state is kept at (2, 2)
JAX_HELD = ("autoencoder", "clip_autoencoder", "clip_res_noaug", "clip_res_class_noaug")
# the ResNet-34 backbone's keys in the ClipRes models
BACKBONE = "encoder.model."


def cfg(name: str, n_model: int = 1) -> config.TrainConfig:
    pre_name, args, fields, aug = CONFIGS[name]
    pre = config.preset(pre_name)
    return config.TrainConfig(
        model=pre.model, model_args={**pre.model_args, **args}, loss=pre.loss,
        batch_size=GLOBAL_BATCH, num_epochs=1, bf16=False, seed=0, n_model_shards=n_model,
        optimizer=config.OptimizerConfig(eps=ADAM_EPS), **fields,
        data=config.DataConfig(dataset="synthetic", synthetic_length=GLOBAL_BATCH,
                               image_size=SIZE, augmentations_per_datapoint=aug))


def trainer(name: str, n_model: int = 1) -> Trainer:
    """The Trainer of ``cfg(name, n_model)`` on the CPU, its model computing
    in float64 (the module doc)."""
    with float64_compute():
        return Trainer(cfg(name, n_model), device="cpu", make_artifacts=False)


def global_batch(name: str, seed: int = 21, n: int = GLOBAL_BATCH):
    """uint8 images and masks: class ids, or for the class task palette
    masks in which every other image has no cat."""
    rng = np.random.default_rng(seed)
    masks = rng.integers(0, 3, (n, SIZE, SIZE)).astype(np.uint8)
    if name.startswith("clip_res_class"):
        palette = np.array([0, CAT_PALETTE, DOG_PALETTE, UNCERTAIN_PALETTE], np.uint8)
        masks = palette[rng.integers(0, 4, (n, SIZE, SIZE))]
        masks[::2][masks[::2] == CAT_PALETTE] = DOG_PALETTE
    return rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8), masks


def _blocks(t: Trainer) -> list:
    """(name, class) of each block of a U-Net, in order."""
    m = t.model
    return [[n, type(getattr(m, n)).__name__] for n in [*m.encoders, "bottleneck", *m.decoders]]


def _backbone(t: Trainer) -> tuple:
    """The backbone's whole parameters and its running statistics, cloned."""
    params = tensor.full_state(t.model, dict(t.model.named_parameters()))
    params = {k: v.detach().clone() for k, v in params.items() if k.startswith(BACKBONE)}
    stats = {k: v.clone() for k, v in t.model.named_buffers()
             if k.startswith(BACKBONE) and not k.endswith("num_batches_tracked")}
    return params, stats


def _resume(t: Trainer, name: str, out_dir: str, result: dict) -> None:
    """Save ``t`` after its step, restore into a fresh Trainer, one more
    step of both: the keys whose state (parameters, running statistics,
    Adam's moments, made whole) differ, and the backbone's shards."""
    n_model = mesh.model_size()
    images, masks = global_batch(name)
    path = os.path.join(out_dir, f"ckpt_{name}{mesh.world_size()}.npz")
    t.save(path)
    b = trainer(name, n_model)
    b.restore(path)
    result["restored_step"] = b.step
    result["backbone_sharded"] = sorted(k for k in b.tp_plan if k.startswith(BACKBONE))
    for x in (t, b):
        x.train_step(_mine(images), _mine(masks), STEP_KEYS[1])
    unbroken, resumed = ({"/".join(p): np.asarray(v) for p, v in leaves(x.state_tree())}
                         for x in (t, b))
    result["resume_keys"] = len(unbroken)
    result["resume_differ"] = sorted(k for k in unbroken if k not in resumed
                                     or not np.array_equal(unbroken[k], resumed[k]))


def run(out_dir: str, n_model: int) -> dict:
    arrays = {}
    result = {"world": mesh.world_size(), "rank": mesh.rank(), "loss": {}, "plan": {},
              "eval": {}}
    for name in CONFIGS:
        images, masks = global_batch(name)
        t = trainer(name, n_model)
        result["plan"][name] = sorted(t.tp_plan)
        if name.startswith("unet_fused_deep"):
            result["blocks"] = _blocks(t)
        if name == "clip_res":
            before, stats_before = _backbone(t)
        if name in JAX_HELD and n_model > 1:  # the initial state JAX's step starts from
            arrays.update(state(t, f"{name}/init/"))
        result["loss"][name] = float(t.train_step(_mine(images), _mine(masks), STEP_KEYS[0]))
        arrays.update(state(t, f"{name}/"))
        if name == "clip_res":
            after, stats_after = _backbone(t)
            result["backbone_changed"] = sorted(k for k in before
                                                if not torch.equal(before[k], after[k]))
            result["backbone_stats_moved"] = sum(not torch.equal(stats_before[k], stats_after[k])
                                                 for k in stats_before)
            result["backbone_stats"] = len(stats_before)
            result["basic_blocks"] = sum(isinstance(m, BasicBlock) for m in t.model.modules())
            _resume(t, name, out_dir, result)
        if name in ("autoencoder", "clip_res_class"):
            val_images, val_masks = global_batch(name, seed=22, n=EVAL_LENGTH)
            raw = val_masks if name == "clip_res_class" else None
            t.val_data = ArrayDataset(val_images, val_masks, raw)
            result["eval"][name] = t.evaluate()
        del t

    # prompt_fusion: two inputs and no task in JAX's Trainer; the first step raises
    pf = config.TrainConfig(
        model="prompt_fusion", batch_size=GLOBAL_BATCH, bf16=False, n_model_shards=n_model,
        data=config.DataConfig(dataset="synthetic", synthetic_length=GLOBAL_BATCH,
                               image_size=SIZE, augmentations_per_datapoint=0))
    t = Trainer(pf, device="cpu", make_artifacts=False)
    result["plan"]["prompt_fusion"] = sorted(t.tp_plan)
    images, masks = global_batch("prompt_fusion")
    try:
        t.train_step(_mine(images), _mine(masks), STEP_KEYS[0])
        result["prompt_fusion"] = "no error"
    except TypeError as e:
        result["prompt_fusion"] = f"TypeError: {e}"
    np.savez(os.path.join(out_dir, f"tpm{mesh.world_size()}_{mesh.rank()}.npz"), **arrays)
    mesh.barrier()
    return result
