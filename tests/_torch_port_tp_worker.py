"""The work of one rank for tests/test_torch_port_tensor_parallel.py: the
port only (torch, no jax), run either in the test process at world size 1
or in each of the ranks that ``parallel.mesh.launch`` starts.

``run(out_dir, n_model)`` writes ``<out_dir>/tp<R>_<r>.npz`` (every array a
check reads, the sharded leaves made whole over the model group) and
returns the small results as JSON-able values, every preset built at M
among them (``built_presets``); ``run_cli(save_dir)`` trains the
``smoke`` preset through ``cli.train_distributed --model-shards 2``.
The models: ``large_unet`` with the preset's model args at stem 16,
encoders 32/64 (levels 0-1 on the kernel blocks; at M = 2 the rule shards
both convs of enc1 and enc2, the dec1/dec2 up-convs, and dec3's conv1 but
not its conv2), and ``clip_unet``/``clip_unet_prompt`` with the small tower
of ``__graft_entry__.py`` (their presets' model args), 32x32 images, a
global batch of 8, ``bf16=False``, Adam eps 1e-3.
"""

import contextlib
import dataclasses
import os

import numpy as np
import torch

from image_segmentation_tpu_torch import config
from image_segmentation_tpu_torch.data.datasets import ArrayDataset
from image_segmentation_tpu_torch.data.native_loader import NativeBatchPipeline
from image_segmentation_tpu_torch.data.pipeline import BatchPipeline
from image_segmentation_tpu_torch.engine.train import Trainer
from image_segmentation_tpu_torch.entry import SMALL_TOWER
from image_segmentation_tpu_torch.parallel import mesh, tensor

NARROW = dict(stem_features=16, encoder_features=(32, 64))
GLOBAL_BATCH = 8
SIZE = 32
ADAM_EPS = 1e-3
STEP_KEYS = (5, 6)
EVAL_LENGTH = 12
PRESET = {"large_unet": "large_unet", "clip_unet": "clip_unet", "clip_unet_prompt": "prompt"}
# the layouts of tests/test_mesh_shapes.py at 4 ranks: M of (data, model)
LAYOUTS = (1, 2, 4)
# every name of config.preset
PRESETS = ("unet", "large_unet", "clip_unet", "clip_res", "clip_autoencoder", "autoencoder",
           "segment_classifier", "prompt", "smoke")


def cfg(model: str = "large_unet", n_model: int = 1, aug: int = 1) -> config.TrainConfig:
    pre = config.preset(PRESET[model])
    extra = NARROW if model == "large_unet" else {"clip_kwargs": SMALL_TOWER}
    return config.TrainConfig(
        model=model, model_args={**pre.model_args, **extra}, loss=pre.loss,
        batch_size=GLOBAL_BATCH, num_epochs=1, bf16=False, seed=0, n_model_shards=n_model,
        optimizer=config.OptimizerConfig(eps=ADAM_EPS),
        data=config.DataConfig(dataset="synthetic", synthetic_length=GLOBAL_BATCH,
                               image_size=SIZE, augmentations_per_datapoint=aug))


def global_batch(model: str = "large_unet", seed: int = 21):
    """uint8 images and masks (the Pet palette for the prompt task)."""
    rng = np.random.default_rng(seed)
    masks = rng.integers(0, 3, (GLOBAL_BATCH, SIZE, SIZE)).astype(np.uint8)
    if model == "clip_unet_prompt":
        masks = np.array([0, 38, 75], np.uint8)[masks]
    return rng.integers(0, 256, (GLOBAL_BATCH, SIZE, SIZE, 3), dtype=np.uint8), masks


def _mine(a: np.ndarray) -> torch.Tensor:
    """This rank's rows: its data row's."""
    return torch.from_numpy(a[mesh.rows(len(a))])


def _state(t: Trainer, prefix: str) -> dict:
    """Gradients, parameters and buffers of a Trainer, flat, the sharded
    ones made whole."""
    whole = lambda values: tensor.full_state(t.model, values)  # noqa: E731
    params = whole(dict(t.model.named_parameters()))
    grads = whole({k: p.grad for k, p in t.model.named_parameters() if p.grad is not None})
    out = {f"{prefix}param/{k}": v.detach().numpy().copy() for k, v in params.items()}
    out.update({f"{prefix}grad/{k}": v.numpy().copy() for k, v in grads.items()})
    out.update({f"{prefix}buffer/{k}": b.numpy().copy() for k, b in t.model.named_buffers()})
    return out


def _step(model: str, n_model: int, aug: int, prefix: str, arrays: dict,
          points=None) -> Trainer:
    """One train step of the global batch, its initial and final state in
    ``arrays``; the prompt task takes the global batch's ``points``
    ``(choice, cy, cx)`` when given (JAX's draws)."""
    images, masks = global_batch(model)
    t = Trainer(cfg(model, n_model, aug), device="cpu", make_artifacts=False)
    arrays.update(_state(t, f"{prefix}init/"))
    if points is None:
        loss = t.train_step(_mine(images), _mine(masks), STEP_KEYS[0])
    else:
        mine = tuple(_mine(np.asarray(p, np.int64)) for p in points)
        loss = t.optimize(*t._prepare_batch(_mine(images), _mine(masks), augment=False,
                                            points=mine))
    t.last_loss = float(loss)
    arrays.update(_state(t, prefix))
    return t


def _norm(t: Trainer) -> float:
    """The L2 norm of every parameter after the step (tests/test_mesh_shapes.py)."""
    params = tensor.full_state(t.model, dict(t.model.named_parameters()))
    return float(np.sqrt(sum(np.sum(p.detach().double().numpy() ** 2) for p in params.values())))


def built_presets(n_model: int) -> dict:
    """Every preset's Trainer at ``n_model`` shards, and the ``unet``
    preset's with ``fused_deep`` and with ``remat`` (on 8 synthetic 32x32
    images, the CLIP models with the small tower): the number of
    parameters sharded.  Their steps:
    tests/test_torch_port_tensor_parallel_models.py."""
    cfgs = {name: config.preset(name) for name in PRESETS}
    for name, c in cfgs.items():
        if c.model.startswith("clip"):
            c.model_args = dict(c.model_args, clip_kwargs=SMALL_TOWER)
    unet = cfgs["unet"]
    cfgs["unet fused_deep"] = dataclasses.replace(
        unet, model_args=dict(unet.model_args, fused_deep=True))
    cfgs["unet remat"] = dataclasses.replace(unet, remat=True)
    out = {}
    for name, c in cfgs.items():
        c = dataclasses.replace(c, n_model_shards=n_model, data=config.DataConfig(
            dataset="synthetic", synthetic_length=GLOBAL_BATCH, image_size=SIZE))
        out[name] = len(Trainer(c, device="cpu", make_artifacts=False).tp_plan)
    return out


def run(out_dir: str, n_model: int, points=None) -> dict:
    """``points``: JAX's prompt points of ``global_batch("clip_unet_prompt")``
    for the unaugmented prompt step."""
    arrays = {}
    result = {"world": mesh.world_size(), "rank": mesh.rank()}

    # one augmented step against world 1, and the Trainer's evaluation
    t = _step("large_unet", n_model, 1, "aug/", arrays)
    result["plan"] = sorted(t.tp_plan)
    result["loss"] = t.last_loss
    images, masks = global_batch(seed=22)
    t.val_data = ArrayDataset(images[:EVAL_LENGTH], masks[:EVAL_LENGTH])
    result["eval"] = t.evaluate()

    # save -> restore -> one more step, against two unbroken steps
    images, masks = global_batch()
    path = os.path.join(out_dir, f"ckpt{mesh.world_size()}.npz")
    t.save(path)
    b = Trainer(cfg("large_unet", n_model, 1), device="cpu", make_artifacts=False)
    b.restore(path)
    result["restored_step"] = b.step
    for trainer in (t, b):
        trainer.train_step(_mine(images), _mine(masks), STEP_KEYS[1])
    arrays.update(_state(t, "unbroken/"))
    arrays.update(_state(b, "resumed/"))
    del t, b

    # one unaugmented step of each model that the JAX Trainer is held to
    result["noaug"] = {}
    for model in ("large_unet", "clip_unet_prompt"):
        nt = _step(model, n_model, 0, f"noaug/{model}/", arrays,
                   points if model == "clip_unet_prompt" else None)
        result["noaug"][model] = nt.last_loss
        del nt

    if mesh.world_size() > 1:
        # the rows of the first batch, and the native loader's refusal
        ds = ArrayDataset(*global_batch(seed=23))
        images, _ = next(iter(BatchPipeline(ds, GLOBAL_BATCH, device="cpu", seed=0).epoch(0)))
        result["rows"] = [int(v) for v in images.reshape(images.shape[0], -1).sum(1)]
        try:
            NativeBatchPipeline(ds, GLOBAL_BATCH, device="cpu", seed=0)
            result["native_loader"] = "accepted"
        except ValueError as e:
            result["native_loader"] = str(e)

        result["built"] = built_presets(n_model)

        # the layouts of tests/test_mesh_shapes.py: loss and updated-parameter norm
        result["layouts"] = {}
        for model in ("clip_unet", "clip_unet_prompt"):
            for m in LAYOUTS:
                images, masks = global_batch(model)
                lt = Trainer(cfg(model, m, 1), device="cpu", make_artifacts=False)
                loss = float(lt.train_step(_mine(images), _mine(masks), STEP_KEYS[0]))
                result["layouts"][f"{model}/{m}"] = [loss, _norm(lt)]
                if model == "clip_unet" and m == 2:
                    result["clip_plan"] = sorted(lt.tp_plan)
                del lt
    np.savez(os.path.join(out_dir, f"tp{mesh.world_size()}_{mesh.rank()}.npz"), **arrays)
    mesh.barrier()
    return result


def run_cli(save_dir: str) -> dict:
    """One epoch of ``cli.train_distributed --model-shards 2`` on the CPU,
    artifacts on (a checkpoint); returns the run folder and its files."""
    from image_segmentation_tpu_torch.cli import train_distributed

    trainer = train_distributed.main(["--preset", "smoke", "--epochs", "1", "--device", "cpu",
                                      "--model-shards", "2", "--save-dir", save_dir])
    return {"world": mesh.world_size(), "run_dir": trainer.run_dir, "plan": sorted(trainer.tp_plan),
            "files": sorted(os.listdir(trainer.run_dir))}


# ---- the card: the TP kernel blocks against their plain versions ------------

BLOCK_CASES = {
    # name: (block, block args, input shapes, the convs sharded)
    "encoder": ("FusedConvBlockDownsample", (32, 64), [(2, 32, 32, 32)],
                ("block.0.conv.0.weight", "block.0.conv.3.weight")),
    "decoder": ("FusedConvBlockUpsampleSkip", (64, 32), [(2, 16, 16, 64), (2, 32, 32, 32)],
                ("up.weight", "conv.conv.0.weight", "conv.conv.3.weight")),
    "conv1 only": ("FusedConvBlock", (32, 64), [(2, 32, 32, 32)], ("conv.0.weight",)),
    "conv2 only": ("FusedConvBlock", (32, 64), [(2, 32, 32, 32)], ("conv.3.weight",)),
    # the autoencoder's dec3: the ConvTranspose kernel and both convs on Co/2 = 16
    "upsample": ("FusedConvBlockUpsample", (64, 32), [(2, 16, 16, 64)],
                 ("up.weight", "conv.conv.0.weight", "conv.conv.3.weight")),
    # a fold-1 decoder of fused_deep: the standard up-conv, the block over [up | skip]
    "fold-1 decoder": ("FusedDeepConvBlockUpsampleSkip", (128, 64),
                       [(2, 8, 8, 128), (2, 16, 16, 64)],
                       ("up.weight", "conv.conv.0.weight", "conv.conv.3.weight")),
}


def run_block(device: str = "cuda") -> dict:
    """Each of ``BLOCK_CASES`` in training mode at (data=1, model=2): the
    block with its named convs sharded (this rank's ``Co/2`` slices) on the
    kernels, and the same block whole on the plain versions in bf16 and in
    fp32, from the same weights, inputs and output cotangent.  Returns, per
    case, the relative L2 errors of the output, the input gradients and
    each parameter's gathered gradient against the plain bf16 path, and of
    the plain bf16 path and the TP path against the fp32 one."""
    from unittest import mock

    from image_segmentation_tpu_torch.engine.train import init_weights_
    from image_segmentation_tpu_torch.models import fused
    from image_segmentation_tpu_torch.ops import fused_conv as fc

    grid = mesh.make_grid(2)
    out = {}
    for name, (cls, args, shapes, sharded) in BLOCK_CASES.items():
        gen = torch.Generator().manual_seed(len(out))
        ref_block = getattr(fused, cls)(*args, device=device)
        init_weights_(ref_block, gen)
        for m in ref_block.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                with torch.no_grad():
                    m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
                    m.bias.copy_(torch.rand(m.bias.shape, generator=gen) - 0.5)
        state = {k: v.clone() for k, v in ref_block.state_dict().items()}
        inputs = [torch.randn(s, generator=gen).to(device) for s in shapes]
        runs = {}
        for path, dtype in (("tp", torch.bfloat16), ("plain", torch.bfloat16),
                            ("fp32", torch.float32)):
            block = getattr(fused, cls)(*args, device=device)
            block.load_state_dict(state)
            if path == "tp":
                plan = {k: ((1 if k.endswith("up.weight") else 0), 0,
                            dict(block.named_parameters())[k].shape[
                                1 if k.endswith("up.weight") else 0]) for k in sharded}
                tensor.shard_module_(block, plan, grid.model_rank, grid.n_model)
                names = sorted(tensor.shards(block))
            xs = [x.to(dtype).requires_grad_() for x in inputs]
            with contextlib.ExitStack() as stack:
                if path != "tp":
                    for w in fc.WRAPPERS:
                        stack.enter_context(mock.patch.object(fc, w.__name__,
                                                              getattr(fc, w.__name__ + "_plain")))
                z = block(*xs, train=True)
                cot = torch.randn(z.shape, generator=torch.Generator().manual_seed(7)).to(device)
                (z.float() * cot).sum().backward()
            grads = {k: p.grad.float() for k, p in block.named_parameters()}
            if path == "tp":
                grads = tensor.full_state(block, grads)
            runs[path] = {"z": z.detach().float(), **{f"d{i}": x.grad.float()
                                                         for i, x in enumerate(xs)},
                          **{f"grad/{k}": g for k, g in grads.items()}}

        def rl2(a, b, key):
            scale = b[key].norm()
            if key.endswith(("conv.0.bias", "conv.3.bias")):  # cancelled by the BatchNorm
                scale = b[key[:-len("bias")] + "weight"].norm()
            return float((a[key] - b[key]).norm() / max(float(scale), 1e-30))

        out[name] = {k: [rl2(runs["tp"], runs["plain"], k), rl2(runs["plain"], runs["fp32"], k),
                         rl2(runs["tp"], runs["fp32"], k)] for k in runs["plain"]}
        out[name]["sharded"] = names
    return out
