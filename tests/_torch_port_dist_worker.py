"""The work of one rank for tests/test_torch_port_distributed.py: the port
only (torch, no jax), run either in the test process at world size 1 or
in each of the ranks that ``parallel.mesh.launch`` starts.

``run(out_dir)`` writes ``<out_dir>/rank<r>.npz`` (every array a check
reads) and returns the small results as JSON-able values;
``run_remat(out_dir)`` writes ``<out_dir>/remat<r>.npz``, the state after
two steps with and without ``remat`` (tests/test_torch_port_options.py);
``run_cli(save_dir)`` trains the ``smoke`` preset through
``cli.train_distributed`` with its run folder.  The model is
the ``large_unet`` preset's model args at the narrow widths of
tests/test_torch_port_train.py (stem 8, encoders 16/32/64/128: levels 0-1
on the kernel blocks, the deep levels on the plain BatchNorm), 32x32
images, a global batch of 16, ``bf16=False``, Adam eps 1e-3 (as there).
"""

import dataclasses
import os

import numpy as np
import torch

from image_segmentation_tpu_torch import config
from image_segmentation_tpu_torch.data.datasets import ArrayDataset
from image_segmentation_tpu_torch.engine.evaluate import Evaluator
from image_segmentation_tpu_torch.engine.train import Trainer
from image_segmentation_tpu_torch.parallel import mesh

SMALL = dict(stem_features=8, encoder_features=(16, 32, 64, 128))
GLOBAL_BATCH = 16
SIZE = 32
ADAM_EPS = 1e-3
STEP_KEYS = (5, 6)
# the Evaluator's batches of 6 over 15 images: 6, 6 and a remainder of 3,
# which two ranks do not divide
EVAL_BATCH, EVAL_LENGTH = 6, 15
RANDOM_POINT = ("int", "gaussian_noise", 4)


def cfg(aug: int = 1) -> config.TrainConfig:
    return config.TrainConfig(
        model="large_unet", model_args={**config.preset("large_unet").model_args, **SMALL},
        batch_size=GLOBAL_BATCH, num_epochs=1, bf16=False, seed=0,
        optimizer=config.OptimizerConfig(eps=ADAM_EPS),
        data=config.DataConfig(dataset="synthetic", synthetic_length=GLOBAL_BATCH,
                               image_size=SIZE, augmentations_per_datapoint=aug))


def global_batch(seed: int = 21):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (GLOBAL_BATCH, SIZE, SIZE, 3), dtype=np.uint8),
            rng.integers(0, 3, (GLOBAL_BATCH, SIZE, SIZE)).astype(np.uint8))


def _mine(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a[mesh.rows(len(a))])


def _state(t: Trainer, prefix: str) -> dict:
    """Gradients, parameters and buffers of a Trainer, flat."""
    out = {}
    for k, p in t.model.named_parameters():
        out[f"{prefix}param/{k}"] = p.detach().numpy().copy()
        if p.grad is not None:
            out[f"{prefix}grad/{k}"] = p.grad.numpy().copy()
    for k, b in t.model.named_buffers():
        out[f"{prefix}buffer/{k}"] = b.numpy().copy()
    return out


def run(out_dir: str) -> dict:
    torch.manual_seed(0)
    images, masks = global_batch()
    arrays, result = {}, {"world": mesh.world_size()}

    # one augmented train step of the global batch
    t = Trainer(cfg(1), device="cpu", make_artifacts=False)
    arrays.update(_state(t, "init/"))
    result["loss"] = float(t.train_step(_mine(images), _mine(masks), STEP_KEYS[0]))
    arrays.update(_state(t, "aug/"))

    # the same step without augmentation, for the JAX comparison
    t0 = Trainer(cfg(0), device="cpu", make_artifacts=False)
    result["loss_noaug"] = float(t0.train_step(_mine(images), _mine(masks)))
    arrays.update(_state(t0, "noaug/"))

    # Trainer.evaluate over 15 validation images: one batch of 15, whole
    # on every rank
    val = ArrayDataset(images[:EVAL_LENGTH], masks[:EVAL_LENGTH])
    t.val_data = val
    result["trainer_eval"] = t.evaluate()

    # the Evaluator: clean metrics and one random-family point, a
    # remainder batch present
    model = t.model.eval()
    ev = Evaluator(model, val, batch_size=EVAL_BATCH, device="cpu")
    result["clean"] = ev.test()
    kind, name, p = RANDOM_POINT
    result["random_point"] = list(ev._run_sweep_family(kind, name, [p])[0])

    # save on rank 0 -> restore on every rank -> one more step, against
    # two uninterrupted steps
    a = Trainer(cfg(1), device="cpu", make_artifacts=False)
    a.train_step(_mine(images), _mine(masks), STEP_KEYS[0])
    path = os.path.join(out_dir, "resume.npz")
    a.save(path)
    b = Trainer(cfg(1), device="cpu", make_artifacts=False)
    b.restore(path)
    result["restored_step"] = b.step
    for trainer in (a, b):
        trainer.train_step(_mine(images), _mine(masks), STEP_KEYS[1])
    arrays.update(_state(a, "unbroken/"))
    arrays.update(_state(b, "resumed/"))
    np.savez(os.path.join(out_dir, f"rank{mesh.rank()}.npz"), **arrays)
    mesh.barrier()
    return result


def run_remat(out_dir: str, fused_deep: bool = True) -> dict:
    """Two augmented steps of the global batch with ``remat`` off and on,
    the fused deep levels on: each Trainer's parameters, buffers and Adam
    moments, under ``off/`` and ``on/``.  The recomputed forward repeats
    the statistics' all-reduces inside the backward."""
    images, masks = global_batch()
    arrays = {}
    for remat in (False, True):
        c = cfg(1)
        c = dataclasses.replace(c, remat=remat, model_args=dict(c.model_args,
                                                                fused_deep=fused_deep))
        t = Trainer(c, device="cpu", make_artifacts=False)
        for key in STEP_KEYS:
            t.train_step(_mine(images), _mine(masks), key)
        prefix = "on/" if remat else "off/"
        arrays.update(_state(t, prefix))
        for i, p in enumerate(t.trainable):
            st = t.optimizer.state[p]
            arrays[f"{prefix}adam/{i}/exp_avg"] = st["exp_avg"].numpy().copy()
            arrays[f"{prefix}adam/{i}/exp_avg_sq"] = st["exp_avg_sq"].numpy().copy()
    np.savez(os.path.join(out_dir, f"remat{mesh.rank()}.npz"), **arrays)
    mesh.barrier()
    return {"world": mesh.world_size()}


def run_cli(save_dir: str) -> dict:
    """Two epochs of ``cli.train_distributed`` on the CPU, artifacts on
    (a checkpoint each epoch); returns the run folder and its files."""
    from image_segmentation_tpu_torch.cli import train_distributed

    trainer = train_distributed.main(["--preset", "smoke", "--epochs", "2", "--device", "cpu",
                                      "--save-dir", save_dir])
    return {"world": mesh.world_size(), "run_dir": trainer.run_dir,
            "files": sorted(os.listdir(trainer.run_dir))}
