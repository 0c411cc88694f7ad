"""The port's Trainer with augmentation on (``augmentations_per_datapoint >
0``), on the CPU, at the narrow widths of tests/test_torch_port_train.py
(stem 8, encoders 16/32/64/128, 32x32 images, batch 8, ``bf16=False``).

The augmented step is held to JAX without building another JAX Trainer:
tests/test_torch_port_augment.py holds ``DataAugmentor.apply_u8`` to JAX's
on the same draws, tests/test_torch_port_train.py holds the unaugmented
step to the JAX Trainer, and here the augmented ``train_step`` equals the
unaugmented optimizer step on the batch ``apply_u8`` made from the step's
own draws.  Both sides are the same CPU code on the same inputs, so the
comparison is exact.
"""

import inspect

import numpy as np
import pytest
import torch

from image_segmentation_tpu.data import datasets as jax_datasets
from image_segmentation_tpu.data import pipeline as jax_pipeline
from image_segmentation_tpu_torch import config
from image_segmentation_tpu_torch.engine import export
from image_segmentation_tpu_torch.engine.train import Trainer
from image_segmentation_tpu_torch.ops.augment import DataAugmentor, normalize_image

SMALL = dict(stem_features=8, encoder_features=(16, 32, 64, 128))
BATCH = 8


def _cfg(aug: int, length: int = 2 * BATCH) -> config.TrainConfig:
    return config.TrainConfig(
        model="large_unet", model_args={**config.preset("large_unet").model_args, **SMALL},
        batch_size=BATCH, num_epochs=1, bf16=False, seed=0,
        data=config.DataConfig(dataset="synthetic", synthetic_length=length, image_size=32,
                               augmentations_per_datapoint=aug))


def _batch(seed=21):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (BATCH, 32, 32, 3), dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 3, (BATCH, 32, 32), dtype=np.uint8)))


@pytest.mark.parametrize("aug,length", [(0, 16), (1, 12), (4, 9)])
def test_epoch_batches_match_the_jax_pipeline(aug, length):
    """The train pipeline repeats every item aug + 1 times, as the JAX
    Trainer's does (engine/train.py:403-413); the val pipeline does not."""
    t = Trainer(_cfg(aug, length), device="cpu", make_artifacts=False)
    train_pipe, val_pipe = t._pipelines()
    ref = jax_pipeline.BatchPipeline(
        jax_datasets.ArrayDataset(t.train_data.images, t.train_data.masks), BATCH,
        augmentations_per_datapoint=aug, shuffle=True, drop_last=True, seed=0)
    want = length * (aug + 1) // BATCH
    assert train_pipe.batches_per_epoch() == ref.batches_per_epoch() == want
    assert sum(1 for _ in train_pipe.epoch(0)) == want
    assert val_pipe.augmentations_per_datapoint == 0
    assert (t.augmentor is None) == (aug == 0)
    if aug:
        assert t.augmentor == DataAugmentor(aug)  # the JAX Trainer's backend and geometry


def test_augmented_step_equals_the_step_on_the_apply_u8_batch():
    images, masks = _batch()
    a = Trainer(_cfg(1), device="cpu", make_artifacts=False)
    b = Trainer(_cfg(1), device="cpu", make_artifacts=False)
    loss_a = a.train_step(images, masks, step_key=5)
    aug_images, aug_masks = b.augmentor.apply_u8(b.augment_params(BATCH, 5), images, masks)
    assert aug_masks.dtype == torch.int64
    loss_b = b.optimize(aug_images, {"masks": aug_masks})
    assert float(loss_a) == float(loss_b)
    for (k, pa), pb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(pa, pb), k
    # another step key draws another augmentation, the same key the same one
    p5, p6 = a.augment_params(BATCH, 5), a.augment_params(BATCH, 6)
    assert torch.equal(p5.angles, b.augment_params(BATCH, 5).angles)
    assert not torch.equal(p5.angles, p6.angles)


def test_eval_never_augments():
    images, masks = _batch(22)
    t = Trainer(_cfg(4), device="cpu", make_artifacts=False)
    x, batch = t._prepare_batch(images, masks, augment=False)
    assert torch.equal(x, normalize_image(images))
    assert torch.equal(batch["masks"], masks.long())


def test_train_and_evaluate_with_augmentation():
    t = Trainer(_cfg(1), device="cpu", make_artifacts=False)
    hist = t.train(1)["history"]
    assert len(hist) == 1 and all(np.isfinite(v) for v in hist[0].values()), hist
    got = t.evaluate()
    assert {k: hist[0][k] for k in got} == got


@pytest.mark.parametrize("entry", [Trainer.__init__, export.load_model])
def test_entry_points_default_to_the_card(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_smoke_train_config_keeps_the_preset_augmentation():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = smoke.train_config()
    assert cfg.data.augmentations_per_datapoint == \
        config.preset("large_unet").data.augmentations_per_datapoint == 4
