"""The port's class task (engine/train.py on ClipResSegmentationClassification,
the ``segment_classifier`` preset) against the JAX Trainer on the CPU, in
fp32, and the Trainer on every ClipRes/ClipAutoencoder preset.

Random draws are JAX's own, handed to the port: the augmentation as
``DataAugmentor.apply_u8`` draws it from the second half of the step's key
(the JAX ``_prepare_batch`` splits it, engine/train.py:276).  The Trainers
run the preset's model args (the kernel configuration) with the small CLIP
tower of tests/test_torch_port_clip.py, 32x32 images (the ResNet needs a
multiple of 32), batch 8 (the JAX Trainer shards it over conftest.py's 8
virtual CPU devices), the preset's ``augmentations_per_datapoint=2``,
``bf16=False`` and Adam's eps 1e-3 (tests/test_torch_port_train.py); the
JAX side runs its Pallas kernels in interpret mode with
``IMGSEG_PALLAS_MIN_WP=1``.

Tolerances, each with its reason:

- the prepared batch: masks and labels bit for bit (whole values move),
  images within 2e-6, as tests/test_torch_port_augment.py holds the colour
  stage;
- the Trainers over 2 steps: losses rtol 5e-4, atol 5e-5, the JAX suite's
  for chained training steps; parameters and running statistics rtol
  5e-4, atol 1e-3 = lr.  These decoders' fp32 gradients are 1-2 % (of a
  leaf's largest element) from float64 in the JAX package as in the port
  (ReLU masks flipped by rounding, tests/test_torch_port_models.py), and
  Adam (eps 1e-3) moves a parameter by about its gradient, so those
  differences reach the parameters and, through the second forward, the
  running statistics.  The frozen tower and ResNet: bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu import config as jax_config
from image_segmentation_tpu.engine.train import Trainer as JaxTrainer
from image_segmentation_tpu_torch import config as port_config
from image_segmentation_tpu_torch.data.datasets import CAT_PALETTE, DOG_PALETTE
from image_segmentation_tpu_torch.engine.train import Trainer, class_targets
from image_segmentation_tpu_torch.ops import augment as A
from image_segmentation_tpu_torch.utils.convert import (
    CLIP,
    RESNET,
    jax_from_state_dict,
    state_dict_from_jax,
)
from tests.test_torch_port_augment import _jax_params
from tests.test_torch_port_clip import CLIP_KW, random_tree

jax.config.update("jax_default_matmul_precision", "highest")
PALETTE = np.array([0, CAT_PALETTE, DOG_PALETTE, 255], np.uint8)
COLOUR_ATOL = 2e-6
LOSS_TOL = dict(rtol=5e-4, atol=5e-5)
STATE_TOL = dict(rtol=5e-4, atol=1e-3)
N, SIZE = 8, 32
STEPS = 2


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _cfg(pkg, name="segment_classifier", batch=N, length=N, aug=None):
    cfg = pkg.preset(name)
    aug = cfg.data.augmentations_per_datapoint if aug is None else aug
    return dataclasses.replace(
        cfg, batch_size=batch, num_epochs=1, bf16=False, seed=0,
        model_args=dict(cfg.model_args, clip_kwargs=CLIP_KW),
        optimizer=pkg.OptimizerConfig(eps=1e-3),
        data=dataclasses.replace(cfg.data, dataset="synthetic", synthetic_length=length,
                                 image_size=SIZE, augmentations_per_datapoint=aug))


def _batch(seed, n=N):
    """uint8 images and palette masks; every other image has no cat."""
    rng = np.random.default_rng(seed)
    raw = rng.choice(PALETTE, (n, SIZE, SIZE))
    raw[::2][raw[::2] == CAT_PALETTE] = DOG_PALETTE
    return rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8), raw


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


@pytest.fixture(scope="module")
def trainers():
    """Both Trainers from one tree (the port's start state kept)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMGSEG_PALLAS_MIN_WP", "1")
        jt = JaxTrainer(_cfg(jax_config), make_artifacts=False)
    tree = random_tree({"params": jt.state["params"], "batch_stats": jt.state["batch_stats"]},
                       seed=13)
    params, stats = tree["params"], tree["batch_stats"]
    jt.state["params"] = jax.tree.map(jnp.asarray, params)
    jt.state["batch_stats"] = jax.tree.map(jnp.asarray, stats)
    pt = Trainer(_cfg(port_config), device="cpu", make_artifacts=False)
    pt.model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    start = {k: v.clone() for k, v in pt.model.state_dict().items()}
    return dict(jax=jt, port=pt, start=start)


@pytest.mark.parametrize("augment", [True, False])
def test_prepare_batch_matches_jax(trainers, augment):
    """The any-animal mask, the cat/dog label (taken before the
    augmentation) and the images, on JAX's draws."""
    jt, pt = trainers["jax"], trainers["port"]
    images, raw = _batch(3)
    key = jax.random.PRNGKey(17)
    (ref_i,), ref = jt._prepare_batch(jnp.asarray(images), jnp.asarray(raw), key, augment=augment)
    params = _jax_params(jax.random.split(key)[1], N) if augment else None
    got_i, got = pt._prepare_batch(_t(images), _t(raw), augment=augment, params=params)
    assert pt.task == "class" and isinstance(pt.augmentor, A.DataAugmentor)
    np.testing.assert_array_equal(got["masks"].numpy(), np.asarray(ref["masks"]))
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(ref["labels"]))
    np.testing.assert_allclose(got_i.numpy(), np.asarray(ref_i), rtol=0, atol=COLOUR_ATOL)
    assert got["labels"].tolist() == [1.0, 0.0] * (N // 2)  # no cat -> 1


def test_class_targets_cover_the_palette():
    raw = torch.tensor([[[0, CAT_PALETTE], [DOG_PALETTE, 255]], [[0, 0], [DOG_PALETTE, 0]]],
                       dtype=torch.uint8)
    seg, labels = class_targets(raw)
    assert seg.tolist() == [[[0, 1], [1, 1]], [[0, 0], [1, 0]]] and seg.dtype == torch.uint8
    assert labels.tolist() == [0.0, 1.0]


@pytest.fixture(scope="module")
def steps(trainers):
    """STEPS augmented steps of both Trainers on the same batches, the port
    fed each step's JAX draws."""
    jt, pt = trainers["jax"], trainers["port"]
    jax_l, port_l = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMGSEG_PALLAS_MIN_WP", "1")
        for i in range(STEPS):
            images, raw = _batch(40 + i)
            key = jax.random.fold_in(jax.random.PRNGKey(0), i)
            jt.state, loss = jt._train_step(jt.state, jnp.asarray(images), jnp.asarray(raw), key)
            jax_l.append(float(loss))
            inputs, batch = pt._prepare_batch(_t(images), _t(raw), augment=True,
                                              params=_jax_params(jax.random.split(key)[1], N))
            port_l.append(float(pt.optimize(inputs, batch)))
    return dict(trainers, jax_losses=jax_l, port_losses=port_l)


def test_trainer_losses_match_jax(steps):
    np.testing.assert_allclose(steps["port_losses"], steps["jax_losses"], **LOSS_TOL)


def test_trainer_state_matches_jax(steps):
    """Every parameter and running statistic after the steps; the class
    head's and the frozen ResNet's included."""
    params, stats = jax_from_state_dict(steps["port"].model.state_dict())
    for got, ref, what in ((params, steps["jax"].state["params"], "param"),
                           (stats, steps["jax"].state["batch_stats"], "batch_stats")):
        g, r = _flat(got), _flat(ref)
        assert sorted(g) == sorted(r), what
        for k in r:
            np.testing.assert_allclose(g[k], r[k], err_msg=f"{what} {k}", **STATE_TOL)


def test_trainer_keeps_tower_and_backbone_frozen(steps):
    """Out of the optimizer and bit-identical (JAX's set_to_zero on
    clip_tower and resnet_backbone), while the ResNet's running statistics
    move; the class head trains."""
    pt, start = steps["port"], steps["start"]
    held = {id(p) for g in pt.optimizer.param_groups for p in g["params"]}
    moved_stats = 0
    for k, v in pt.model.state_dict().items():
        if k.startswith((CLIP, RESNET)) and not k.endswith(("running_mean", "running_var",
                                                            "num_batches_tracked")):
            assert torch.equal(v, start[k]), k
        moved_stats += k.startswith(RESNET) and k.endswith("running_mean") and not torch.equal(
            v, start[k])
    assert moved_stats == 36  # every BatchNorm of the ResNet
    for k, p in pt.model.named_parameters():
        assert (id(p) in held) != k.startswith((CLIP, RESNET)), k
    assert not torch.equal(pt.model.class_head.weight, start["class_head.weight"])
    got = _flat(jax_from_state_dict(pt.model.state_dict())[0])
    ref = _flat(steps["jax"].state["params"])
    for k in ref:
        if k.startswith(("['clip_tower']", "['resnet_backbone']")):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_eval_step_matches_jax(steps):
    """The binary metrics on the mask logits and the class loss, on the
    weights after the steps."""
    jt, pt = steps["jax"], steps["port"]
    images, raw = _batch(60)
    params, stats = jax_from_state_dict(pt.model.state_dict())
    state = dict(jt.state, params=jax.tree.map(jnp.asarray, params),
                 batch_stats=jax.tree.map(jnp.asarray, stats))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMGSEG_PALLAS_MIN_WP", "1")
        ref = jt._eval_step(state, jnp.asarray(images), jnp.asarray(raw), jax.random.PRNGKey(1))
    got = pt.eval_step(_t(images), _t(raw))
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in ref],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["clip_res", "clip_autoencoder", "segment_classifier"])
def test_preset_trains_and_evaluates(name):
    """``Trainer(preset, device="cpu")`` with the small tower at 32x32,
    batch 2: ``train(1)`` and ``evaluate()`` run and give finite metrics
    in [0, 1]."""
    t = Trainer(_cfg(port_config, name, batch=2, length=2), device="cpu", make_artifacts=False)
    assert t.task == ("class" if name == "segment_classifier" else "segmentation")
    assert (t.train_data.raw_masks is not None) == (name == "segment_classifier")
    hist = t.train(1)["history"]
    assert len(hist) == 1 and all(np.isfinite(v) for v in hist[0].values()), hist
    for k in ("val_iou", "val_pixel_accuracy", "val_dice"):
        assert 0.0 <= hist[0][k] <= 1.0, (k, hist)
