"""The port's prompt path (image_segmentation_tpu_torch: data/prompts.py,
the binary losses of ops/losses.py, DataAugmentorPrompt and
apply_geometric_packed in ops/augment.py, the prompt task of
engine/train.py) against the JAX package on the CPU, in fp32.

Random draws are JAX's own, handed to the port: the prompt's class and
pixel as JAX's ``make_prompt_batch`` picks them from its key, the
augmentation as ``DataAugmentorPrompt.apply_u8`` draws it.  The Trainers
run the ``prompt`` preset's model args (the kernel configuration) with the
small CLIP tower of tests/test_prompt_training.py, 32x32 images, batch 8
(the JAX Trainer shards it over conftest.py's 8 virtual CPU devices),
``augmentations_per_datapoint=1``, ``bf16=False``; the JAX side runs its
Pallas kernels in interpret mode with ``IMGSEG_PALLAS_MIN_WP=1``.

Tolerances, each with its reason:

- the losses and metrics: rtol = atol = 1e-6, fp32 on both sides;
- labels, points, the geometry of image, mask and heatmap: bit for bit
  (whole values move);
- the Gaussian heatmap: atol 1.2e-7 (two ulps at 1.0; its values lie in
  [0, 1]): XLA on the CPU divides by 2*sigma^2 as a product with the
  reciprocal and takes exp with its own polynomial, each off by an ulp
  from torch's in some elements; the one-hot form is bit for bit;
- the colour stage: atol 2e-6, as tests/test_torch_port_augment.py;
- the Trainers over 3 steps: losses rtol 1e-3, atol 1e-4; parameters and
  running statistics rtol 5e-4, atol 1e-3 = lr.  The JAX Trainer's own
  fp32 gradient on the CPU is off from its float64 gradient by up to 14 %
  of a leaf's largest element (tests/test_torch_port_clip.py), and Adam
  (eps 1e-3, as test_torch_port_train.py) moves a parameter by about its
  gradient, so those errors reach the parameters, the running statistics
  and the next losses.  The bottleneck has an exact gradient of 0 on both
  sides, so its parameters are a function of their start alone (L2 decay
  through Adam): rtol 1e-5, atol 1e-9.  The frozen tower: bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu import config as jax_config
from image_segmentation_tpu.data import prompts as jax_prompts
from image_segmentation_tpu.engine.train import Trainer as JaxTrainer
from image_segmentation_tpu.ops import augment as J
from image_segmentation_tpu.ops import losses as jax_losses
from image_segmentation_tpu_torch import config as port_config
from image_segmentation_tpu_torch.data import prompts
from image_segmentation_tpu_torch.data.datasets import CAT_PALETTE, DOG_PALETTE
from image_segmentation_tpu_torch.engine import export
from image_segmentation_tpu_torch.engine.train import Trainer, make_loss_fn
from image_segmentation_tpu_torch.ops import augment as A
from image_segmentation_tpu_torch.ops import losses, roll
from image_segmentation_tpu_torch.utils.convert import CLIP, jax_from_state_dict, state_dict_from_jax
from tests.test_torch_port_clip import CLIP_KW, random_tree

jax.config.update("jax_default_matmul_precision", "highest")
PALETTE = np.array([0, CAT_PALETTE, DOG_PALETTE, 255], np.uint8)
HEAT_ATOL = 1.2e-7
COLOUR_ATOL = 2e-6
LOSS_TOL = dict(rtol=1e-3, atol=1e-4)
STATE_TOL = dict(rtol=5e-4, atol=1e-3)
DECAY_TOL = dict(rtol=1e-5, atol=1e-9)
N, SIZE = 8, 32
STEPS = 3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _raw_masks(seed, n=N, h=SIZE, w=SIZE):
    return np.random.default_rng(seed).choice(PALETTE, (n, h, w))


# ---- losses and metrics -----------------------------------------------------

@pytest.mark.parametrize("fn", ["bce_with_logits", "hybrid_loss_binary", "dice_score_binary",
                                "iou_binary", "pixel_accuracy_binary"])
def test_binary_losses_and_metrics_match_jax(fn):
    """Random logits (B, H, W, 1); targets with positives and without any
    (the dice's special case)."""
    rng = np.random.default_rng(14)
    logits = (rng.standard_normal((3, 6, 7, 1)) * 2).astype(np.float32)
    for targets in (rng.integers(0, 2, (3, 6, 7)), np.zeros((3, 6, 7), np.int64)):
        x = logits[..., 0] if fn == "bce_with_logits" else logits
        ref = getattr(jax_losses, fn)(jnp.asarray(x), jnp.asarray(targets))
        got = getattr(losses, fn)(_t(x), _t(targets))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=1e-6)


def test_the_binary_loss_is_the_trainer_loss():
    logits = torch.randn((2, 4, 4, 1), generator=torch.Generator().manual_seed(0))
    t = torch.randint(0, 2, (2, 4, 4), generator=torch.Generator().manual_seed(1))
    assert make_loss_fn("hybrid_binary")(logits, {"masks": t}) == losses.hybrid_loss_binary(logits, t)


# ---- prompts ----------------------------------------------------------------

def _jax_points(key, raw):
    """(choice, cy, cx) as JAX's make_prompt_batch picks them from ``key``
    (prompts.py:49-62)."""
    kc, kp = jax.random.split(key)
    cat, dog, bg = jax_prompts.palette_to_class_masks(jnp.asarray(raw))
    masks = jnp.stack([cat, dog, bg], axis=1)
    logits = jnp.log(jnp.clip(jnp.sum(masks, axis=(2, 3)), 1e-9, None))
    choice = jax.random.categorical(kc, logits, axis=-1)
    sel = jnp.take_along_axis(masks, choice[:, None, None, None], axis=1)[:, 0]
    u = jax.random.uniform(kp, sel.shape)
    idx = jnp.argmax(jnp.where(sel > 0, u, -1.0).reshape(raw.shape[0], -1), axis=-1)
    w = raw.shape[2]
    return tuple(_t(a).long() for a in (choice, idx // w, idx % w))


@pytest.mark.parametrize("sigma", [10.0, 3.0, None])
@pytest.mark.parametrize("shape", [(4, 33, 40), (N, SIZE, SIZE)])
def test_prompt_maps_match_make_prompt_batch(sigma, shape):
    raw = _raw_masks(int(sigma or 0) + shape[1], *shape)
    key = jax.random.PRNGKey(shape[1])
    ref_heat, ref_label = jax_prompts.make_prompt_batch(key, jnp.asarray(raw), sigma)
    heat, label = prompts.prompt_maps(_t(raw), *_jax_points(key, raw), sigma)
    assert heat.shape == (*shape, 1) and heat.dtype == label.dtype == torch.float32
    np.testing.assert_array_equal(label.numpy(), np.asarray(ref_label))
    if sigma is None:
        np.testing.assert_array_equal(heat.numpy(), np.asarray(ref_heat))
    else:
        np.testing.assert_allclose(heat.numpy(), np.asarray(ref_heat), rtol=0, atol=HEAT_ATOL)


def test_prompt_maps_fall_back_to_the_centre():
    raw = np.zeros((2, 9, 12), np.uint8)  # background only: no cat, no dog
    raw[1, 2, 3] = CAT_PALETTE
    choice = torch.tensor([0, 0])         # cat: none in image 0, one pixel in image 1
    heat, label = prompts.prompt_maps(_t(raw), choice, torch.tensor([7, 7]), torch.tensor([7, 7]),
                                      None)
    assert heat[0, 4, 6, 0] == 1.0 and heat[0].sum() == 1.0  # (h // 2, w // 2)
    assert heat[1, 7, 7, 0] == 1.0 and heat[1].sum() == 1.0  # the given point
    assert label[0].sum() == 0 and label[1].sum() == 1


def test_prompt_points_pick_a_pixel_of_a_class_that_has_one():
    raw = _raw_masks(3, n=6)
    raw[0] = 0                      # background only
    raw[1, :, :] = DOG_PALETTE      # dog only
    d = prompts.sample_prompt_draws(6, torch.Generator().manual_seed(0))
    choice, cy, cx = prompts.prompt_points(_t(raw), d)
    masks = torch.stack(prompts.palette_to_class_masks(_t(raw)), 1)
    assert choice[0] == 2 and choice[1] == 1
    for i in range(6):
        assert masks[i, choice[i], cy[i], cx[i]] == 1.0
    # the extremes of u_pixel: the first and the last pixel of the class
    first = prompts.PromptDraws(torch.full((6,), 0.5), torch.zeros(6))
    last = prompts.PromptDraws(torch.full((6,), 0.5), torch.full((6,), 1.0 - 2**-24))
    for draws, pick in ((first, 0), (last, -1)):
        c, y, x = prompts.prompt_points(_t(raw), draws)
        for i in range(6):
            where = masks[i, c[i]].flatten().nonzero()[pick, 0]
            assert (y[i] * SIZE + x[i]) == where


def test_prompt_classes_are_drawn_by_pixel_count():
    """Weighted by pixel count as JAX's categorical on the log counts: over
    4000 draws on one mask, each class's share within 0.03 of its weight."""
    raw = np.zeros((1, 10, 10), np.uint8)
    raw[0, :2] = CAT_PALETTE   # 20 %
    raw[0, 2:7] = DOG_PALETTE  # 50 %, the rest background 30 %
    raw = np.repeat(raw, 4000, axis=0)
    d = prompts.sample_prompt_draws(4000, torch.Generator().manual_seed(1))
    choice, _, _ = prompts.prompt_points(_t(raw), d)
    share = torch.bincount(choice, minlength=3).float() / 4000
    np.testing.assert_allclose(share.numpy(), [0.2, 0.5, 0.3], atol=0.03)


# ---- the prompt augmentor ---------------------------------------------------

def _jax_aug_params(key, n) -> A.AugmentParams:
    """JAX's draws for ``DataAugmentorPrompt.apply_u8(key, ...)``."""
    kg, kc, kb = jax.random.split(key, 3)
    k_flip, k_rot = jax.random.split(kg)
    return A.AugmentParams(
        flip=_t(jax.random.bernoulli(k_flip, 0.5, (n,))),
        angles=_t(jax.random.uniform(k_rot, (n,), minval=-90.0, maxval=90.0)),
        jitter=_t(J.sample_jitter_factors(kc, n)),
        blur=_t(J.sample_blur_weights(kb, n)),
    )


def _aug_batch(seed, n=N):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, (n, SIZE, SIZE), dtype=np.uint8)
    heat = rng.uniform(0, 1, (n, SIZE, SIZE, 1)).astype(np.float32)
    return images, labels, heat


@pytest.mark.parametrize("reps", [1, 2, 3])
def test_geometry_packed_matches_jax(reps):
    rng = np.random.default_rng(reps)
    packed = rng.integers(-2**31, 2**31 - 1, (reps * N, SIZE, SIZE), dtype=np.int64).astype(np.int32)
    key = jax.random.PRNGKey(20 + reps)
    ref = J.random_geometric_packed(key, jnp.asarray(packed), N)
    k_flip, k_rot = jax.random.split(key)  # its draws (augment.py:216-221)
    flip = _t(jax.random.bernoulli(k_flip, 0.5, (N,)))
    angles = _t(jax.random.uniform(k_rot, (N,), minval=-90.0, maxval=90.0))
    got = A.apply_geometric_packed(_t(packed), flip, angles)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_geometry_packed_off_square_is_the_gather():
    packed = torch.randint(-2**31, 2**31 - 1, (2 * 3, 8, 12), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))
    flip, angles = torch.tensor([True, False, True]), torch.tensor([30.0, -75.0, 5.0])
    got = A.apply_geometric_packed(packed, flip, angles)
    ref = A.apply_geometric(packed[..., None], flip.repeat(2), angles.repeat(2), "gather")[..., 0]
    assert torch.equal(got, ref)


@pytest.mark.parametrize("aug", [1, 4])
def test_prompt_augmentor_apply_u8_matches_jax(aug):
    images, labels, heat = _aug_batch(9 + aug)
    key = jax.random.PRNGKey(30 + aug)
    ref_i, ref_m, ref_p = J.DataAugmentorPrompt(aug).apply_u8(
        key, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(heat))
    before = (roll.row_shift.launches, roll.col_shift.launches)
    got_i, got_m, got_p = A.DataAugmentorPrompt(aug).apply_u8(
        _jax_aug_params(key, N), _t(images), _t(labels), _t(heat))
    assert before == (roll.row_shift.launches, roll.col_shift.launches)  # CPU: plain versions
    assert got_m.dtype == torch.int64 and got_i.dtype == got_p.dtype == torch.float32
    assert got_p.shape == (N, SIZE, SIZE, 1)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    np.testing.assert_allclose(got_i.numpy(), np.asarray(ref_i), rtol=0, atol=COLOUR_ATOL)
    for k in range(0, N, aug + 1):  # the clean slots, exactly
        assert torch.equal(got_i[k], A.normalize_image(_t(images[k])))
        assert torch.equal(got_p[k], _t(heat[k]))
    assert not torch.equal(got_p[1], _t(heat[1]))


# ---- the Trainer ------------------------------------------------------------

def _cfg(pkg, aug=1, length=N):
    cfg = pkg.preset("prompt")
    return dataclasses.replace(
        cfg, batch_size=N, num_epochs=1, bf16=False, seed=0,
        model_args=dict(cfg.model_args, clip_kwargs=CLIP_KW),
        optimizer=pkg.OptimizerConfig(eps=1e-3),
        data=dataclasses.replace(cfg.data, dataset="synthetic", synthetic_length=length,
                                 image_size=SIZE, augmentations_per_datapoint=aug))


def _batches(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (N, SIZE, SIZE, 3), dtype=np.uint8), _raw_masks(seed + i))
            for i in range(n)]


@pytest.fixture(scope="module")
def runs():
    """Both Trainers from one tree over STEPS augmented steps, the port fed
    each step's JAX draws (prompt points from the key's first half, the
    augmentation from its second, as the JAX ``_prepare_batch`` splits it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMGSEG_PALLAS_MIN_WP", "1")
        jt = JaxTrainer(_cfg(jax_config), make_artifacts=False)
        tree = random_tree({"params": jt.state["params"], "batch_stats": jt.state["batch_stats"]},
                           seed=12)
        params, stats = tree["params"], tree["batch_stats"]
        jt.state["params"] = jax.tree.map(jnp.asarray, params)
        jt.state["batch_stats"] = jax.tree.map(jnp.asarray, stats)
        pt = Trainer(_cfg(port_config), device="cpu", make_artifacts=False)
        pt.model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
        start = {k: v.clone() for k, v in pt.model.state_dict().items()}
        jax_l, port_l = [], []
        for i, (images, raw) in enumerate(_batches(40, STEPS)):
            key = jax.random.fold_in(jax.random.PRNGKey(0), i)
            jt.state, loss = jt._train_step(jt.state, jnp.asarray(images), jnp.asarray(raw), key)
            jax_l.append(float(loss))
            kp, ka = jax.random.split(key)
            inputs, batch = pt._prepare_batch(_t(images), _t(raw), augment=True,
                                              params=_jax_aug_params(ka, N),
                                              points=_jax_points(kp, raw))
            port_l.append(float(pt.optimize(inputs, batch)))
    return dict(jax=jt, port=pt, start=start, params0=params, jax_losses=jax_l,
                port_losses=port_l)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def test_trainer_losses_match_jax(runs):
    np.testing.assert_allclose(runs["port_losses"], runs["jax_losses"], **LOSS_TOL)


def test_trainer_state_matches_jax(runs):
    params, stats = jax_from_state_dict(runs["port"].model.state_dict())
    for got, ref, what in ((params, runs["jax"].state["params"], "param"),
                           (stats, runs["jax"].state["batch_stats"], "batch_stats")):
        g, r = _flat(got), _flat(ref)
        assert sorted(g) == sorted(r), what
        for k in r:
            np.testing.assert_allclose(g[k], r[k], err_msg=f"{what} {k}", **STATE_TOL)


def test_trainer_decays_the_bottleneck_as_jax(runs):
    """The bottleneck's gradient is 0 (autograd leaves it None; the Trainer
    fills in zeros), so L2 decay through Adam moves it as it moves JAX's."""
    got = _flat(jax_from_state_dict(runs["port"].model.state_dict())[0]["bottleneck"])
    ref = _flat(runs["jax"].state["params"]["bottleneck"])
    start = _flat(runs["params0"]["bottleneck"])
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **DECAY_TOL)
        assert not np.array_equal(got[k], start[k]), k


def test_trainer_keeps_the_tower_frozen(runs):
    pt = runs["port"]
    for k, v in pt.model.state_dict().items():
        if k.startswith(CLIP):
            assert torch.equal(v, runs["start"][k]), k
    assert not any(p is q for p in pt.model.clip_feature_extractor.parameters()
                   for g in pt.optimizer.param_groups for q in g["params"])
    got = _flat(jax_from_state_dict(pt.model.state_dict())[0]["clip_tower"])
    ref = _flat(runs["jax"].state["params"]["clip_tower"])
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_prompt_trainer_trains_and_evaluates():
    """``Trainer(prompt preset, synthetic data, device="cpu", bf16=False,
    small tower).train(1)`` and ``evaluate()`` run; the step's draws come
    from (seed, step_key)."""
    t = Trainer(_cfg(port_config, aug=1, length=4), device="cpu", make_artifacts=False)
    assert t.task == "prompt" and isinstance(t.augmentor, A.DataAugmentorPrompt)
    assert t.train_data.raw_masks is not None
    hist = t.train(1)["history"]
    assert len(hist) == 1 and all(np.isfinite(v) for v in hist[0].values()), hist
    row = hist[0]
    assert 0 <= row["val_iou"] <= 1 and 0 <= row["val_dice"] <= 1
    assert 0 <= row["val_pixel_accuracy"] <= 1
    a, b = t.prompt_draws(N, 5), t.prompt_draws(N, 6)
    assert torch.equal(a.u_class, t.prompt_draws(N, 5).u_class)
    assert not torch.equal(a.u_class, b.u_class)
    assert not torch.equal(a.u_class, t.augment_params(N, 5).angles)


def test_clip_model_artifacts_are_not_ported(tmp_path):
    """The prompt model's artifact round-trips; ``predict``, which serves
    single-input models as JAX's does, refuses it with the reason."""
    cfg = _cfg(port_config, aug=0, length=1)
    t = Trainer(cfg, device="cpu", make_artifacts=False)
    art = export.export_model(t.model, "clip_unet_prompt", cfg.model_args, out_dir=str(tmp_path))
    served = export.load_model(art, device="cpu", dtype=torch.float32)
    for (k, a), b in zip(t.model.state_dict().items(), served.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(TypeError, match="second input"):
        export.predict(served, np.zeros((SIZE, SIZE, 3), np.float32))
