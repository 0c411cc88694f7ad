"""The port's training slice (image_segmentation_tpu_torch) against the JAX
package on the CPU, in fp32: the Trainer, its loss and optimizer, the
data path, the losses and metrics, and the presets.

The two Trainers start from one parameter tree, drawn from a numpy seed in
the shape the JAX LargeUNet declares (its running statistics away from the
identity) and converted with ``utils/convert.py``, and take K = 3 steps on
the same uint8 batches.  Model: the ``large_unet`` preset's model args at
narrow widths (stem 8, encoders 16/32/64/128), 32x32 images, batch 8 (the
test session gives JAX 8 virtual CPU devices and the JAX Trainer shards
the batch over them), ``bf16=False``, ``augmentations_per_datapoint=0``.
The JAX side runs its Pallas kernels in interpret mode with the kernel
width gate lowered (``IMGSEG_PALLAS_MIN_WP=1``); the port's kernel blocks
run their plain versions.

Tolerances, each with its reason:

- per-step losses: rtol 5e-4, atol 5e-5, the JAX suite's for losses over
  chained training steps (test_train_parity.py:186);
- step-0 gradients: rtol 1e-3, atol 1e-6.  They are sums over 8192 pixels
  taken in another order; the conv biases in front of a training-mode
  BatchNorm have an exact gradient of 0, so theirs is rounding noise of
  about 1e-9, which the atol covers.  The preset's JAX gradients are read
  back from the JAX Trainer's Adam first moment, (1 - b1)*(g + wd*p).  In
  the standard configuration the reference is the JAX standard model's
  gradient in float64: its fp32 gradient on the CPU is off from its own
  float64 one by up to 9 % of a leaf's largest element (dec2's conv2
  kernel; 0.7 % at dec5's bn1), while the JAX preset path and the port
  agree with that float64 gradient to about 1e-5;
- params and running statistics after 3 steps: rtol 5e-4, atol 5e-5 for
  the preset, as the losses.  Adam's eps is 1e-3 here, not 1e-8: at 1e-8
  Adam's first step is lr*sign(g + wd*p), and components whose gradient is
  rounding noise move by +-lr at random in either implementation; at 1e-3
  the step is a smooth function of the gradient, and the L2 term's place
  (added to the gradient before the moments) shows in every step.  In the
  standard configuration atol is lr = 1e-3: Adam moves a parameter by
  about its gradient there, so the JAX Trainer's fp32 gradient error above
  reaches the params and, through the next forward, the running means;
- eval metrics on one set of weights: rtol 2e-4, atol 2e-4, the port's
  forward tolerance (test_torch_port_slice.py).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu import config as jax_config
from image_segmentation_tpu.data import datasets as jax_datasets
from image_segmentation_tpu.data import pipeline as jax_pipeline
from image_segmentation_tpu.engine.train import Trainer as JaxTrainer
from image_segmentation_tpu.models.unet import LargeUNet as JaxLargeUNet
from image_segmentation_tpu.ops import losses as jax_losses
from image_segmentation_tpu_torch import config as port_config
from image_segmentation_tpu_torch.data import datasets, pipeline
from image_segmentation_tpu_torch.engine.train import Trainer, make_loss_fn
from image_segmentation_tpu_torch.models import fused
from image_segmentation_tpu_torch.ops import losses
from image_segmentation_tpu_torch.utils.convert import jax_from_state_dict, state_dict_from_jax

jax.config.update("jax_default_matmul_precision", "highest")
LOSS_TOL = dict(rtol=5e-4, atol=5e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
STATE_TOL = {"preset": LOSS_TOL, "standard": dict(rtol=5e-4, atol=1e-3)}
METRIC_TOL = dict(rtol=2e-4, atol=2e-4)
SMALL = dict(stem_features=8, encoder_features=(16, 32, 64, 128))
MODEL_ARGS = {"preset": port_config.preset("large_unet").model_args, "standard": {}}
STEPS = 3
BATCH = 8
ADAM_EPS = 1e-3


def _cfg(pkg, model_args):
    """The same TrainConfig from either package's config module."""
    return pkg.TrainConfig(
        model="large_unet", model_args={**SMALL, **model_args}, batch_size=BATCH,
        num_epochs=1, bf16=False, seed=0, optimizer=pkg.OptimizerConfig(eps=ADAM_EPS),
        data=pkg.DataConfig(dataset="synthetic", synthetic_length=2 * BATCH,
                            image_size=32, augmentations_per_datapoint=0),
    )


def _tree_like(params, batch_stats, seed):
    """numpy trees of the given shapes: lecun-scale kernels, conv biases of
    magnitude 0.1..0.5, BN scales and running variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        shape = np.shape(x)
        if name.endswith("['kernel']"):
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name.endswith("['scale']") or name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if "['bn" in name or name.endswith("['mean']"):
            return (rng.standard_normal(shape) * 0.1).astype(np.float32)
        sign = rng.choice([-1.0, 1.0], shape)
        return (sign * rng.uniform(0.1, 0.5, shape)).astype(np.float32)

    to_np = lambda t: jax.tree_util.tree_map_with_path(leaf, jax.device_get(t))  # noqa: E731
    return to_np(params), to_np(batch_stats)


def _batches(seed, n, size=32):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (BATCH, size, size, 3), dtype=np.uint8),
             rng.integers(0, 3, (BATCH, size, size)).astype(np.uint8)) for _ in range(n)]


def _jax_grads_f64(params, stats, images, masks):
    """The JAX standard LargeUNet's training-mode gradient in float64."""
    with jax.enable_x64(True):
        model = JaxLargeUNet(dtype=jnp.float64, **SMALL)
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        x = jnp.asarray(images, jnp.float64) / 255.0

        def objective(p):
            out, _ = model.apply({"params": p, "batch_stats": f64(stats)}, x, train=True,
                                 mutable=["batch_stats"])
            return jax_losses.hybrid_loss(out, jnp.asarray(masks, jnp.int32))

        return jax.device_get(jax.jit(jax.grad(objective))(f64(params)))


def _port_grads(model):
    return jax_from_state_dict({k: p.grad for k, p in model.named_parameters()})[0]


def _assert_trees_close(got, ref, tol, what):
    ref = jax.device_get(ref)
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert sorted(map(str, flat_got)) == sorted(map(str, flat_ref)), what
    for path, r in flat_ref.items():
        np.testing.assert_allclose(np.asarray(flat_got[path]), np.asarray(r),
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}", **tol)


@pytest.fixture(scope="module", params=sorted(MODEL_ARGS))
def runs(request):
    """Both Trainers from one tree over STEPS steps: their losses, step-0
    gradients and final trees, and the two Trainers."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMGSEG_PALLAS_MIN_WP", "1")
        args = MODEL_ARGS[request.param]
        jt = JaxTrainer(_cfg(jax_config, args), make_artifacts=False)
        params, stats = _tree_like(jt.state["params"], jt.state["batch_stats"], seed=11)
        jt.state["params"] = jax.tree.map(jnp.asarray, params)
        jt.state["batch_stats"] = jax.tree.map(jnp.asarray, stats)
        pt = Trainer(_cfg(port_config, args), device="cpu", make_artifacts=False)
        pt.model.load_state_dict(state_dict_from_jax(params, stats), strict=True)

        batches = _batches(21, STEPS)
        key = jax.random.PRNGKey(0)  # unused without augmentation
        jax_losses_, port_losses, grads = [], [], {}
        for images, masks in batches:
            jt.state, loss = jt._train_step(jt.state, jnp.asarray(images), jnp.asarray(masks), key)
            jax_losses_.append(float(loss))
            port_losses.append(float(pt.train_step(torch.from_numpy(images),
                                                   torch.from_numpy(masks))))
            if not grads:
                grads["port"] = _port_grads(pt.model)
                if request.param == "standard":
                    grads["jax"] = _jax_grads_f64(params, stats, images, masks)
                else:
                    # Adam's first moment after one step is (1 - b1)*(g + wd*p0)
                    mu = jax.device_get(jt.state["opt_state"][1].mu)
                    wd, b1 = jt.config.optimizer.weight_decay, jt.config.optimizer.b1
                    grads["jax"] = jax.tree.map(lambda m, p: m / (1 - b1) - wd * p, mu, params)
        yield dict(jax=jt, port=pt, jax_losses=jax_losses_, port_losses=port_losses,
                   jax_grads=grads["jax"], port_grads=grads["port"],
                   state_tol=STATE_TOL[request.param])


def test_losses_match_over_steps(runs):
    np.testing.assert_allclose(runs["port_losses"], runs["jax_losses"], **LOSS_TOL)


def test_step0_gradients_match(runs):
    _assert_trees_close(runs["port_grads"], runs["jax_grads"], GRAD_TOL, "grad")


def test_params_and_batch_stats_match_after_steps(runs):
    params, stats = jax_from_state_dict(runs["port"].model.state_dict())
    _assert_trees_close(params, runs["jax"].state["params"], runs["state_tol"], "param")
    _assert_trees_close(stats, runs["jax"].state["batch_stats"], runs["state_tol"], "batch_stats")


def test_train_epoch_and_evaluate_match_jax(runs):
    """``Trainer.train(1)`` + ``evaluate()`` run end to end on the CPU, and
    ``evaluate`` gives the JAX Trainer's metrics on the same weights."""
    pt, jt = runs["port"], runs["jax"]
    hist = pt.train(1)["history"]
    assert len(hist) == 1 and all(np.isfinite(v) for v in hist[0].values())
    params, stats = jax_from_state_dict(pt.model.state_dict())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMGSEG_PALLAS_MIN_WP", "1")
        jt.state["params"] = jax.tree.map(jnp.asarray, params)
        jt.state["batch_stats"] = jax.tree.map(jnp.asarray, stats)
        ref = jt.evaluate()
    got = pt.evaluate()
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **METRIC_TOL)
    assert {k: hist[0][k] for k in got} == got  # train's evaluate is the same pass


def test_preset_trains_through_the_kernel_blocks():
    pt = Trainer(_cfg(port_config, MODEL_ARGS["preset"]), device="cpu", make_artifacts=False)
    assert isinstance(pt.model.enc1, fused.FusedConvBlockDownsample)
    assert isinstance(pt.model.dec5, fused.FusedConvBlockUpsampleSkip)
    assert pt.config == _cfg(port_config, MODEL_ARGS["preset"])


def test_initial_weights_are_seeded():
    cfg = _cfg(port_config, {})
    a = Trainer(cfg, device="cpu", make_artifacts=False).model.state_dict()
    b = Trainer(cfg, device="cpu", make_artifacts=False).model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    w = a["enc1.block.0.conv.0.weight"]
    assert abs(float(w.std()) * np.sqrt(8 * 9) - 1.0) < 0.2  # lecun scale
    assert torch.count_nonzero(a["enc1.block.0.conv.0.bias"]) == 0


def test_trainer_raises_on_what_is_not_ported(tmp_path):
    """``n_model_shards`` with ``fused_deep`` in one process raises, as any
    model does there: one rank cannot form a model group of 2 (tensor
    parallelism itself: tests/test_torch_port_tensor_parallel.py and
    tests/test_torch_port_tensor_parallel_models.py); ``remat`` is
    ported (tests/test_torch_port_options.py holds it to JAX's), as are
    the Oxford-IIIT-Pet split and the native loader (the Pet route from
    its ``<split>_arrays.npz`` files here, tests/test_torch_port_data.py
    holds both routes to JAX's)."""
    cfg = _cfg(port_config, {})
    for split, seed in (("train", 1), ("validation", 2)):
        ds = datasets.synthetic_dataset(4, 32, 32, seed=seed)
        np.savez(tmp_path / f"{split}_arrays.npz", images=ds.images, masks=ds.masks)
    pet = dataclasses.replace(cfg, native_loader=True, data=dataclasses.replace(
        cfg.data, dataset="oxford-pet", dataset_loc=str(tmp_path)))
    t = Trainer(pet, device="cpu", make_artifacts=False)
    assert np.array_equal(t.train_data.images, datasets.synthetic_dataset(4, 32, 32, seed=1).images)
    assert len(t.val_data) == 4
    assert Trainer(dataclasses.replace(cfg, remat=True), device="cpu",
                   make_artifacts=False).config.remat
    with pytest.raises(ValueError, match="model groups of 2"):
        Trainer(dataclasses.replace(cfg, n_model_shards=2,
                                    model_args=dict(cfg.model_args, fused_deep=True)),
                device="cpu", make_artifacts=False)
    with pytest.raises(KeyError, match="unknown loss"):  # every JAX loss is ported
        make_loss_fn("no_such_loss")


# ---- the presets, the data path, losses and metrics ------------------------

PRESET_NAMES = ["unet", "large_unet", "clip_unet", "clip_res", "clip_autoencoder",
                "autoencoder", "segment_classifier", "prompt", "smoke"]


@pytest.mark.parametrize("name", PRESET_NAMES + ["chip_smoke"])
def test_presets_match_jax(name):
    """The port's presets equal JAX's field for field.  ``chip_smoke``: the
    smoke script (which may not import the JAX package) trains the port's
    ``large_unet`` preset, held here to JAX's."""
    if name == "chip_smoke":
        path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        cfg = smoke.train_config()
        ref = jax_config.preset("large_unet")
        assert cfg.model == ref.model and cfg.model_args == ref.model_args
        assert cfg.optimizer == port_config.preset("large_unet").optimizer
        return
    assert dataclasses.asdict(port_config.preset(name)) == dataclasses.asdict(
        jax_config.preset(name))


@pytest.mark.parametrize("raw", [False, True])
def test_synthetic_dataset_is_bit_equal(raw):
    kw = dict(length=5, height=12, width=20, num_classes=3, seed=4, keep_raw_masks=raw)
    got, ref = datasets.synthetic_dataset(**kw), jax_datasets.synthetic_dataset(**kw)
    for name in ("images", "masks", "raw_masks"):
        a, b = getattr(got, name), getattr(ref, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("aug,epoch,shuffle", [(0, 0, True), (2, 3, True), (1, 0, False)])
def test_epoch_permutation_is_bit_equal(aug, epoch, shuffle):
    np.testing.assert_array_equal(
        pipeline.epoch_permutation(11, aug, epoch, seed=5, shuffle=shuffle),
        jax_pipeline.epoch_permutation(11, aug, epoch, seed=5, shuffle=shuffle))


@pytest.mark.parametrize("drop_last", [True, False])
def test_batch_pipeline_yields_the_jax_batches(drop_last):
    ds = datasets.synthetic_dataset(length=7, height=4, width=4, seed=2)
    kw = dict(shuffle=True, drop_last=drop_last, seed=3)
    got = list(pipeline.BatchPipeline(ds, 3, device="cpu", **kw).epoch(1))
    ref = list(jax_pipeline.BatchPipeline(
        jax_datasets.ArrayDataset(ds.images, ds.masks), 3, **kw).epoch(1))
    assert len(got) == len(ref) == (2 if drop_last else 3)
    for (gi, gm), (ri, rm) in zip(got, ref):
        assert gi.dtype == torch.uint8 and gm.dtype == torch.uint8
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))


@pytest.mark.parametrize("fn", ["cross_entropy", "hybrid_loss", "iou", "pixel_accuracy",
                                "dice_score"])
def test_losses_and_metrics_match_jax(fn):
    """Random logits, some classes absent from the target (the metrics'
    special cases); rtol = atol = 1e-6, fp32 on both sides."""
    rng = np.random.default_rng(13)
    logits = (rng.standard_normal((3, 6, 7, 3)) * 2).astype(np.float32)
    for targets in (rng.integers(0, 3, (3, 6, 7)), rng.integers(0, 2, (3, 6, 7))):
        ref = getattr(jax_losses, fn)(jnp.asarray(logits), jnp.asarray(targets))
        got = getattr(losses, fn)(torch.from_numpy(logits), torch.from_numpy(targets))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=1e-6)
