"""The port's autoencoder (image_segmentation_tpu_torch/models/autoencoder.py),
its reconstruction Trainer and the ``w2d_impl="pallas"`` block family
against the JAX package on the CPU, in fp32.

Models run at 32x32, batch 2, from one parameter tree drawn with numpy in
the shapes the JAX model declares (running statistics away from the
identity) and converted with ``utils/convert.py``: the ``autoencoder``
preset's model args (fused kernel blocks, K11 on the stem and out), the
same with ``w2d_impl="pallas"`` (the unfused blocks on the conv kernels'
plain forms), and a small LargeUNet (stem 8, encoders 16/32) with
``w2d_level0``, ``w2d_level1_fold2`` and ``w2d_impl="pallas"``.  The JAX
side runs its Pallas kernels in interpret mode with the kernel width gate
lowered (``IMGSEG_PALLAS_MIN_WP=1``); the port's wrappers run their plain
versions.

Tolerances, each with its reason:

- forwards, losses and running statistics: rtol 2e-4, atol 2e-4, the
  port's forward tolerance (test_torch_port_slice.py);
- gradients: rtol 1e-3, atol 1e-6, held to the JAX standard model's
  float64 gradient, as tests/test_torch_port_train.py does; the conv
  biases in front of a training-mode BatchNorm have an exact gradient of 0,
  so theirs is rounding noise of about 1e-9;
- the Trainers over 3 steps: losses rtol 5e-4, atol 5e-5, parameters and
  running statistics rtol 5e-4, atol 1e-3 = lr (Adam, eps 1e-3, moves a
  parameter by about its gradient, so the JAX Trainer's own fp32 gradient
  error reaches the parameters; test_torch_port_train.py).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu import config as jax_config
from image_segmentation_tpu.engine.train import Trainer as JaxTrainer
from image_segmentation_tpu.models.autoencoder import Autoencoder as JaxAutoencoder
from image_segmentation_tpu.models.unet import LargeUNet as JaxLargeUNet
from image_segmentation_tpu.parallel.mesh import make_mesh
from image_segmentation_tpu_torch import config as port_config
from image_segmentation_tpu_torch.engine.train import Trainer, make_loss_fn
from image_segmentation_tpu_torch.models import fused
from image_segmentation_tpu_torch.models.autoencoder import Autoencoder
from image_segmentation_tpu_torch.models.registry import build_model
from image_segmentation_tpu_torch.utils.convert import jax_from_state_dict, state_dict_from_jax
from tests.test_torch_port_clip import jax_variables

jax.config.update("jax_default_matmul_precision", "highest")
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
LOSS_TOL = dict(rtol=5e-4, atol=5e-5)
STATE_TOL = dict(rtol=5e-4, atol=1e-3)
BATCH, SIZE, STEPS = 2, 32, 3
AE_ARGS = port_config.preset("autoencoder").model_args
UNET_SMALL = dict(stem_features=8, encoder_features=(16, 32))
CONFIGS = {
    "autoencoder": ("autoencoder", AE_ARGS),
    "autoencoder pallas": ("autoencoder", dict(AE_ARGS, w2d_impl="pallas")),
    "large_unet pallas": ("large_unet", dict(UNET_SMALL, w2d_level0=True, w2d_level1_fold2=True,
                                            w2d_impl="pallas")),
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def _assert_trees_close(got, ref, tol, what):
    g, r = _flat(got), _flat(ref)
    assert sorted(g) == sorted(r), what
    for k in r:
        np.testing.assert_allclose(g[k], r[k], err_msg=f"{what} {k}", **tol)


def _jax_model(name, args, dtype=jnp.float32):
    if name == "autoencoder":
        return JaxAutoencoder(dtype=dtype, **args)
    return JaxLargeUNet(dtype=dtype, **{**UNET_SMALL, **args})


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    return x, target


def _mse(out, target):
    return ((out - target) ** 2).mean()


@functools.lru_cache(maxsize=None)
def _variables(name):
    x, _ = _inputs()
    return jax_variables(_jax_model(name, {}), jnp.asarray(x), seed=13)


@functools.lru_cache(maxsize=None)
def _jax_grads_f64(name):
    """The JAX standard model's training-mode gradient in float64 (the
    folded model shares its tree and its math)."""
    x, target = _inputs()
    variables = _variables(name)
    with jax.enable_x64(True):
        model = _jax_model(name, {}, jnp.float64)
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731

        def objective(p):
            out, _ = model.apply({"params": p, "batch_stats": f64(variables["batch_stats"])},
                                 jnp.asarray(x, jnp.float64), train=True, mutable=["batch_stats"])
            return _mse(out, jnp.asarray(target, jnp.float64))

        return jax.device_get(jax.jit(jax.grad(objective))(f64(variables["params"])))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model_runs(request):
    """Both models from one tree: eval and train outputs and the MSE loss,
    the running statistics after the train forward, the port's parameter
    gradients and the JAX float64 ones."""
    name, args = CONFIGS[request.param]
    x, target = _inputs()
    variables = _variables(name)
    params, stats = variables["params"], variables["batch_stats"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMGSEG_PALLAS_MIN_WP", "1")
        jm = _jax_model(name, args)

        @jax.jit
        def forwards(p):
            out, mutated = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                    train=True, mutable=["batch_stats"])
            return (jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=False),
                    out, _mse(out, jnp.asarray(target)), mutated["batch_stats"])

        jeval, jtrain, jloss, jstats = forwards(params)

    pm = build_model(name, device="cpu", dtype=torch.float32, **args)
    pm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        peval = pm(_t(x), train=False)
    ptrain = pm(_t(x), train=True)
    ploss = _mse(ptrain, _t(target))
    ploss.backward()
    grads = {k: p.grad for k, p in pm.named_parameters()}
    return dict(config=request.param, model=pm,
                jax=dict(eval=jeval, train=jtrain, loss=jloss, stats=jstats,
                         grads=_jax_grads_f64(name)),
                port=dict(eval=peval, train=ptrain, loss=ploss,
                          stats=jax_from_state_dict(pm.state_dict())[1],
                          grads=jax_from_state_dict(grads)[0]))


def test_model_forward_matches_jax(model_runs):
    j, p = model_runs["jax"], model_runs["port"]
    for what in ("eval", "train", "loss"):
        if what != "loss":
            assert p[what].shape == (BATCH, SIZE, SIZE, 3) and p[what].dtype == torch.float32
        np.testing.assert_allclose(p[what].detach().numpy(), np.asarray(j[what]), err_msg=what,
                                   **FWD_TOL)


def test_model_running_stats_match_jax(model_runs):
    _assert_trees_close(model_runs["port"]["stats"], model_runs["jax"]["stats"], FWD_TOL,
                        "batch_stats")


def test_model_gradients_match_jax(model_runs):
    _assert_trees_close(model_runs["port"]["grads"], model_runs["jax"]["grads"], GRAD_TOL, "grad")


def test_model_takes_the_block_families(model_runs):
    """The folded levels take the family of ``w2d_impl``; the deeper ones,
    the standard blocks."""
    pm, config = model_runs["model"], model_runs["config"]
    if config == "large_unet pallas":
        assert isinstance(pm.enc1, fused.UnfusedConvBlockDownsample)
        assert isinstance(pm.enc2, fused.UnfusedConvBlockDownsample)
        assert isinstance(pm.dec2, fused.UnfusedConvBlockUpsampleSkip)
        assert isinstance(pm.dec3, fused.UnfusedConvBlockUpsampleSkip)
        assert type(pm.dec1) is fused.STANDARD[1] and pm.folded
        return
    down, _, up = fused.FAMILIES["pallas" if "pallas" in config else "pallas_fused"]
    enc, dec = pm.encoder, pm.decoder
    assert all(type(getattr(enc, n)) is down for n in ("enc1", "enc2"))
    assert all(type(getattr(dec, n)) is up for n in ("dec1", "dec2", "dec3"))
    assert type(enc.enc3) is fused.STANDARD[0]


def test_encoder_returns_every_level():
    """The skip-dict contract of the JAX Encoder (autoencoder.py:71-77), and
    the fold gate: a width that is not a multiple of 8 runs the standard
    blocks' math on the same parameters, as JAX builds the standard model."""
    variables = _variables("autoencoder")
    pm = Autoencoder(dtype=torch.float32, **AE_ARGS)
    pm.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                       strict=True)
    x = torch.rand((BATCH, SIZE, SIZE, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        feats = pm.encoder(x)
        shapes = {k: tuple(v.shape[1:]) for k, v in feats.items()}
        assert shapes == {"x0": (32, 32, 32), "enc1": (16, 16, 64), "enc2": (8, 8, 64),
                          "enc3": (4, 4, 64), "bottleneck": (4, 4, 64)}
        odd = torch.rand((1, 36, 36, 3), generator=torch.Generator().manual_seed(1))
        jm = JaxAutoencoder(dtype=jnp.float32, **AE_ARGS)
        ref = jm.apply(variables, jnp.asarray(odd.numpy()), train=False)
        np.testing.assert_allclose(pm(odd).numpy(), np.asarray(ref), **FWD_TOL)


def test_autoencoder_tree_round_trip():
    """flax tree -> state dict (strict) -> flax tree, leaf for leaf."""
    variables = _variables("autoencoder")
    pm = Autoencoder(dtype=torch.float32, **AE_ARGS)
    pm.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                       strict=True)
    assert any(k.startswith("decoder.dec1.conv.conv.") for k in pm.state_dict())
    params, stats = jax_from_state_dict(pm.state_dict())
    for got, ref in ((params, variables["params"]), (stats, variables["batch_stats"])):
        g, r = _flat(got), _flat(ref)
        assert sorted(g) == sorted(r)
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


# ---- the reconstruction Trainer ----------------------------------------------

def _cfg(pkg, aug=0):
    cfg = pkg.preset("autoencoder")
    return dataclasses.replace(
        cfg, batch_size=BATCH, num_epochs=1, bf16=False, seed=0,
        optimizer=pkg.OptimizerConfig(eps=1e-3),
        data=dataclasses.replace(cfg.data, dataset="synthetic", synthetic_length=2 * BATCH,
                                 image_size=SIZE, augmentations_per_datapoint=aug))


@pytest.fixture(scope="module")
def trainer_runs():
    """Both Trainers from one tree over STEPS steps on the same uint8
    batches (the JAX Trainer on one CPU device, which takes batch 2)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMGSEG_PALLAS_MIN_WP", "1")
        jt = JaxTrainer(_cfg(jax_config), make_artifacts=False,
                        mesh=make_mesh(devices=jax.devices()[:1]))
        variables = _variables("autoencoder")
        jt.state["params"] = jax.tree.map(jnp.asarray, variables["params"])
        jt.state["batch_stats"] = jax.tree.map(jnp.asarray, variables["batch_stats"])
        pt = Trainer(_cfg(port_config), device="cpu", make_artifacts=False)
        pt.model.load_state_dict(state_dict_from_jax(variables["params"],
                                                     variables["batch_stats"]), strict=True)
        rng = np.random.default_rng(31)
        key = jax.random.PRNGKey(0)  # unused: reconstruction does not augment
        jax_l, port_l = [], []
        for _ in range(STEPS):
            images = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
            masks = rng.integers(0, 3, (BATCH, SIZE, SIZE)).astype(np.uint8)
            jt.state, loss = jt._train_step(jt.state, jnp.asarray(images), jnp.asarray(masks), key)
            jax_l.append(float(loss))
            port_l.append(float(pt.train_step(_t(images), _t(masks))))
    return dict(jax=jt, port=pt, jax_losses=jax_l, port_losses=port_l)


def test_trainer_losses_match_jax(trainer_runs):
    np.testing.assert_allclose(trainer_runs["port_losses"], trainer_runs["jax_losses"],
                               **LOSS_TOL)


def test_trainer_state_matches_jax(trainer_runs):
    params, stats = jax_from_state_dict(trainer_runs["port"].model.state_dict())
    jt = trainer_runs["jax"]
    _assert_trees_close(params, jt.state["params"], STATE_TOL, "param")
    _assert_trees_close(stats, jt.state["batch_stats"], STATE_TOL, "batch_stats")


def test_reconstruction_trainer_trains_and_evaluates():
    """``train(1)`` + ``evaluate()``: the reconstruction task never augments
    (JAX train.py:313) while the pipeline repeats each image aug + 1 times,
    and the eval step returns the loss and three zeros (:372-374)."""
    t = Trainer(_cfg(port_config, aug=1), device="cpu", make_artifacts=False)
    assert t.task == "reconstruction" and t.augmentor is None
    train_pipe, _ = t._pipelines()
    assert sum(1 for _ in train_pipe.epoch(0)) == 2 * 2  # 4 images, each twice, batch 2
    row = t.train(1)["history"][0]
    assert np.isfinite(row["train_loss"]) and 0 < row["val_loss"] < 1
    assert row["val_iou"] == row["val_pixel_accuracy"] == row["val_dice"] == 0.0
    out = torch.rand((2, 4, 4, 3), generator=torch.Generator().manual_seed(2))
    images = torch.rand((2, 4, 4, 3), generator=torch.Generator().manual_seed(3))
    assert make_loss_fn("mse")(out, {"images": images}) == ((out - images) ** 2).mean()
