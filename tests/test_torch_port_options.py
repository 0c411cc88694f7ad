"""The options that are off in every preset, in the port against the JAX
package on the CPU: ``fused_deep`` (the deep U-Net levels on the fused
ConvBN kernel blocks at fold 1), the U-Net's fold gate, the Trainer's
``remat`` and ``freeze_clip=False``.

Inputs and parameter trees come from numpy seeds and cross over with
``utils.convert.state_dict_from_jax``.  The JAX side runs its Pallas
kernels in interpret mode with the kernel width gate lowered
(``IMGSEG_PALLAS_MIN_WP=1``, as tests/test_folded.py:437-438); the port's
kernel blocks run their plain versions.

Tolerances, each with its reason:

- forward outputs and committed batch statistics: rtol = atol = 2e-4, the
  JAX suite's for folded-vs-standard models (test_folded.py:20) and the
  port's slice tests';
- gradients: rtol 1e-3, atol 1e-6 of the JAX model's float64 gradient,
  the port's model computing in float64 on fp32 parameters.  In fp32 both
  packages are 1-2 % off float64 (rounding flips ReLU masks, ROADMAP.md
  "Found in the reference"), so fp32 gradients are not compared with each
  other.  JAX's fused kernels take no float64, so the reference is its
  standard model, whose math its fused_deep model shares
  (test_folded.py ``TestFusedDeep``); the port's fp32 fused_deep gradient
  is held besides to be no further from it than JAX's fused_deep one
  (FP32_SLACK, FP32_FLOOR);
- Trainer steps against the JAX Trainer: the losses, parameters and
  running statistics at rtol 5e-4, atol 5e-5, as
  tests/test_torch_port_train.py;
- the port against itself (``remat`` on and off, ``freeze_clip`` off and
  on, one and two ranks' ranks): bit for bit.
"""

import dataclasses
import json
from collections import Counter
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu import config as jax_config
from image_segmentation_tpu.engine.train import Trainer as JaxTrainer
from image_segmentation_tpu.models import clip_models as jax_models
from image_segmentation_tpu.models.unet import UNet as JaxUNet
from image_segmentation_tpu.ops import losses as jax_losses
from image_segmentation_tpu_torch import config as port_config
from image_segmentation_tpu_torch.engine import export
from image_segmentation_tpu_torch.engine.train import Trainer
from image_segmentation_tpu_torch.models import blocks, fused, unet
from image_segmentation_tpu_torch.models.registry import build_model
from image_segmentation_tpu_torch.ops import fused_conv, losses
from image_segmentation_tpu_torch.ops.conv1x1 import Conv1x1Function
from image_segmentation_tpu_torch.parallel import mesh
from image_segmentation_tpu_torch.utils.convert import (
    CLIP,
    jax_from_state_dict,
    state_dict_from_jax,
)
from tests.test_torch_port_clip import CLIP_KW, jax_variables
from tests.test_torch_port_slice import _init_tree
from tests.test_torch_port_train import _cfg, _tree_like

jax.config.update("jax_default_matmul_precision", "highest")
TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
LOSS_TOL = dict(rtol=5e-4, atol=5e-5)
# the port's fp32 fused_deep gradient may be this much further from the
# float64 gradient than JAX's fp32 fused_deep gradient (relative L2 over
# the tree): the two round in other places; FP32_FLOOR is a relative L2
# that fp32 rounding alone reaches (both read ~1e-6 here)
FP32_SLACK, FP32_FLOOR = 1.5, 1e-5
WIDTHS = dict(stem_features=8, encoder_features=(16, 32, 64))
UNET_ARGS = dict(port_config.preset("unet").model_args)
FUSED_DEEP = dict(UNET_ARGS, fused_deep=True)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def _assert_trees_close(got, ref, tol, what):
    got, ref = _flat(got), _flat(ref)
    assert sorted(got) == sorted(ref), what
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=f"{what} {k}", **tol)


def _port_unet(params, stats, dtype=torch.float32, **args):
    m = build_model("unet", device="cpu", dtype=dtype, **WIDTHS, **args)
    m.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return m


# ---- fused_deep at fold 1 -----------------------------------------------------

@pytest.fixture(scope="module")
def deep_runs():
    """The small UNet of tests/test_folded.py:439-441 with fused_deep=True
    (enc3, the bottleneck, dec1 with its non-identity resize, dec2 on the
    fold-1 blocks) at 64x64, batch 2: JAX's eval and train outputs, its
    committed batch statistics and its fp32 gradient of sum(out*g), and
    the JAX standard model's float64 gradient."""
    params, stats = _init_tree(3, JaxUNet, **WIDTHS)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    g = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMGSEG_PALLAS_MIN_WP", "1")
        jm = JaxUNet(dtype=jnp.float32, **WIDTHS, **FUSED_DEEP)

        def train(p):
            out, mutated = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                    train=True, mutable=["batch_stats"])
            return jnp.sum(out * g), (out, mutated["batch_stats"])

        jeval = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
        (_, (jtrain, jstats)), jgrad = jax.jit(jax.value_and_grad(train, has_aux=True))(params)
    with jax.enable_x64(True):
        std = JaxUNet(dtype=jnp.float64, **WIDTHS)
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731

        def objective(p):
            out, _ = std.apply({"params": p, "batch_stats": f64(stats)},
                               jnp.asarray(x, jnp.float64), train=True, mutable=["batch_stats"])
            return jnp.sum(out * jnp.asarray(g, jnp.float64))

        grad64 = jax.device_get(jax.jit(jax.grad(objective))(f64(params)))
    return dict(params=params, stats=stats, x=x, g=g, eval=jeval, train=jtrain,
                batch_stats=jstats, grad=jgrad, grad64=grad64)


def test_fused_deep_blocks_of_the_small_unet(deep_runs):
    m = _port_unet(deep_runs["params"], deep_runs["stats"], **FUSED_DEEP)
    assert isinstance(m.enc3, fused.FusedDeepConvBlockDownsample)
    assert type(m.bottleneck) is fused.FusedConvBlock
    assert isinstance(m.dec1, fused.FusedDeepConvBlockUpsampleSkip)
    assert isinstance(m.dec2, fused.FusedDeepConvBlockUpsampleSkip)


def test_fused_deep_forward_matches_jax(deep_runs):
    m = _port_unet(deep_runs["params"], deep_runs["stats"], **FUSED_DEEP)
    x = _t(deep_runs["x"])
    with torch.no_grad():
        out = m(x, train=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(deep_runs["eval"]), **TOL)
    out = m(x, train=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(deep_runs["train"]), **TOL)
    _, stats = jax_from_state_dict(m.state_dict())
    _assert_trees_close(stats, deep_runs["batch_stats"], TOL, "batch_stats")


def _rel_l2(got: dict, ref: dict) -> float:
    num = sum(float(np.sum((np.asarray(got[k], np.float64) - ref[k]) ** 2)) for k in ref)
    return (num / sum(float(np.sum(ref[k] ** 2)) for k in ref)) ** 0.5


def test_fused_deep_gradients_match_jax_in_float64(deep_runs):
    grads = {}
    for dt in (torch.float64, torch.float32):
        m = _port_unet(deep_runs["params"], deep_runs["stats"], dtype=dt, **FUSED_DEEP)
        (m(_t(deep_runs["x"]).to(dt), train=True) * _t(deep_runs["g"]).to(dt)).sum().backward()
        grads[dt] = jax_from_state_dict({k: p.grad for k, p in m.named_parameters()})[0]
    _assert_trees_close(grads[torch.float64], deep_runs["grad64"], GRAD_TOL, "grad")
    ref = _flat(deep_runs["grad64"])
    port32, jax32 = _rel_l2(_flat(grads[torch.float32]), ref), _rel_l2(_flat(deep_runs["grad"]), ref)
    assert port32 <= FP32_SLACK * jax32 + FP32_FLOOR, (port32, jax32)


def test_fused_deep_trains_through_the_kernel_function(deep_runs, monkeypatch):
    with _counted(monkeypatch) as calls:
        m = _port_unet(deep_runs["params"], deep_runs["stats"], **FUSED_DEEP)
        m(_t(deep_runs["x"]), train=True).sum().backward()
    # enc1, enc2, dec3, dec4 (levels 0-1) and enc3, bottleneck, dec1, dec2
    assert calls["FusedBlockFunction"] == 8
    assert calls["PoolFunction"] == 2  # the fold-1 encoder takes the standard pool


# ---- the gate at production widths ---------------------------------------------

def _kernel_blocks(model) -> set:
    deep = (fused.FusedDeepConvBlockDownsample, fused.FusedDeepConvBlockUpsampleSkip)
    return {n for n, mod in model.named_children()
            if isinstance(mod, deep) or type(mod) is fused.FusedConvBlock}


@pytest.mark.parametrize("name,want", [
    ("large_unet", {"enc3", "enc4", "dec2", "dec3"}),  # the bottleneck 18.9 MB, dec1 9.4 MB
    ("unet", {"enc3", "bottleneck", "dec1", "dec2"}),
])
def test_fused_deep_gate_at_production_widths(name, want):
    args = dict(port_config.preset(name).model_args)
    for value in (True, "enc1,enc2," + ",".join(sorted(want)), sorted(want), tuple(want)):
        m = build_model(name, device="meta", **args, fused_deep=value)
        assert _kernel_blocks(m) == want, value
        for level01 in ("enc1", "enc2"):
            assert isinstance(getattr(m, level01), fused.FusedConvBlockDownsample)
    m = build_model(name, device="meta", **args, fused_deep="enc3,dec2")
    assert _kernel_blocks(m) == {"enc3", "dec2"}


@pytest.mark.parametrize("args", [
    dict(w2d_level0=True, w2d_level1_fold2=True, w2d_impl="dense"),
    dict(w2d_level0=True, w2d_level1_fold2=True, w2d_impl="pallas"),
    dict(w2d_impl="pallas_fused"),  # no fold: JAX never takes its folded path
])
def test_fused_deep_is_ignored_off_the_fused_folded_path(args):
    m = build_model("large_unet", device="meta", **args, fused_deep=True)
    assert _kernel_blocks(m) == set()
    assert type(m.bottleneck) is blocks.ConvBlock


def test_fused_fits_is_jax_gate():
    assert unet.fused_fits(256, 512) and not unet.fused_fits(512, 1024)
    assert unet.fused_fits(512, 256) and not unet.fused_fits(1024, 512)


def test_fused_deep_goes_through_model_args_and_artifacts(deep_runs, tmp_path):
    """A tuple in ``model_args`` comes back from the artifact's JSON and
    ``model_settings.json`` as a list, meaning the same blocks."""
    args = dict(UNET_ARGS, **WIDTHS, fused_deep=("enc3", "dec2"))
    m = build_model("unet", device="cpu", dtype=torch.float32, **args)
    m.load_state_dict(state_dict_from_jax(deep_runs["params"], deep_runs["stats"]))
    export.export_model(m, "unet", args, out_dir=str(tmp_path / "art"))
    stored = json.loads((tmp_path / "art" / "config.json").read_text())["model_args"]
    assert stored["fused_deep"] == ["enc3", "dec2"]
    served = export.load_model(str(tmp_path / "art"), device="cpu", dtype=torch.float32)
    assert _kernel_blocks(served) == _kernel_blocks(m) == {"enc3", "dec2"}
    x = _t(deep_runs["x"])
    with torch.no_grad():
        assert torch.equal(served(x), m.eval()(x))
    cfg = dataclasses.replace(port_config.preset("smoke"), model_args=args, save_dir=str(tmp_path))
    t = Trainer(cfg, device="cpu")
    settings = json.loads(open(f"{t.run_dir}/model_settings.json").read())
    stored = settings["config"]["model_args"]
    assert stored["fused_deep"] == ["enc3", "dec2"]
    assert _kernel_blocks(build_model("unet", device="meta", **stored)) == {"enc3", "dec2"}


# ---- the fold gate --------------------------------------------------------------

KERNEL_CALLS = ((fused_conv, "conv3x3"), (fused_conv, "maxpool2x2_affine_relu"),
                (fused_conv, "convtranspose2x2"), (fused_conv.FusedBlockFunction, "apply"),
                (fused_conv.PoolFunction, "apply"), (fused_conv.ConvTransposeFunction, "apply"),
                (fused_conv.Conv3x3Function, "apply"), (Conv1x1Function, "apply"))


@contextmanager
def _counted(mp):
    """Count the calls of every kernel wrapper and kernel Function the
    folded levels reach, by name."""
    calls = Counter()

    def wrap(fn, key):
        def counted(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return counted

    for owner, name in KERNEL_CALLS:
        key = owner.__name__.rsplit(".", 1)[-1] if name == "apply" else name
        mp.setattr(owner, name, wrap(getattr(owner, name), key))
    yield calls


@pytest.mark.parametrize("width", [36, 40])
def test_unet_fold_gate_matches_jax(deep_runs, monkeypatch, width):
    """JAX folds only where the width is a multiple of 8 (unet.py:76):
    at 36 no kernel wrapper or Function is reached and the port equals
    JAX's standard path; at 40 the kernel blocks run."""
    x = np.random.default_rng(width).uniform(0, 1, (2, 32, width, 3)).astype(np.float32)
    params, stats = deep_runs["params"], deep_runs["stats"]
    monkeypatch.setenv("IMGSEG_PALLAS_MIN_WP", "1")
    jm = JaxUNet(dtype=jnp.float32, **WIDTHS, **FUSED_DEEP)
    ref = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with _counted(monkeypatch) as calls:
        m = _port_unet(params, stats, **FUSED_DEEP)
        with torch.no_grad():
            out = m(_t(x), train=False)
        m(_t(x), train=True).sum().backward()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    if width % 8:
        assert sum(calls.values()) == 0, calls
    else:
        assert calls["conv3x3"] and calls["FusedBlockFunction"] and calls["Conv1x1Function"]


def test_clip_unet_fold_gate_matches_jax(monkeypatch):
    """The CLIP U-Nets take the same gate (clip_models.py:68): at width 36
    the kernel configuration reaches no kernel and equals JAX."""
    kernels = dict(w2d_level0=True, w2d_impl="pallas_fused", w2d_level1_fold2=True)
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (2, 32, 36, 3)).astype(np.float32)
    p = rng.uniform(0, 1, (2, 32, 36, 1)).astype(np.float32)
    jm = jax_models.ClipUnetPrompt(dtype=jnp.float32, clip_kwargs=CLIP_KW, **kernels)
    variables = jax_variables(jm, jnp.asarray(x), jnp.asarray(p))
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(p), train=False)
    with _counted(monkeypatch) as calls:
        m = build_model("clip_unet_prompt", device="cpu", dtype=torch.float32,
                        clip_kwargs=CLIP_KW, **kernels)
        m.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
        with torch.no_grad():
            out = m(_t(x), _t(p), train=False)
        m(_t(x), _t(p), train=True).sum().backward()
    assert sum(calls.values()) == 0, calls
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# ---- remat ----------------------------------------------------------------------

REMAT_STEPS = 2


def _batches(n, size=32, batch=8):
    rng = np.random.default_rng(31)
    return [(rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8),
             rng.integers(0, 3, (batch, size, size)).astype(np.uint8)) for _ in range(n)]


def _adam(t: Trainer) -> dict:
    return {f"{i}/{k}": t.optimizer.state[p][k].clone()
            for i, p in enumerate(t.trainable) for k in ("exp_avg", "exp_avg_sq")}


@pytest.fixture(scope="module")
def remat_runs():
    """The large_unet preset at the narrow widths of
    tests/test_torch_port_train.py: a JAX Trainer with ``remat=True`` and
    the port's Trainers with and without it, from one tree, over
    REMAT_STEPS steps."""
    args = port_config.preset("large_unet").model_args
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMGSEG_PALLAS_MIN_WP", "1")
        jt = JaxTrainer(dataclasses.replace(_cfg(jax_config, args), remat=True),
                        make_artifacts=False)
        params, stats = _tree_like(jt.state["params"], jt.state["batch_stats"], seed=13)
        jt.state["params"] = jax.tree.map(jnp.asarray, params)
        jt.state["batch_stats"] = jax.tree.map(jnp.asarray, stats)
        key = jax.random.PRNGKey(0)
        jax_losses_ = []
        for images, masks in _batches(REMAT_STEPS):
            jt.state, loss = jt._train_step(jt.state, jnp.asarray(images), jnp.asarray(masks),
                                            key)
            jax_losses_.append(float(loss))
    port = {}
    for remat in (False, True):
        pt = Trainer(dataclasses.replace(_cfg(port_config, args), remat=remat), device="cpu",
                     make_artifacts=False)
        pt.model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
        step_losses = [float(pt.train_step(_t(i), _t(m))) for i, m in _batches(REMAT_STEPS)]
        port[remat] = dict(trainer=pt, losses=step_losses)
    return dict(jax=jt, jax_losses=jax_losses_, port=port)


def test_remat_step_matches_jax_remat(remat_runs):
    pt = remat_runs["port"][True]["trainer"]
    np.testing.assert_allclose(remat_runs["port"][True]["losses"], remat_runs["jax_losses"],
                               **LOSS_TOL)
    params, stats = jax_from_state_dict(pt.model.state_dict())
    _assert_trees_close(params, remat_runs["jax"].state["params"], LOSS_TOL, "param")
    _assert_trees_close(stats, remat_runs["jax"].state["batch_stats"], LOSS_TOL, "batch_stats")


@pytest.mark.parametrize("what", ["state", "adam", "loss"])
def test_remat_equals_no_remat_bit_for_bit(remat_runs, what):
    """A running average committed again by the recomputed forward would
    read 0.81*r + 0.19*batch, not the 0.9*r + 0.1*batch of one commit."""
    on, off = remat_runs["port"][True], remat_runs["port"][False]
    if what == "loss":
        assert on["losses"] == off["losses"]
        return
    if what == "adam":
        a, b = _adam(on["trainer"]), _adam(off["trainer"])
    else:
        a, b = on["trainer"].model.state_dict(), off["trainer"].model.state_dict()
    assert sorted(a) == sorted(b) and a
    for k in b:
        assert torch.equal(a[k], b[k]), k


def test_remat_with_fused_deep_commits_once(monkeypatch):
    """One remat step of the fused_deep UNet runs every block's forward
    twice, and every BatchNorm's running averages equal one commit, those
    of the step without remat."""
    cfg = dataclasses.replace(port_config.preset("smoke"),
                              model_args=dict(WIDTHS, **FUSED_DEEP))
    images, masks = _batches(1)[0]
    state, forwards = {}, {}
    for remat in (False, True):
        t = Trainer(dataclasses.replace(cfg, remat=remat), device="cpu", make_artifacts=False)
        assert isinstance(t.model.enc3, fused.FusedDeepConvBlockDownsample)
        with monkeypatch.context() as mp, _counted(mp) as calls:
            t.train_step(_t(images), _t(masks), 3)
        state[remat], forwards[remat] = t.model.state_dict(), calls["FusedBlockFunction"]
    assert forwards == {False: 8, True: 16}
    init = Trainer(cfg, device="cpu", make_artifacts=False).model.state_dict()
    for k in state[False]:
        assert torch.equal(state[True][k], state[False][k]), k
    moved = [k for k in init if k.endswith("running_mean") and not torch.equal(init[k],
                                                                                state[True][k])]
    assert len(moved) == sum(k.endswith("running_mean") for k in init)


def test_remat_at_two_ranks_equals_no_remat(tmp_path):
    """Two gloo ranks: the recomputation repeats the statistics'
    all-reduces inside the backward, in the same order on both ranks."""
    ranks = mesh.launch("tests._torch_port_dist_worker:run_remat", 2, [str(tmp_path)],
                        timeout=600)
    assert [r["world"] for r in ranks] == [2, 2]
    arrays = [np.load(tmp_path / f"remat{r}.npz") for r in (0, 1)]
    for a in arrays:
        off = {k[4:]: a[k] for k in a.files if k.startswith("off/")}
        on = {k[3:]: a[k] for k in a.files if k.startswith("on/")}
        assert sorted(on) == sorted(off) and any(k.startswith("adam/") for k in on)
        for k in off:
            assert np.array_equal(on[k], off[k]), k
    for k in arrays[0].files:
        assert np.array_equal(arrays[0][k], arrays[1][k]), k


def test_remat_is_accepted_and_tensor_parallelism_still_raises():
    """``remat`` builds; with two model shards it is refused only as any
    model is in one process, which cannot form a model group of 2 (remat
    at M = 2: tests/test_torch_port_tensor_parallel_models.py)."""
    cfg = dataclasses.replace(port_config.preset("smoke"), remat=True)
    assert Trainer(cfg, device="cpu", make_artifacts=False).config.remat
    with pytest.raises(ValueError, match="model groups of 2"):
        Trainer(dataclasses.replace(cfg, n_model_shards=2), device="cpu", make_artifacts=False)


# ---- freeze_clip=False ------------------------------------------------------------

CLIP_SIZE, CLIP_BATCH = 32, 2


def test_unfrozen_tower_gradient_matches_jax_in_float64():
    """ClipUnet with freeze_clip=False: the tower's gradient of the
    model's loss against ``jax.grad`` of the JAX model with the same flag,
    both in float64."""
    rng = np.random.default_rng(41)
    x = rng.uniform(0, 1, (CLIP_BATCH, CLIP_SIZE, CLIP_SIZE, 3)).astype(np.float32)
    targets = rng.integers(0, 3, (CLIP_BATCH, CLIP_SIZE, CLIP_SIZE))
    jm32 = jax_models.ClipUnet(dtype=jnp.float32, clip_kwargs=CLIP_KW, freeze_clip=False)
    variables = jax_variables(jm32, jnp.asarray(x), seed=42)
    with jax.enable_x64(True):
        jm = jax_models.ClipUnet(dtype=jnp.float64, clip_kwargs=CLIP_KW, freeze_clip=False)
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731

        def objective(p):
            out, _ = jm.apply({"params": p, "batch_stats": f64(variables["batch_stats"])},
                              jnp.asarray(x, jnp.float64), train=True, mutable=["batch_stats"])
            return jax_losses.hybrid_loss(out, jnp.asarray(targets))

        ref = jax.device_get(jax.jit(jax.grad(objective))(f64(variables["params"])))
    pm = build_model("clip_unet", device="cpu", dtype=torch.float64, clip_kwargs=CLIP_KW,
                     freeze_clip=False)
    pm.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                       strict=True)
    losses.hybrid_loss(pm(_t(x), train=True), _t(targets)).backward()
    tower = {k: p.grad for k, p in pm.named_parameters() if k.startswith(CLIP)}
    assert tower and all(g is not None for g in tower.values())
    got = jax_from_state_dict(tower)[0]["clip_tower"]
    _assert_trees_close(got, ref["clip_tower"], GRAD_TOL, "tower grad")
    assert max(float(np.abs(v).max()) for v in _flat(ref["clip_tower"]).values()) > 1e-4


@pytest.mark.parametrize("name", ["clip_unet", "clip_res"])
def test_unfrozen_tower_trains_as_the_frozen_one(name):
    """Trainer steps with freeze_clip=False equal those with the flag on,
    bit for bit; the tower does not move and holds no gradient."""
    size = 64 if name == "clip_res" else CLIP_SIZE
    base = port_config.TrainConfig(
        model=name, model_args=dict(clip_kwargs=CLIP_KW), batch_size=CLIP_BATCH, bf16=False,
        seed=0, data=port_config.DataConfig(dataset="synthetic", synthetic_length=CLIP_BATCH,
                                            image_size=size, augmentations_per_datapoint=0))
    rng = np.random.default_rng(43)
    batch = (_t(rng.integers(0, 256, (CLIP_BATCH, size, size, 3), dtype=np.uint8)),
             _t(rng.integers(0, 3, (CLIP_BATCH, size, size)).astype(np.uint8)))
    out = {}
    for freeze in (True, False):
        cfg = dataclasses.replace(base, model_args=dict(base.model_args, freeze_clip=freeze))
        t = Trainer(cfg, device="cpu", make_artifacts=False)
        init = {k: v.clone() for k, v in t.model.state_dict().items() if k.startswith(CLIP)}
        losses_ = [float(t.train_step(*batch)) for _ in range(2)]
        for k, p in t.model.named_parameters():
            if k.startswith(CLIP):
                assert p.grad is None and p.requires_grad != freeze, k
                assert torch.equal(p.detach(), init[k]), k
        out[freeze] = (losses_, t.model.state_dict(), _adam(t))
    assert out[True][0] == out[False][0]
    for i in (1, 2):
        assert sorted(out[True][i]) == sorted(out[False][i])
        for k in out[True][i]:
            assert torch.equal(out[True][i][k], out[False][i][k]), k
