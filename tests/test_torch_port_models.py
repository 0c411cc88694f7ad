"""The port's last models (image_segmentation_tpu_torch: models/resnet.py,
ClipResSegmentationModel, ClipResSegmentationClassification and
ClipAutoencoder in models/clip_models.py, models/prompt_fusion.py, the
optimizer's frozen parts, the losses dice_ce_loss,
combined_confusion_loss and dice_from_iou) against the JAX package on the
CPU, in fp32 and float64; their trees and artifacts are
tests/test_torch_port_clip_export.py's.

Parameter trees are drawn from a numpy seed in the shapes the JAX modules
declare (tests/test_torch_port_clip.py ``random_tree``: lecun-scale
kernels, BatchNorm running statistics away from the identity) and
converted with ``utils/convert.py``.  The CLIP tower is the small one of
tests/test_torch_port_clip.py; the ResNet-34 and the decoders run at their
full widths, at 64x64 images (the backbone needs a multiple of 32) and
batch 2.  The JAX side runs its Pallas kernels in interpret mode with the
kernel width gate lowered (``IMGSEG_PALLAS_MIN_WP=1``); the port's kernel
wrappers run their plain versions.

The one-token fusion does not read the map it is fused with
(``out_proj(v_proj(embedding))`` broadcast), so no model-level test can
see the backbone: ``ResNet34Features`` is held alone, its outputs in eval
and in training and its running statistics.

The gradients are taken in float64 on both sides: the port's models run
in float64 on fp32 parameters (:func:`~image_segmentation_tpu_torch.ops.
precision.wide` keeps the BatchNorms, the plain versions of the kernels
and the losses in float64) against the JAX model's float64 gradient.  In
fp32 these decoders' gradients are 1-2 % (of a leaf's largest element)
from float64 in the JAX package itself as in the port: fp32 rounding flips
a few ReLU masks in the last block (measured: the cotangent is exact to
3e-6 at dec4's output and 5e-2 off after its bn2 + ReLU backward in
ClipAutoencoder), a jump that no tolerance on a smooth function covers.
The port's float64 gradient agrees with JAX's to 2e-7 of a leaf's
largest element, the CLIP tower reading the same pixels on both sides.  Likewise the ResNet's training-mode output, whose last
stage normalises 8 values per channel at 64x64 and batch 2: JAX's fp32
output is 4.8e-4 from its float64 one, the port's fp32 output 2.4e-4, the
port's float64 output 6e-13; it is held in float64, and the port's fp32
output no further from float64 than JAX's.

Tolerances, each with its reason:

- outputs, running statistics: rtol = atol = 2e-4, the port's forward
  tolerance (tests/test_torch_port_slice.py);
- gradients: rtol 1e-3, atol 1e-6 of the JAX model's float64 gradient, as
  tests/test_torch_port_clip.py (the conv biases before a training-mode
  BatchNorm have an exact gradient of 0; the port's is rounding noise
  which the atol covers);
- the losses: rtol = atol = 1e-6, fp32 on both sides.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu.engine.train import make_loss_fn as jax_make_loss_fn
from image_segmentation_tpu.models import clip_models as jax_models
from image_segmentation_tpu.models import prompt_fusion as jax_prompt_fusion
from image_segmentation_tpu.models import resnet as jax_resnet
from image_segmentation_tpu.ops import losses as jax_losses
from image_segmentation_tpu_torch.config import OptimizerConfig
from image_segmentation_tpu_torch.engine.train import build_optimizer, make_loss_fn
from image_segmentation_tpu_torch.models import clip, clip_models, fused, resnet
from image_segmentation_tpu_torch.models.registry import build_model
from image_segmentation_tpu_torch.ops import fused_conv, losses
from image_segmentation_tpu_torch.utils.convert import (
    CLIP,
    RESNET,
    jax_from_state_dict,
    state_dict_from_jax,
)
from tests.test_torch_port_clip import CLIP_KW, jax_variables, random_tree

jax.config.update("jax_default_matmul_precision", "highest")
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
SIZE, BATCH = 64, 2
KERNELS = dict(w2d_level0=True, w2d_impl="pallas_fused")  # the clip_res/segment_classifier presets'
JAX_CLASSES = {"clip_res": jax_models.ClipResSegmentationModel,
               "clip_res_class": jax_models.ClipResSegmentationClassification,
               "clip_autoencoder": jax_models.ClipAutoencoder}
RUNS = [("clip_res", "standard"), ("clip_res", "kernels"), ("clip_res_class", "standard"),
        ("clip_res_class", "kernels"), ("clip_autoencoder", "standard")]
FROZEN_JAX = ("['clip_tower']", "['resnet_backbone']")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, ref, tol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), err_msg=what, **tol)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def _images(seed, size=SIZE, n=BATCH):
    return np.random.default_rng(seed).uniform(0, 1, (n, size, size, 3)).astype(np.float32)


# ---- ResNet34Features alone -------------------------------------------------

def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture(scope="module")
def backbone():
    """The JAX and the port backbone from one tree: eval outputs, train
    outputs (fp32 and float64), the running statistics after the fp32
    train forward."""
    x = _images(1)
    jm = jax_resnet.ResNet34Features(dtype=jnp.float32)
    variables = jax_variables(jm, jnp.asarray(x))
    params, stats = variables["params"], variables["batch_stats"]

    @jax.jit
    def forwards(p, s):
        out, mutated = jm.apply({"params": p, "batch_stats": s}, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        return jm.apply({"params": p, "batch_stats": s}, jnp.asarray(x)), out, mutated

    jeval, jtrain, jstats = forwards(params, stats)
    with jax.enable_x64(True):
        m64 = jax_resnet.ResNet34Features(dtype=jnp.float64)
        j64 = np.asarray(m64.apply(_f64(variables), jnp.asarray(x, jnp.float64), train=True,
                                   mutable=["batch_stats"])[0])
    sd = state_dict_from_jax({"resnet_backbone": params}, {"resnet_backbone": stats})
    sd = {k[len("encoder."):]: v for k, v in sd.items()}
    port = {}
    for dt in (torch.float32, torch.float64):
        pm = resnet.ResNet34Features(dt)
        pm.load_state_dict(sd, strict=True)
        with torch.no_grad():
            port[dt] = (pm(_t(x).to(dt)), pm(_t(x).to(dt), train=True))
        if dt == torch.float32:
            pstats = jax_from_state_dict({"encoder." + k: v for k, v in pm.state_dict().items()})[1]
    return dict(jax=dict(eval=jeval, train=np.asarray(jtrain), train64=j64,
                         stats=jstats["batch_stats"]),
                port=dict(eval=port[torch.float32][0], train=port[torch.float32][1],
                          train64=port[torch.float64][1], stats=pstats["resnet_backbone"]))


def test_resnet_outputs_match_jax(backbone):
    j, p = backbone["jax"], backbone["port"]
    for what in ("eval", "train", "train64"):
        assert p[what].shape == (BATCH, SIZE // 32, SIZE // 32, 512)
    _close(p["eval"], j["eval"], FWD_TOL, "eval")
    _close(p["train64"], j["train64"], FWD_TOL, "train, float64")
    port_err = np.abs(p["train"].double().numpy() - j["train64"]).max()
    assert port_err <= np.abs(j["train"] - j["train64"]).max(), "train, fp32 vs float64"


def test_resnet_running_stats_match_jax(backbone):
    got, ref = _flat(backbone["port"]["stats"]), _flat(backbone["jax"]["stats"])
    assert sorted(got) == sorted(ref) and len(ref) == 2 * 36  # 36 BatchNorms, mean and var
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **FWD_TOL)


# ---- the ClipRes models and ClipAutoencoder --------------------------------

def _jax_model(name, args, dtype=jnp.float32):
    return JAX_CLASSES[name](dtype=dtype, clip_kwargs=CLIP_KW, **args)


def _targets(name, seed=6):
    rng = np.random.default_rng(seed)
    masks = rng.integers(0, 2 if name == "clip_res_class" else 3, (BATCH, SIZE, SIZE))
    return {"masks": masks, "labels": rng.integers(0, 2, (BATCH,)).astype(np.float32)}


def _loss_name(name):
    return "class_binary" if name == "clip_res_class" else "hybrid"


@functools.lru_cache(maxsize=None)
def _jax_grads_f64(name):
    """The JAX standard model's training-mode gradient in float64 (the
    kernel configuration shares its tree and its math).  Its tower reads
    the port's float64 ``clip_preprocess`` of the images: the two resizes
    to 224x224 differ by ~1e-6 (held apart at 1e-5 in
    tests/test_torch_port_clip.py), enough to move a ReLU mask."""
    x = _images(5)
    variables = jax_variables(_jax_model(name, {}), jnp.asarray(x))
    pixels = clip.clip_preprocess(_t(x).double()).numpy()
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_models, "clip_preprocess", lambda _: jnp.asarray(pixels))
        model = _jax_model(name, {}, jnp.float64)
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        batch = {k: jnp.asarray(v) for k, v in _targets(name).items()}

        def objective(p):
            out, _ = model.apply({"params": p, "batch_stats": f64(variables["batch_stats"])},
                                 jnp.asarray(x, jnp.float64), train=True, mutable=["batch_stats"])
            return jax_make_loss_fn(_loss_name(name))(out, batch)

        return jax.device_get(jax.jit(jax.grad(objective))(f64(variables["params"])))


@pytest.fixture(scope="module", params=RUNS, ids=["-".join(r) for r in RUNS])
def model_runs(request):
    """Both models from one tree: eval and train outputs, the loss, the
    running statistics after the train forward, the port's parameter
    gradients and the JAX float64 ones."""
    name, config = request.param
    args = KERNELS if config == "kernels" else {}
    x, targets = _images(5), _targets(name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMGSEG_PALLAS_MIN_WP", "1")
        jm = _jax_model(name, args)
        variables = jax_variables(jm, jnp.asarray(x))
        params, stats = variables["params"], variables["batch_stats"]
        jbatch = {k: jnp.asarray(v) for k, v in targets.items()}

        @jax.jit
        def forwards(p):
            out, mutated = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                    train=True, mutable=["batch_stats"])
            loss = jax_make_loss_fn(_loss_name(name))(out, jbatch)
            return (jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x)), out, loss,
                    mutated["batch_stats"])

        jeval, jtrain, jloss, jstats = forwards(params)

    pm = build_model(name, device="cpu", dtype=torch.float32, clip_kwargs=CLIP_KW, **args)
    pm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        peval = pm(_t(x), train=False)
        ptrain = pm(_t(x), train=True)
        ploss = make_loss_fn(_loss_name(name))(ptrain, {k: _t(v) for k, v in targets.items()})
    _, pstats = jax_from_state_dict(pm.state_dict())
    grads = _port_grads_f64(name, args, params, stats, x, targets)
    return dict(name=name, config=config, model=pm, start=state_dict_from_jax(params, stats),
                jax=dict(eval=jeval, train=jtrain, loss=jloss, stats=jstats,
                         grads=_jax_grads_f64(name)),
                port=dict(eval=peval, train=ptrain, loss=ploss, stats=pstats,
                          grads=jax_from_state_dict(grads)[0]))


def _port_grads_f64(name, args, params, stats, x, targets):
    """The port model's training-mode gradient, computed in float64 on the
    fp32 parameters; the frozen parts have none."""
    pm = build_model(name, device="cpu", dtype=torch.float64, clip_kwargs=CLIP_KW, **args)
    pm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    out = pm(_t(x).double(), train=True)
    make_loss_fn(_loss_name(name))(out, {k: _t(v) for k, v in targets.items()}).backward()
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            for k, p in pm.named_parameters() if not k.startswith((CLIP, RESNET))}


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def test_model_forward_matches_jax(model_runs):
    j, p = model_runs["jax"], model_runs["port"]
    name = model_runs["name"]
    shapes = ([(BATCH, SIZE, SIZE, 1), (BATCH, 1)] if name == "clip_res_class"
              else [(BATCH, SIZE, SIZE, 3)])
    for what in ("eval", "train"):
        got, ref = _outputs(p[what]), _outputs(j[what])
        assert [tuple(t.shape) for t in got] == shapes
        for i, (a, b) in enumerate(zip(got, ref, strict=True)):
            assert a.dtype == torch.float32
            _close(a, b, FWD_TOL, f"{what}[{i}]")
    _close(p["loss"], j["loss"], FWD_TOL, "loss")


def test_model_running_stats_match_jax(model_runs):
    """Every BatchNorm's, the frozen backbone's included."""
    got, ref = _flat(model_runs["port"]["stats"]), _flat(model_runs["jax"]["stats"])
    assert sorted(got) == sorted(ref)
    if model_runs["name"] != "clip_autoencoder":
        assert any(k.startswith("['resnet_backbone']") for k in ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **FWD_TOL)


def test_model_gradients_match_jax(model_runs):
    """Every trainable parameter's float64 gradient, held to the JAX
    model's; the tower and the backbone are frozen (JAX's stop_gradient:
    zeros there, none in the port)."""
    ref = {k: v for k, v in _flat(model_runs["jax"]["grads"]).items()
           if not k.startswith(FROZEN_JAX)}
    got = _flat(model_runs["port"]["grads"])
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **GRAD_TOL)
    for k, v in _flat(model_runs["jax"]["grads"]).items():
        if k.startswith(FROZEN_JAX):
            assert not v.any(), k


def test_model_layout_kernels_and_frozen_parts(model_runs):
    pm, name = model_runs["model"], model_runs["name"]
    kernels = model_runs["config"] == "kernels"
    assert not any(p.requires_grad for p in pm.clip_feature_extractor.parameters())
    if name == "clip_autoencoder":
        return
    assert isinstance(pm.dec5, fused.FusedConvBlockUpsample) == kernels
    assert not any(p.requires_grad for p in pm.encoder.parameters())
    assert all(p.requires_grad for k, p in pm.named_parameters()
               if not k.startswith((CLIP, RESNET)))
    if name == "clip_res":
        assert isinstance(pm.out, fused.FusedConvBlock) == kernels
        for what in ("eval", "train"):  # the output block's BN + ReLU: the reference's quirk
            assert float(model_runs["port"][what].min()) >= 0.0, what


def test_clip_res_out_block_reads_the_image_as_the_second_input():
    """The folded out block's conv1 takes [dec5 | image] as the kernels'
    two inputs (``x_b``), never a concatenated tensor."""
    pm = build_model("clip_res", device="cpu", dtype=torch.float32, clip_kwargs=CLIP_KW, **KERNELS)
    seen = []
    real = fused_conv.conv3x3

    def spy(x, w, bias, **kw):
        seen.append((x.shape[-1], None if kw.get("x_b") is None else kw["x_b"].shape[-1],
                     w.shape[0]))
        return real(x, w, bias, **kw)

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(fused_conv, "conv3x3", spy)
        pm(_t(_images(2, 32)))
    assert seen == [(16, None, 16), (16, None, 16), (16, 3, 3), (3, None, 3)]


# ---- prompt_fusion ----------------------------------------------------------

@pytest.mark.parametrize("fusion", ["concat", "add"])
def test_prompt_fusion_matches_jax(fusion):
    """Forward in eval and train and the float64 gradients of
    SegmentationModelWithPrompt, 32x32, batch 2, a 3-dim prompt."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (BATCH, 32, 32, 3)).astype(np.float32)
    prompt = rng.uniform(0, 1, (BATCH, 32, 32)).astype(np.float32)
    targets = rng.integers(0, 2, (BATCH, 32, 32))
    jm = jax_prompt_fusion.SegmentationModelWithPrompt(fusion=fusion, dtype=jnp.float32)
    variables = jax_variables(jm, jnp.asarray(x), jnp.asarray(prompt), seed=3)
    params, stats = variables["params"], variables["batch_stats"]
    jeval = jm.apply(variables, jnp.asarray(x), jnp.asarray(prompt))
    jtrain, _ = jm.apply(variables, jnp.asarray(x), jnp.asarray(prompt), train=True,
                         mutable=["batch_stats"])
    with jax.enable_x64(True):
        m64 = jax_prompt_fusion.SegmentationModelWithPrompt(fusion=fusion, dtype=jnp.float64)
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731

        def objective(p):
            out, _ = m64.apply({"params": p, "batch_stats": f64(stats)},
                               jnp.asarray(x, jnp.float64), jnp.asarray(prompt, jnp.float64),
                               train=True, mutable=["batch_stats"])
            return jax_losses.hybrid_loss_binary(out, jnp.asarray(targets))

        jgrads = jax.device_get(jax.jit(jax.grad(objective))(f64(params)))
    pm = build_model("prompt_fusion", device="cpu", dtype=torch.float32, fusion=fusion)
    pm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        _close(pm(_t(x), _t(prompt)), jeval, FWD_TOL, "eval")
        _close(pm(_t(x), _t(prompt), train=True), jtrain, FWD_TOL, "train")
    p64 = build_model("prompt_fusion", device="cpu", dtype=torch.float64, fusion=fusion)
    p64.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    out = p64(_t(x).double(), _t(prompt).double(), train=True)
    losses.hybrid_loss_binary(out, _t(targets)).backward()
    got = _flat(jax_from_state_dict({k: p.grad for k, p in p64.named_parameters()})[0])
    ref = _flat(jgrads)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **GRAD_TOL)


def test_prompt_fusion_refuses_an_unknown_fusion():
    with pytest.raises(ValueError, match="unknown fusion"):
        build_model("prompt_fusion", device="cpu", fusion="mul")


# ---- the optimizer ----------------------------------------------------------

@pytest.mark.parametrize("name", ["clip_res", "clip_res_class", "autoencoder", "prompt_fusion"])
def test_the_optimizer_holds_what_jax_trains(name):
    """The tower and the ResNet are out of the optimizer (JAX masks
    ``clip_tower`` and ``resnet_backbone``); the autoencoder's and
    prompt_fusion's encoders, whose keys also begin ``encoder``/
    ``image_encoder``, are in it; ``freeze_backbone=False`` changes
    nothing."""
    args = dict(clip_kwargs=CLIP_KW) if name.startswith("clip") else {}
    if name == "clip_res":
        args["freeze_backbone"] = False
    pm = build_model(name, device="cpu", dtype=torch.float32, **args)
    held = {id(p) for g in build_optimizer(OptimizerConfig(), pm).param_groups for p in g["params"]}
    for k, p in pm.named_parameters():
        frozen = k.startswith((CLIP, RESNET))
        assert (id(p) in held) != frozen, k
    assert any(k.startswith(("encoder.", "image_encoder.")) and id(p) in held
               for k, p in pm.named_parameters()) == (name in ("autoencoder", "prompt_fusion"))


@pytest.mark.parametrize("name", sorted(JAX_CLASSES))
def test_clip_res_models_refuse_an_unfrozen_tower(name):
    """``freeze_clip=False``, refused until the option was ported, builds
    and loads the JAX tree of the JAX model with the same flag; the
    training forward is the frozen model's, and the tower gets a gradient
    at the model level (tests/test_torch_port_options.py holds it to
    ``jax.grad``)."""
    x = _t(_images(7))
    variables = jax_variables(_jax_model(name, {"freeze_clip": False}), jnp.asarray(x.numpy()))
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    outs = {}
    for freeze in (True, False):
        pm = build_model(name, device="cpu", dtype=torch.float32, clip_kwargs=CLIP_KW,
                         freeze_clip=freeze)
        pm.load_state_dict(sd, strict=True)
        outs[freeze] = _outputs(pm(x, train=True))
        tower = [p for k, p in pm.named_parameters() if k.startswith(CLIP)]
        assert tower and all(p.requires_grad != freeze for p in tower)
    for a, b in zip(outs[True], outs[False], strict=True):
        assert torch.equal(a.detach(), b.detach())
    sum(o.sum() for o in outs[False]).backward()
    assert all(p.grad is not None for p in tower)
    assert any(float(p.grad.abs().max()) > 0 for p in tower)
    assert clip_models.FROZEN_PREFIXES == ("clip_feature_extractor.",)


# ---- the losses -------------------------------------------------------------

@pytest.mark.parametrize("fn", ["dice_ce_loss", "combined_confusion_loss", "dice_from_iou"])
def test_remaining_losses_match_jax(fn):
    """Random logits; targets with every class and with a class absent
    (the dice's special case); dice_from_iou on the IoU of the same."""
    rng = np.random.default_rng(15)
    logits = (rng.standard_normal((3, 6, 7, 3)) * 2).astype(np.float32)
    for targets in (rng.integers(0, 3, (3, 6, 7)), rng.integers(0, 2, (3, 6, 7))):
        if fn == "dice_from_iou":
            v = losses.iou(_t(logits), _t(targets))
            got, ref = losses.dice_from_iou(v), jax_losses.dice_from_iou(jnp.asarray(v.numpy()))
        else:
            got = getattr(losses, fn)(_t(logits), _t(targets))
            ref = getattr(jax_losses, fn)(jnp.asarray(logits), jnp.asarray(targets))
        np.testing.assert_allclose(float(got), float(ref), **LOSS_TOL)


def test_every_jax_loss_name_is_ported():
    for name in ("hybrid", "ce", "dice_ce", "hybrid_binary", "mse", "class_binary"):
        assert callable(make_loss_fn(name))
    with pytest.raises(KeyError):
        make_loss_fn("no_such_loss")
