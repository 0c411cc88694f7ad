"""The port's CLIP stack (image_segmentation_tpu_torch: models/clip.py,
ops/cross_attention.py, models/clip_models.py, the CLIP parts of
utils/convert.py, the ``input_grad=False`` block) against the JAX package
on the CPU, in fp32.

Parameter trees are drawn from a numpy seed in the shapes the JAX modules
declare (lecun-scale kernels, BatchNorm running statistics away from the
identity) and converted with ``utils/convert.py``.  The CLIP tower is the
small one of tests/test_prompt_training.py (hidden 32, one layer, 2 heads,
MLP 64, patch 32, proj_dim 32); the U-Net widths are the models' own, at
32x32 images and batch 2.  The JAX side runs its Pallas kernels in
interpret mode with the kernel width gate lowered
(``IMGSEG_PALLAS_MIN_WP=1``); the port's kernel wrappers run their plain
versions.

Tolerances, each with its reason:

- ``clip_preprocess``: atol 1e-5; the two bilinear resizes compute their
  tap weights differently and agree to about 1e-6 on [0, 1] images when
  they scale 32 up to 224 (3e-7 when they shrink,
  tests/test_torch_port_slice.py), and the CLIP std divides that by ~0.27;
- the tower, the attention and the fusion: rtol = atol = 1e-5, fp32 sums
  over at most a few hundred terms in another order;
- model outputs: rtol = atol = 2e-4, the port's forward tolerance
  (test_torch_port_slice.py);
- gradients: rtol 1e-3, atol 1e-6 of the JAX model's float64 gradient, as
  test_torch_port_train.py holds the standard LargeUNet (JAX's own fp32
  gradient on the CPU is off here in both configurations, see
  test_model_gradients_match_jax; the conv biases before a training-mode
  BatchNorm have an exact gradient of 0, the port's is rounding noise
  which the atol covers);
- the ``input_grad=False`` block: its parameter gradients equal the
  ``input_grad=True`` block's bit for bit (the same CPU code).
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu.models import clip as jax_clip
from image_segmentation_tpu.models import clip_models as jax_models
from image_segmentation_tpu.ops import cross_attention as jax_ca
from image_segmentation_tpu.ops import losses as jax_losses
from image_segmentation_tpu.utils import torch_export
from image_segmentation_tpu_torch.models import clip, clip_models, fused
from image_segmentation_tpu_torch.models.registry import build_model
from image_segmentation_tpu_torch.ops import cross_attention as ca
from image_segmentation_tpu_torch.ops import fused_conv, losses
from image_segmentation_tpu_torch.utils.convert import (
    CLIP,
    jax_from_state_dict,
    state_dict_from_jax,
)

jax.config.update("jax_default_matmul_precision", "highest")
CLIP_KW = dict(hidden=32, layers=1, heads=2, mlp_dim=64, patch=32, proj_dim=32)
KERNELS = dict(w2d_level0=True, w2d_impl="pallas_fused", w2d_level1_fold2=True)
CONFIGS = {"standard": {}, "kernels": KERNELS}
TIGHT = dict(rtol=1e-5, atol=1e-5)
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
SIZE, BATCH = 32, 2


def random_tree(shapes, seed):
    """numpy leaves in the shapes of a JAX variables tree: lecun-scale
    kernels, embeddings of scale 0.02, BatchNorm/LayerNorm scales and
    running variances in [0.5, 1.5], biases and running means of scale
    0.1."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if "embedding']" in name:
            return (rng.standard_normal(s.shape) * 0.02).astype(np.float32)
        if name.endswith("['scale']") or name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_variables(model, *inputs, seed=0):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *inputs, train=False))
    return random_tree(shapes, seed)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, ref, tol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), err_msg=what, **tol)


# ---- the tower --------------------------------------------------------------

@pytest.mark.parametrize("size", [32, 256])
def test_clip_preprocess_matches_jax(size):
    x = np.random.default_rng(size).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    ref = jax_clip.clip_preprocess(jnp.asarray(x))
    got = clip.clip_preprocess(_t(x))
    assert got.shape == (2, 224, 224, 3)
    _close(got, ref, dict(rtol=0, atol=1e-5))


def _tower_state_dict(params):
    sd = state_dict_from_jax({"clip_tower": params}, {})
    return {k[len(CLIP):]: v for k, v in sd.items()}


@pytest.mark.parametrize("kw", [CLIP_KW, dict(CLIP_KW, layers=2, heads=4, proj_dim=48)])
def test_clip_tower_matches_jax(kw):
    pixels = np.random.default_rng(1).standard_normal((2, 224, 224, 3)).astype(np.float32)
    model = jax_clip.ClipVisionTower(dtype=jnp.float32, **kw)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    params = random_tree(shapes, 2)["params"]
    ref = model.apply({"params": params}, jnp.asarray(pixels))
    tower = clip.ClipVisionTower(dtype=torch.float32, **kw)
    tower.load_state_dict(_tower_state_dict(params), strict=True)
    with torch.no_grad():
        got = tower(_t(pixels))
    assert got.shape == (2, kw["proj_dim"]) and got.dtype == torch.float32
    _close(got, ref, TIGHT)


# ---- the attention (K8's plain version) and the fusion ----------------------

@pytest.mark.parametrize("heads,s", [(1, 1), (4, 1), (4, 3), (2, 8)])
def test_cross_attention_plain_matches_reference_and_pallas_kernel(heads, s):
    b, length, d = 2, 64, 32
    rng = np.random.default_rng(heads * 10 + s)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, length, d), (b, s, d), (b, s, d)))
    ref = jax_ca.reference_cross_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    kern = jax_ca.pallas_cross_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                                         block_q=32, interpret=True)
    before = ca.cross_attention.launches
    got = ca.cross_attention(_t(q), _t(k), _t(v), heads)  # a CPU tensor: the plain version
    assert ca.cross_attention.launches == before
    _close(got, ref, TIGHT)
    _close(got, kern, TIGHT)


def test_cross_attention_refuses_bad_operands():
    q, k = torch.zeros((1, 4, 6)), torch.zeros((1, 2, 6))
    with pytest.raises(ValueError, match="divisible"):
        ca.cross_attention(q, k, k, 4)
    with pytest.raises(ValueError, match="must be"):
        ca.cross_attention(q, k, torch.zeros((1, 3, 6)), 2)


@pytest.mark.parametrize("heads,s,kv", [(1, 1, 32), (4, 1, 16), (1, 5, 32), (4, 3, 16)])
def test_fusion_matches_jax(heads, s, kv):
    """S = 1 takes the one-key path (no kernel), S > 1 the attention."""
    b, h, w, c = 2, 4, 4, 32
    rng = np.random.default_rng(s + heads)
    spatial = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ctx = rng.standard_normal((b, s, kv) if s > 1 else (b, kv)).astype(np.float32)
    jm = jax_ca.CrossAttentionFusion(c, num_heads=heads, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(spatial),
                                            jnp.asarray(ctx)))
    params = random_tree(shapes, 3)["params"]
    assert ("q_proj" in params) == (s > 1)  # flax never creates q/k at S = 1
    ref = jm.apply({"params": params}, jnp.asarray(spatial), jnp.asarray(ctx))
    pm = ca.CrossAttentionFusion(c, heads, torch.float32, kv_dim=kv)
    pm.load_state_dict(ca.mha_state_dict_from_params(params), strict=True)
    before = ca.cross_attention.launches
    with torch.no_grad():
        got = pm(_t(spatial), _t(ctx))
    assert ca.cross_attention.launches == before
    _close(got, ref, TIGHT)
    back = ca.mha_params_from_torch(pm.state_dict(), with_qk=s > 1)
    for name, leaves in params.items():
        for leaf, a in leaves.items():
            np.testing.assert_array_equal(back[name][leaf], np.asarray(a), err_msg=name + leaf)


def test_mha_params_from_torch_matches_jax():
    torch.manual_seed(1)
    mha = torch.nn.MultiheadAttention(embed_dim=16, num_heads=2)
    sd = mha.state_dict()
    ref = jax_ca.mha_params_from_torch({k: v.numpy() for k, v in sd.items()}, prefix="")
    got = ca.mha_params_from_torch(sd, prefix="")
    for name in ref:
        for leaf in ref[name]:
            np.testing.assert_array_equal(got[name][leaf], ref[name][leaf])


# ---- the models -------------------------------------------------------------

def _model_inputs(prompt: bool, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    p = rng.uniform(0, 1, (BATCH, SIZE, SIZE, 1)).astype(np.float32)
    return (x, p) if prompt else (x,)


def _jax_model(name, args):
    cls = jax_models.ClipUnetPrompt if name == "clip_unet_prompt" else jax_models.ClipUnet
    return cls(dtype=jnp.float32, clip_kwargs=CLIP_KW, **args)


def _targets(name, seed=6):
    """Fixed random targets for the model's own loss (CE over 3 classes,
    or the binary hybrid loss)."""
    return np.random.default_rng(seed).integers(0, 3 if name == "clip_unet" else 2,
                                                (BATCH, SIZE, SIZE))


@pytest.fixture(scope="module", params=[(m, c) for m in ("clip_unet", "clip_unet_prompt")
                                        for c in CONFIGS])
def model_runs(request):
    return _model_runs(*request.param)


def _jax_loss(name):
    return jax_losses.hybrid_loss if name == "clip_unet" else jax_losses.hybrid_loss_binary


@functools.lru_cache(maxsize=None)
def _jax_grads_f64(name):
    """The JAX standard model's training-mode gradient in float64 (the
    folded/Pallas model shares its tree and its math)."""
    inputs = _model_inputs(name == "clip_unet_prompt")
    variables = jax_variables(_jax_model(name, {}), *[jnp.asarray(a) for a in inputs])
    with jax.enable_x64(True):
        cls = jax_models.ClipUnetPrompt if name == "clip_unet_prompt" else jax_models.ClipUnet
        model = cls(dtype=jnp.float64, clip_kwargs=CLIP_KW)
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        xin = [jnp.asarray(a, jnp.float64) for a in inputs]

        def objective(p):
            out, _ = model.apply({"params": p, "batch_stats": f64(variables["batch_stats"])},
                                 *xin, train=True, mutable=["batch_stats"])
            return _jax_loss(name)(out, jnp.asarray(_targets(name)))

        return jax.device_get(jax.jit(jax.grad(objective))(f64(variables["params"])))


def _model_runs(name, config):
    """Both models from one tree: eval and train outputs, the running
    statistics after the train forward, the port's parameter gradients and
    the JAX float64 ones."""
    inputs = _model_inputs(name == "clip_unet_prompt")
    targets = _targets(name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMGSEG_PALLAS_MIN_WP", "1")
        jm = _jax_model(name, CONFIGS[config])
        jin = [jnp.asarray(a) for a in inputs]
        variables = jax_variables(jm, *jin)
        params, stats = variables["params"], variables["batch_stats"]

        @jax.jit
        def forwards(p):
            out, mutated = jm.apply({"params": p, "batch_stats": stats}, *jin, train=True,
                                    mutable=["batch_stats"])
            loss = _jax_loss(name)(out, jnp.asarray(targets))
            return jm.apply({"params": p, "batch_stats": stats}, *jin, train=False), out, \
                loss, mutated["batch_stats"]

        jeval, jtrain, jloss, jstats = forwards(params)

    pm = build_model(name, device="cpu", dtype=torch.float32, clip_kwargs=CLIP_KW,
                     **CONFIGS[config])
    pm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    pin = [_t(a) for a in inputs]
    with torch.no_grad():
        peval = pm(*pin, train=False)
    ptrain = pm(*pin, train=True)
    portf = losses.hybrid_loss if name == "clip_unet" else losses.hybrid_loss_binary
    ploss = portf(ptrain, _t(targets))
    ploss.backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in pm.named_parameters() if not k.startswith(CLIP)}
    _, pstats = jax_from_state_dict(pm.state_dict())
    return dict(name=name, config=config, model=pm,
                jax=dict(eval=jeval, train=jtrain, loss=jloss, stats=jstats,
                         grads=_jax_grads_f64(name)),
                port=dict(eval=peval, train=ptrain, loss=ploss, stats=pstats,
                          grads=jax_from_state_dict(grads)[0]))


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def test_model_forward_matches_jax(model_runs):
    j, p = model_runs["jax"], model_runs["port"]
    out_ch = 3 if model_runs["name"] == "clip_unet" else 1
    for what in ("eval", "train"):
        assert p[what].shape == (BATCH, SIZE, SIZE, out_ch) and p[what].dtype == torch.float32
        _close(p[what], j[what], FWD_TOL, what)
    _close(p["loss"], j["loss"], FWD_TOL, "loss")


def test_model_running_stats_match_jax(model_runs):
    got, ref = _flat(model_runs["port"]["stats"]), _flat(model_runs["jax"]["stats"])
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **FWD_TOL)


def test_model_gradients_match_jax(model_runs):
    """Every trainable parameter's gradient (the tower is frozen: JAX's
    stop_gradient, the port's no_grad), held to the JAX model's float64
    gradient.  The JAX package's own fp32 gradient on the CPU is off from
    it by up to 14 % of a leaf's largest element (enc3's bn1 and conv1, in
    both configurations; up to 1.9 % in dec1/dec2 of ClipUnet), while the
    port agrees with it to under 1e-5 of the leaf's largest element.  The
    bottleneck's gradients are exactly 0 on both sides: the one-token
    fusion does not read its output."""
    ref = _flat(model_runs["jax"]["grads"])
    got = _flat(model_runs["port"]["grads"])
    ref = {k: v for k, v in ref.items() if not k.startswith("['clip_tower']")}
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **GRAD_TOL)
        if k.startswith("['bottleneck']"):
            assert not ref[k].any() and not got[k].any(), k


def test_model_layout_and_kernel_blocks(model_runs):
    pm = model_runs["model"]
    kernels = model_runs["config"] == "kernels"
    assert isinstance(pm.enc1, fused.FusedConvBlockDownsample) == kernels
    assert isinstance(pm.dec3, fused.FusedConvBlockUpsampleSkip) == kernels
    assert not any(p.requires_grad for p in pm.clip_feature_extractor.parameters())
    if model_runs["name"] == "clip_unet_prompt":
        assert isinstance(pm.prompt_encoder.enc2, fused.FusedConvBlockDownsample) == kernels
        if kernels:
            assert pm.prompt_encoder.enc1.block[0].input_grad is False


@pytest.mark.parametrize("name", ["clip_unet", "clip_unet_prompt"])
def test_converter_matches_torch_export(name):
    """state_dict_from_jax gives the JAX package's exporter's state dict
    (the reference ClipUnet/ClipUnetPrompt layout, q/k zero-filled), and
    jax_from_state_dict gives the JAX tree back.  The exporter packs q/k/v
    and needs proj_dim = 512."""
    kw = dict(CLIP_KW, proj_dim=512)
    cls = jax_models.ClipUnetPrompt if name == "clip_unet_prompt" else jax_models.ClipUnet
    jm = cls(dtype=jnp.float32, clip_kwargs=kw)
    variables = jax_variables(jm, *[jnp.asarray(a) for a in _model_inputs(name != "clip_unet")],
                              seed=8)
    params, stats = variables["params"], variables["batch_stats"]
    export = {"clip_unet": torch_export.clip_unet_state_dict,
              "clip_unet_prompt": torch_export.clip_unet_prompt_state_dict}[name]
    ref = export(params, stats)
    sd = state_dict_from_jax(params, stats)
    assert sorted(sd) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k], err_msg=k)
    pm = build_model(name, device="cpu", dtype=torch.float32, clip_kwargs=kw)
    pm.load_state_dict(sd, strict=True)
    p2, s2 = jax_from_state_dict(pm.state_dict())
    for got, want in ((p2, params), (s2, stats)):
        g, w = _flat(got), _flat(want)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---- the wgrad-only block (input_grad=False) -------------------------------

def _block_grads(input_grad: bool, x: torch.Tensor):
    torch.manual_seed(0)
    blk = fused.FusedConvBlockDownsample(1, 8, input_grad=input_grad)
    calls = {"dgrad": 0}
    real = fused_conv.conv3x3_dgrad

    def counted(*a, **k):
        calls["dgrad"] += 1
        return real(*a, **k)

    with mock.patch.object(fused_conv, "conv3x3_dgrad", counted):
        out = blk(x, train=True)
        out.square().mean().backward()
    return {k: p.grad.clone() for k, p in blk.named_parameters()}, calls["dgrad"], out


def test_input_grad_false_block_runs_wgrad_alone():
    """Cin = 1, the heatmap: the same parameter gradients as the
    input_grad=True block, one dgrad fewer (conv2's only), and the input
    gets no gradient."""
    x = torch.rand((2, 16, 16, 1), generator=torch.Generator().manual_seed(3))
    g_true, n_true, out_true = _block_grads(True, x)
    g_false, n_false, out_false = _block_grads(False, x)
    assert (n_true, n_false) == (2, 1)
    assert torch.equal(out_true, out_false)
    assert sorted(g_true) == sorted(g_false)
    for k in g_true:
        assert torch.equal(g_true[k], g_false[k]), k


def test_input_grad_false_block_refuses_an_input_that_requires_grad():
    blk = fused.FusedConvBlockDownsample(1, 8, input_grad=False)
    x = torch.rand((1, 8, 8, 1), requires_grad=True)
    for train in (True, False):
        with pytest.raises(RuntimeError, match="input_grad=False"):
            blk(x, train=train)
    with torch.no_grad():
        assert blk(x, train=False).shape == (1, 4, 4, 8)
    x_plain = torch.rand((1, 8, 8, 1), requires_grad=True)  # input_grad=True: a real gradient
    fused.FusedConvBlockDownsample(1, 8)(x_plain, train=True).sum().backward()
    assert x_plain.grad is not None and x_plain.grad.abs().sum() > 0


def test_clip_models_default_to_frozen_and_refuse_unfrozen():
    """The tower is frozen by default; ``freeze_clip=False``, refused until
    the option was ported, builds and loads the JAX tree of the JAX model
    with the same flag, its tower requiring grad."""
    x = _model_inputs(False)[0]
    variables = jax_variables(_jax_model("clip_unet", {"freeze_clip": False}), jnp.asarray(x))
    for freeze in (None, True, False):
        kw = {} if freeze is None else {"freeze_clip": freeze}
        pm = build_model("clip_unet", device="cpu", clip_kwargs=CLIP_KW, **kw)
        pm.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                           strict=True)
        tower = [p for k, p in pm.named_parameters() if k.startswith(CLIP)]
        assert tower and all(p.requires_grad == (freeze is False) for p in tower)
    assert clip_models.FROZEN_PREFIXES == ("clip_feature_extractor.",)
