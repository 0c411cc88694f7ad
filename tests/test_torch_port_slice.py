"""The port's serving slice (image_segmentation_tpu_torch) against the JAX
package, end to end on the CPU in fp32.

One parameter tree, drawn from a numpy seed in the shape the standard JAX
LargeUNet declares (the folded/fused model shares it), with BatchNorm
running statistics away from the identity, goes to both sides.  The JAX
fused model runs its Pallas kernels in interpret mode, with the kernel
width gate lowered as tests/test_folded.py does.  Forward tolerance:
rtol = atol = 2e-4, the JAX suite's for folded-vs-standard models
(test_folded.py:20).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu.config import preset
from image_segmentation_tpu.engine import export as jax_export
from image_segmentation_tpu.models import blocks as jax_blocks
from image_segmentation_tpu.models.unet import LargeUNet as JaxLargeUNet
from image_segmentation_tpu.models.unet import UNet as JaxUNet
from image_segmentation_tpu.ops.augment import normalize_image as jax_normalize
from image_segmentation_tpu.utils.torch_export import unet_state_dict
from image_segmentation_tpu_torch.engine import export as port_export
from image_segmentation_tpu_torch.models import blocks as port_blocks
from image_segmentation_tpu_torch.models import fused
from image_segmentation_tpu_torch.models.registry import build_model
from image_segmentation_tpu_torch.ops.augment import normalize_image
from image_segmentation_tpu_torch.utils.convert import (
    jax_from_state_dict,
    state_dict_from_jax,
)

jax.config.update("jax_default_matmul_precision", "highest")
TOL = dict(rtol=2e-4, atol=2e-4)
SMALL = dict(stem_features=8, encoder_features=(16, 32, 64, 128))
PRESET = preset("large_unet").model_args
ARGS = {"preset": PRESET, "standard": {}}


def _init_tree(seed: int, cls=JaxLargeUNet, **widths):
    """(params, batch_stats) numpy trees of a small JAX U-Net."""
    shapes = jax.eval_shape(
        lambda: cls(dtype=jnp.float32, **(widths or SMALL)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False
        )
    )
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:  # lecun-normal scale keeps activations O(1)
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "scale" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if "var" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return tree["params"], tree["batch_stats"]


@pytest.fixture(scope="module")
def tree():
    return _init_tree(0)


@pytest.fixture
def small_kernels(monkeypatch):
    # let the JAX Pallas pool / ConvTranspose run at test widths
    monkeypatch.setenv("IMGSEG_PALLAS_MIN_WP", "1")


def _port(params, batch_stats, **model_args):
    m = build_model("large_unet", device="cpu", dtype=torch.float32, **SMALL, **model_args)
    m.load_state_dict(state_dict_from_jax(params, batch_stats), strict=True)
    return m.eval()


def _image(seed, shape=(2, 64, 64, 3)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("config", sorted(ARGS))
def test_forward_matches_jax(tree, small_kernels, config):
    params, stats = tree
    x = _image(1)
    jm = JaxLargeUNet(dtype=jnp.float32, **SMALL, **ARGS[config])
    ref = np.asarray(jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                              train=False))
    with torch.no_grad():
        out = _port(params, stats, **ARGS[config])(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 64, 64, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, **TOL)


def test_unet_preset_matches_jax_standard():
    """The 3-downsample UNet from the ``unet`` preset's args, against the
    JAX standard path of the same tree (the port's kernel levels run their
    plain versions here)."""
    widths = dict(stem_features=8, encoder_features=(16, 32, 64))
    params, stats = _init_tree(7, JaxUNet, **widths)
    x = _image(8, (2, 32, 40, 3))
    ref = np.asarray(JaxUNet(dtype=jnp.float32, **widths).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False))
    m = build_model("unet", device="cpu", dtype=torch.float32, **widths,
                    **preset("unet").model_args)
    m.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_preset_selects_kernel_blocks_at_levels_0_and_1(tree):
    m = _port(*tree, **PRESET)
    fast = {n for n, mod in m.named_children()
            if isinstance(mod, (fused.FusedConvBlockDownsample,
                                fused.FusedConvBlockUpsampleSkip))}
    assert fast == {"enc1", "enc2", "dec4", "dec5"}
    level0_only = _port(*tree, w2d_level0=True, w2d_impl="pallas_fused")
    assert isinstance(level0_only.enc1, fused.FusedConvBlockDownsample)
    assert not isinstance(level0_only.enc2, fused.FusedConvBlockDownsample)
    assert not isinstance(_port(*tree, w2d_level0=True).enc1,
                          fused.FusedConvBlockDownsample)


def test_kernel_and_plain_blocks_agree(tree):
    x = torch.from_numpy(_image(2, (1, 32, 48, 3)))
    with torch.no_grad():
        a = _port(*tree, **PRESET)(x)
        b = _port(*tree)(x)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_state_dict_round_trip(tree):
    params, stats = tree
    p2, s2 = jax_from_state_dict(_port(params, stats).state_dict())
    for a, b in ((params, p2), (stats, s2)):
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
        for la, lb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(la, lb)


def test_state_dict_from_jax_matches_torch_export(tree):
    """The port's converter gives torch_export's reference state dict."""
    ref = unet_state_dict(*tree)
    out = state_dict_from_jax(*tree)
    assert sorted(out) == sorted(ref)
    for k, v in ref.items():
        assert out[k].dtype == torch.from_numpy(v).dtype, k
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)


@pytest.fixture(scope="module")
def jax_artifact(tree, tmp_path_factory):
    """A JAX-written artifact of the preset model, and both loaded models."""
    params, stats = tree
    d = str(tmp_path_factory.mktemp("jax_artifact"))
    jax_export.export_model({"params": params, "batch_stats": stats}, "large_unet",
                            {**SMALL, **PRESET}, out_dir=d)
    jm, jv = jax_export.load_model(d, dtype=jnp.float32)
    pm = port_export.load_model(d, device="cpu", dtype=torch.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMGSEG_PALLAS_MIN_WP", "1")  # the JAX kernels at test widths
        yield jm, jv, pm


@pytest.mark.parametrize("kind", ["u8_256", "u8_upscale", "f32_downscale", "grey"])
def test_jax_artifact_predicts_same_masks(jax_artifact, kind):
    rng = np.random.default_rng(3)
    image = {
        "u8_256": lambda: rng.integers(0, 256, (256, 256, 3), dtype=np.uint8),
        "u8_upscale": lambda: rng.integers(0, 256, (200, 176, 3), dtype=np.uint8),
        "f32_downscale": lambda: rng.uniform(0, 1, (320, 296, 3)).astype(np.float32),
        "grey": lambda: rng.integers(0, 256, (256, 256), dtype=np.uint8),
    }[kind]()
    jm, jv, pm = jax_artifact
    assert not any(p.requires_grad for p in pm.parameters())
    ref = jax_export.predict(jm, jv, image)
    out = port_export.predict(pm, image)
    assert out.shape == (256, 256) and ref.shape == (256, 256)
    np.testing.assert_array_equal(out, ref)


def test_port_artifact_loads_in_jax(tree, tmp_path):
    m = _port(*tree)
    d = port_export.export_model(m, "large_unet", dict(SMALL), out_dir=str(tmp_path))
    jm, jv = jax_export.load_model(d, dtype=jnp.float32)
    x = _image(4)
    ref = np.asarray(jm.apply(jv, jnp.asarray(x), train=False))
    with torch.no_grad():
        out = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("size", [(5, 7), (16, 24), (3, 2)])
def test_resize_align_corners_matches_jax(size):
    x = _image(5, (2, 6, 9, 4))
    ref = jax_blocks.resize_bilinear_align_corners(jnp.asarray(x), *size)
    out = port_blocks.resize_bilinear_align_corners(torch.from_numpy(x), *size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_normalize_image_matches_jax():
    u8 = np.random.default_rng(6).integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        normalize_image(torch.from_numpy(u8)).numpy(), np.asarray(jax_normalize(u8))
    )


def test_unported_models_and_options_raise(tree):
    """An unknown model raises.  ``freeze_clip=False`` and ``fused_deep``,
    refused until they were ported, build and load the JAX tree
    (tests/test_torch_port_options.py holds them to JAX)."""
    from image_segmentation_tpu.models.clip_models import ClipResSegmentationModel

    m = _port(*tree, **PRESET, fused_deep=True)
    assert isinstance(m.enc3, fused.FusedDeepConvBlockDownsample)
    clip_kw = dict(hidden=32, layers=1, heads=2, mlp_dim=64, patch=32, proj_dim=32)
    jm = ClipResSegmentationModel(dtype=jnp.float32, clip_kwargs=clip_kw, freeze_clip=False)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                            train=False))
    sd = state_dict_from_jax(*(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes[k])
                               for k in ("params", "batch_stats")))
    pm = build_model("clip_res", device="cpu", clip_kwargs=clip_kw, freeze_clip=False)
    pm.load_state_dict(sd, strict=True)
    assert all(p.requires_grad for p in pm.clip_feature_extractor.parameters())
    with pytest.raises(KeyError, match="unknown model"):
        build_model("no_such_model", device="cpu")
