"""The trees and artifacts of the port's last models (the ClipRes models,
ClipAutoencoder and ``prompt_fusion`` in utils/convert.py, ``export_model``
/ ``load_model`` / ``predict`` in engine/export.py) against the JAX
package on the CPU, in fp32.

Parameter trees are drawn from a numpy seed in the shapes the JAX modules
declare (tests/test_torch_port_clip.py ``random_tree``), with the small
CLIP tower of tests/test_torch_port_clip.py.

Tolerances, each with its reason:

- the converters: bit for bit (a permutation and a transpose of fp32
  values);
- ``predict``: the class-id masks equal wherever JAX's two largest logits
  lie more than 1e-4 apart (the output ReLU leaves ties at 0, which both
  argmaxes break alike, and a logit within rounding of 0 may fall on
  either side of it).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu.engine import export as jax_export
from image_segmentation_tpu.models import clip_models as jax_models
from image_segmentation_tpu.models import prompt_fusion as jax_prompt_fusion
from image_segmentation_tpu.utils import torch_export
from image_segmentation_tpu_torch.engine import export
from image_segmentation_tpu_torch.engine.train import init_weights_
from image_segmentation_tpu_torch.models.registry import build_model
from image_segmentation_tpu_torch.utils.convert import jax_from_state_dict, state_dict_from_jax
from tests.test_torch_port_clip import CLIP_KW, jax_variables

jax.config.update("jax_default_matmul_precision", "highest")
PREDICT_MARGIN = 1e-4


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


# ---- the converters ---------------------------------------------------------

CONVERT = {
    "clip_res": lambda kw: jax_models.ClipResSegmentationModel(dtype=jnp.float32, clip_kwargs=kw),
    "clip_autoencoder": lambda kw: jax_models.ClipAutoencoder(dtype=jnp.float32, clip_kwargs=kw),
    "clip_res_class": lambda kw: jax_models.ClipResSegmentationClassification(
        dtype=jnp.float32, clip_kwargs=kw),
    "prompt_fusion": lambda kw: jax_prompt_fusion.SegmentationModelWithPrompt(dtype=jnp.float32),
}


@pytest.mark.parametrize("name", sorted(CONVERT))
def test_converters_round_trip(name):
    """state_dict_from_jax loads strictly into the port's model, and
    jax_from_state_dict gives the JAX tree back, bit for bit; the
    clip_res and clip_autoencoder dicts are the JAX exporter's (the
    reference layout; it packs q/k/v and needs proj_dim 512)."""
    kw = dict(CLIP_KW, proj_dim=512)
    inputs = [jnp.zeros((1, 32, 32, 3))] + ([jnp.zeros((1, 32, 32, 1))] * (name == "prompt_fusion"))
    variables = jax_variables(CONVERT[name](kw), *inputs, seed=8)
    params, stats = variables["params"], variables["batch_stats"]
    sd = state_dict_from_jax(params, stats)
    exporter = torch_export.EXPORTERS.get(name)
    if exporter is not None:
        ref = exporter(params, stats)
        assert sorted(sd) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(sd[k].numpy(), ref[k], err_msg=k)
    if name == "clip_res_class":  # the clip_res keys, mask_out and class_head in place of out
        res = state_dict_from_jax(*[
            jax_variables(CONVERT["clip_res"](kw), *inputs)[c] for c in ("params", "batch_stats")])
        heads = {"mask_out.weight", "mask_out.bias", "class_head.weight", "class_head.bias"}
        assert set(sd) == {k for k in res if not k.startswith("out.")} | heads
    args = {} if name == "prompt_fusion" else dict(clip_kwargs=kw)
    pm = build_model(name, device="cpu", dtype=torch.float32, **args)
    pm.load_state_dict(sd, strict=True)
    p2, s2 = jax_from_state_dict(pm.state_dict())
    for got, want in ((p2, params), (s2, stats)):
        g, w = _flat(got), _flat(want)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---- artifacts and predict --------------------------------------------------

def test_clip_res_artifact_predict_matches_jax(tmp_path):
    """``export_model`` -> ``load_model`` -> ``predict`` on the CPU equals
    JAX's ``load_model`` -> ``predict`` on the same artifact (a 200x300
    uint8 request, resized to 256x256 on both sides)."""
    args = dict(clip_kwargs=CLIP_KW)
    pm = build_model("clip_res", device="cpu", dtype=torch.float32, **args)
    jm0 = jax_models.ClipResSegmentationModel(dtype=jnp.float32, clip_kwargs=CLIP_KW)
    variables = jax_variables(jm0, jnp.zeros((1, 64, 64, 3)), seed=9)
    pm.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]))
    art = export.export_model(pm, "clip_res", args, out_dir=str(tmp_path / "art"))
    assert json.load(open(tmp_path / "art" / "config.json"))["model"] == "clip_res"
    served = export.load_model(art, device="cpu", dtype=torch.float32)
    image = np.random.default_rng(4).integers(0, 256, (200, 300, 3), dtype=np.uint8)
    got = export.predict(served, image)
    jm, jv = jax_export.load_model(art, dtype=jnp.float32)
    ref = jax_export.predict(jm, jv, image)
    x = jax.image.resize(jnp.asarray(image, jnp.float32)[None] / 255.0, (1, 256, 256, 3),
                         method="bilinear")
    top2 = np.sort(np.asarray(jm.apply(jv, x, train=False))[0], axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > PREDICT_MARGIN
    assert got.shape == ref.shape == (256, 256) and clear.mean() > 0.5
    np.testing.assert_array_equal(got[clear], ref[clear])


@pytest.mark.parametrize("name", ["clip_unet_prompt", "clip_res_class", "prompt_fusion"])
def test_predict_refuses_what_jax_cannot_serve(name, tmp_path):
    """Their artifacts round-trip; ``predict`` raises a TypeError naming
    why (a second input, or two outputs)."""
    args = {} if name == "prompt_fusion" else dict(clip_kwargs=CLIP_KW)
    pm = build_model(name, device="cpu", dtype=torch.float32, **args)
    init_weights_(pm, torch.Generator().manual_seed(0))  # the fusion's q/k zero, as JAX's
    art = export.export_model(pm, name, args, out_dir=str(tmp_path / name))
    served = export.load_model(art, device="cpu", dtype=torch.float32)
    for (k, a), b in zip(pm.state_dict().items(), served.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(TypeError, match="second input|two outputs|not class logits"):
        export.predict(served, np.zeros((32, 32, 3), np.float32))


def test_the_port_builds_every_jax_registry_name():
    """The JAX registry, with its lazy CLIP and prompt_fusion names (this
    module imports both), is the port's."""
    from image_segmentation_tpu.models import registry as jax_registry
    from image_segmentation_tpu_torch.models.registry import MODEL_NAMES

    assert sorted(MODEL_NAMES) == sorted(jax_registry._REGISTRY) and len(MODEL_NAMES) == 9
    for name in MODEL_NAMES:
        args = dict(clip_kwargs=CLIP_KW) if name.startswith("clip") else {}
        assert isinstance(build_model(name, device="cpu", **args), torch.nn.Module), name
