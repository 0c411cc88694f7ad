"""The port's counterparts of the last two scripts, against them, on the
CPU: ``cli.convert_pretrained`` against ``scripts/convert_pretrained.py``
and ``cli.check_prompt_data`` against ``scripts/test_prompt_data.py``.

The converter's sources, random weights from a seed: a small
``CLIPVisionModelWithProjection`` (hidden 64, 2 layers, 224x224 images in
32x32 patches, the port tower's grid), the same weights inside a whole
``CLIPModel`` state dict, tests/test_resnet.py's ``TorchResNet34Features``
(torchvision's key layout, random running statistics), and the CLIP file
again under ``torch.compile``'s ``_orig_mod.`` prefix.  Both converters
read the same file.

Tolerances, each with its reason:

- the two ``.npz``: equal array for array (keys, dtypes, values), since
  both only move fp32 values;
- the towers loaded from the ``.npz`` against the torch source models:
  rtol = atol = 1e-5, fp32 on both sides in another op order;
- the port's towers saved in the source layouts, converted and loaded
  back: bit for bit;
- the prompt check: its printed lines equal the script's, for JAX's
  points.
"""

import contextlib
import io
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu.data import prompts as jax_prompts
from image_segmentation_tpu.data.datasets import synthetic_dataset as jax_synthetic
from image_segmentation_tpu_torch.cli import check_prompt_data, convert_pretrained
from image_segmentation_tpu_torch.models.clip import ClipVisionTower
from image_segmentation_tpu_torch.models.resnet import ResNet34Features
from image_segmentation_tpu_torch.utils import checkpoint
from image_segmentation_tpu_torch.utils.convert import (
    CLIP,
    read_flat_npz,
    state_dict_from_jax,
    torchvision_resnet34_keys,
)
from tests.test_resnet import TorchResNet34Features

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
TOL = dict(rtol=1e-5, atol=1e-5)
CLIP_CONFIG = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, image_size=224, patch_size=32, projection_dim=48,
                   hidden_act="quick_gelu")
PORT_TOWER = dict(hidden=64, layers=2, heads=4, mlp_dim=128, patch=32, proj_dim=48)
TOWER = {"clip_vision": "clip", "clip_model": "clip", "resnet34": "resnet34",
         "clip_compiled": "clip"}


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """{name: (path of the state dict, torch model computing the tower's
    output from NCHW pixels)}."""
    from transformers import CLIPConfig, CLIPModel, CLIPVisionConfig, CLIPVisionModelWithProjection

    root = tmp_path_factory.mktemp("sources")
    torch.manual_seed(0)
    vision = CLIPVisionModelWithProjection(CLIPVisionConfig(**CLIP_CONFIG)).eval()
    full = CLIPModel(CLIPConfig(
        text_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                         num_attention_heads=2, vocab_size=100, max_position_embeddings=16),
        vision_config=CLIP_CONFIG, projection_dim=48)).eval()
    full.vision_model.load_state_dict(vision.vision_model.state_dict())
    full.visual_projection.load_state_dict(vision.visual_projection.state_dict())
    resnet = TorchResNet34Features().eval()
    with torch.no_grad():
        for m in resnet.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    dicts = {
        "clip_vision": (vision.state_dict(), lambda x: vision(pixel_values=x).image_embeds),
        "clip_model": (full.state_dict(), lambda x: full.get_image_features(pixel_values=x)),
        "resnet34": (resnet.state_dict(), resnet),
        "clip_compiled": ({f"_orig_mod.{k}": v for k, v in vision.state_dict().items()},
                          lambda x: vision(pixel_values=x).image_embeds),
    }
    out = {}
    for name, (sd, fn) in dicts.items():
        path = str(root / f"{name}.pt")
        torch.save(sd, path)
        out[name] = (path, fn)
    return out


def _run_jax_script(module: str, argv: list) -> str:
    """Run ``scripts/<module>.py`` as ``__main__`` with ``argv``; its stdout."""
    old, buf = sys.argv, io.StringIO()
    sys.argv = [module, *argv]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(SCRIPTS, f"{module}.py"), run_name="__main__")
    finally:
        sys.argv = old
    return buf.getvalue()


@pytest.fixture(scope="module")
def converted(sources, tmp_path_factory):
    """{name: (the port's .npz, JAX's .npz, the port's printed line, JAX's)}."""
    root = tmp_path_factory.mktemp("converted")
    out = {}
    for name, (path, _) in sources.items():
        mine, theirs = str(root / f"{name}_port.npz"), str(root / f"{name}_jax.npz")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            convert_pretrained.main([TOWER[name], "--torch-state-dict", path, "--out", mine])
        line = _run_jax_script("convert_pretrained",
                               [TOWER[name], "--torch-state-dict", path, "--out", theirs])
        out[name] = (mine, theirs, buf.getvalue(), line)
    return out


@pytest.mark.parametrize("name", list(TOWER))
def test_the_npz_equals_the_scripts_array_for_array(converted, name):
    mine, theirs, _, _ = converted[name]
    got, want = checkpoint.load_checkpoint_flat(mine), checkpoint.load_checkpoint_flat(theirs)
    assert sorted(got) == sorted(want) and want
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k
    if TOWER[name] == "resnet34":
        assert any(k.startswith("batch_stats/layer4_2/") for k in got)
        assert "params/layer2_0/downsample_conv/kernel" in got
    else:
        assert "params/layer_1/self_attn/q_proj/kernel" in got
        assert not any(k.startswith("text") or "position_ids" in k for k in got)


@pytest.mark.parametrize("name", list(TOWER))
def test_the_summary_line_is_the_scripts(converted, name):
    mine, theirs, line, jax_line = converted[name]
    assert line == jax_line.replace(theirs, mine)
    assert line.startswith(f"{TOWER[name]}: ") and line.rstrip().endswith(mine)


def _port_tower(kind: str, npz: str):
    """The port's fp32 tower holding the converted ``.npz``."""
    tree = read_flat_npz(npz)
    if kind == "clip":
        sd = state_dict_from_jax({"clip_tower": tree["params"]}, {})
        tower = ClipVisionTower(dtype=torch.float32, **PORT_TOWER)
        tower.load_state_dict({k[len(CLIP):]: v for k, v in sd.items()}, strict=True)
        return tower
    sd = state_dict_from_jax({"resnet_backbone": tree["params"]},
                             {"resnet_backbone": tree["batch_stats"]})
    resnet = ResNet34Features(dtype=torch.float32)
    resnet.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()}, strict=True)
    return resnet


@pytest.mark.parametrize("name", list(TOWER))
def test_the_loaded_tower_gives_the_sources_output(sources, converted, name):
    kind = TOWER[name]
    tower = _port_tower(kind, converted[name][0])
    size = 224 if kind == "clip" else 64
    x = torch.randn(2, 3, size, size, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = sources[name][1](x)
        got = tower(x.permute(0, 2, 3, 1))
    if kind == "resnet34":
        got = got.permute(0, 3, 1, 2)
        assert got.shape == (2, 512, 2, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_the_ports_towers_round_trip_bit_for_bit(tmp_path):
    """The port's towers saved in the sources' layouts (the CLIP tower's own
    keys are transformers', the ResNet's made torchvision's), converted and
    loaded back: every tensor equal, as the converter phase on the card
    checks at full width; torchvision's layout loads into the torch
    fixture."""
    gen = torch.Generator().manual_seed(3)
    clip = ClipVisionTower(dtype=torch.float32, **PORT_TOWER)
    resnet = ResNet34Features(dtype=torch.float32)
    for module in (clip, resnet):
        with torch.no_grad():
            for t in module.state_dict().values():
                if t.is_floating_point():
                    t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    sources = {"clip": clip.state_dict(), "resnet34": torchvision_resnet34_keys(resnet.state_dict())}
    TorchResNet34Features().load_state_dict(sources["resnet34"], strict=True)
    for kind, sd in sources.items():
        src, npz = str(tmp_path / f"{kind}.pt"), str(tmp_path / f"{kind}.npz")
        torch.save(sd, src)
        with contextlib.redirect_stdout(io.StringIO()):
            convert_pretrained.main([kind, "--torch-state-dict", src, "--out", npz])
        back = _port_tower(kind, npz).state_dict()
        want = clip.state_dict() if kind == "clip" else resnet.state_dict()
        assert sorted(back) == sorted(want)
        for k, v in want.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(back[k], v), k


def test_convert_pretrained_runs_as_a_module(sources, tmp_path):
    out = str(tmp_path / "r.npz")
    res = subprocess.run(
        [sys.executable, "-m", "image_segmentation_tpu_torch.cli.convert_pretrained",
         "resnet34", "--torch-state-dict", sources["resnet34"][0], "--out", out],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout == "resnet34: 21,301,696 parameters -> " + out + "\n"
    assert os.path.exists(out)


# ---- check_prompt_data ------------------------------------------------------

def jax_points(raw: np.ndarray, key) -> list:
    """``[choice, cy, cx]`` (lists) of JAX's ``make_prompt_batch(key, raw)``,
    drawn from its key as it draws them (prompts.py:49-62)."""
    kc, kp = jax.random.split(key)
    cat, dog, bg = jax_prompts.palette_to_class_masks(jnp.asarray(raw))
    masks = jnp.stack([cat, dog, bg], axis=1)
    logits = jnp.log(jnp.clip(jnp.sum(masks, axis=(2, 3)), 1e-9, None))
    choice = jax.random.categorical(kc, logits, axis=-1)
    sel = jnp.take_along_axis(masks, choice[:, None, None, None], axis=1)[:, 0]
    u = jax.random.uniform(kp, sel.shape)
    idx = np.asarray(jnp.argmax(jnp.where(sel > 0, u, -1.0).reshape(raw.shape[0], -1), -1))
    w = raw.shape[2]
    return [np.asarray(choice).tolist(), (idx // w).tolist(), (idx % w).tolist()]


def test_check_prompt_data_prints_the_scripts_lines_for_jaxs_points(tmp_path):
    ds = jax_synthetic(length=4, keep_raw_masks=True)
    out = str(tmp_path / "prompt_check.png")
    want = _run_jax_script("test_prompt_data", ["--out", out]).splitlines()
    os.remove(out)
    points = [torch.tensor(p) for p in jax_points(ds.raw_masks[:4], jax.random.PRNGKey(0))]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = check_prompt_data.check(ds.images[:4], torch.from_numpy(ds.raw_masks[:4]),
                                      *points, 10.0, out)
    assert buf.getvalue().splitlines() == got["lines"] == want
    assert len(want) == 6 and all("label at peak = 1.0 (must be 1.0)" in x for x in want[1:5])
    assert os.path.getsize(out) > 0
    assert got["heat"].shape == got["label"].shape == (4, 256, 256)


def test_check_prompt_data_main_on_the_cpu(tmp_path):
    out = str(tmp_path / "grid.png")
    with contextlib.redirect_stdout(io.StringIO()):
        first = check_prompt_data.main(["--device", "cpu", "--seed", "3", "--out", out])
        again = check_prompt_data.main(["--device", "cpu", "--seed", "3", "--no-plot"])
        other = check_prompt_data.main(["--device", "cpu", "--seed", "4", "--no-plot"])
    assert os.path.getsize(out) > 0 and first["lines"][-1] == f"saved {out}"
    assert first["lines"][:5] == again["lines"] and len(again["lines"]) == 5
    assert np.array_equal(first["heat"], again["heat"])
    assert not np.array_equal(first["heat"], other["heat"])
    assert float(first["heat"].max()) == 1.0
