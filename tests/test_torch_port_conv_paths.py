"""The path rule of the port's 3x3 conv kernels (``ops/fused_conv.conv_path``)
at every conv shape the smoke run drives, and the deep path's weight order.

``chip_smoke.path_shapes()`` lists the convs of every main path: the
large_unet step, the prompt, autoencoder and clip_res steps, the
``fused_deep`` blocks and the tensor-parallel slices (``tp_path_shapes``).
The rule gives the deep path to the fold-1 convs with 256 or more channels
in or out and to no level 0-1 conv of any model, the narrow path to the
channel counts that are not multiples of 8 (ClipRes's output block, the
prompt heatmap), the vector path to the rest.  It is a function of the
channel counts alone, so it is checked here on the CPU; the card tests
(``test_torch_port_cuda.py``) check that the kernels take it.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from image_segmentation_tpu_torch.ops import fused_conv

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# the fold-1 convs the deep path takes: large_unet's (batch 16, 512x512)
# but dec3.conv2 (128 -> 128, the width of a level-1 conv), and the
# tensor-parallel unet's Co/2 slices but enc3.conv1 (128 -> 128) and
# dec2.conv2 (128 -> 64)
DEEP = {f"fused_deep {b}.{c}" for b in ("enc3", "enc4", "dec2") for c in ("conv1", "conv2")}
DEEP |= {"fused_deep dec3.conv1"}
DEEP |= {f"tp unet fused_deep {b}.{c}" for b in ("bottleneck", "dec1") for c in ("conv1", "conv2")}
DEEP |= {"tp unet fused_deep enc3.conv2", "tp unet fused_deep dec2.conv1"}

CONVS = [conv for shapes, _ in smoke.path_shapes() for conv in shapes["conv"]]


def _expected(label: str) -> str:
    if label in DEEP:
        return "deep"
    return "narrow" if label.startswith(smoke.NARROW_LABELS) else "vector"


@pytest.mark.parametrize("conv", CONVS, ids=[f"{i}-{c.label}" for i, c in enumerate(CONVS)])
def test_conv_path_at_every_smoke_conv(conv):
    assert fused_conv.conv_path(conv.shape[-1], conv.cb, conv.co) == _expected(conv.label)


def test_the_rule_names_every_deep_conv():
    """Each label the rule should send to the deep path is a smoke conv: 7
    of large_unet's 8 fold-1 convs, 6 of the tensor-parallel unet's 8."""
    labels = {c.label for c in CONVS}
    assert DEEP <= labels
    assert len([c for c in CONVS if c.label.startswith("fused_deep")]) == 8
    assert len([c for c in CONVS if c.label.startswith("tp unet fused_deep")]) == 8
    assert len(DEEP) == 13


def test_no_level01_conv_takes_the_deep_path():
    """Every conv of levels 0-1 of every model has at most 128 channels in
    and out; none of them takes the deep path."""
    for conv in CONVS:
        if "fused_deep" not in conv.label:
            assert conv.shape[-1] + conv.cb <= 128 and conv.co <= 128, conv
            assert fused_conv.conv_path(conv.shape[-1], conv.cb, conv.co) != "deep", conv


@pytest.mark.parametrize("k,n,tile", [(64, 64, 64), (128, 256, 128), (192, 128, 64), (256, 512, 128)])
def test_deep_pack_is_the_wgmma_core_matrix_order(k, n, tile):
    """``deep_pack`` puts w[ky, kx, c*64 + kk*8 + k8, j*tile + g*8 + n8] at
    [j, c, 3ky + kx, g, kk, n8, k8]: per (N tile, K stage, tap) an (n x 64)
    tile of 8 x 8 core matrices, 8 N rows of 8 K elements each."""
    rng = np.random.default_rng(0)
    wk = torch.from_numpy(rng.standard_normal((3, 3, k, n)).astype(np.float32))
    packed = fused_conv.deep_pack(wk, tile)
    assert packed.shape == (n // tile, k // 64, 9, tile // 8, 8, 8, 8)
    assert packed.is_contiguous()
    for j, c, tap, g, kk, n8, k8 in ((0, 0, 0, 0, 0, 0, 0), (n // tile - 1, k // 64 - 1, 8, tile // 8 - 1, 7, 7, 7),
                                     (0, k // 64 - 1, 4, 1, 3, 5, 2)):
        want = wk[tap // 3, tap % 3, c * 64 + kk * 8 + k8, j * tile + g * 8 + n8]
        assert packed[j, c, tap, g, kk, n8, k8] == want
    # and every element once: the inverse permutation gives wk back
    back = packed.permute(2, 1, 4, 6, 0, 3, 5).reshape(3, 3, k, n)
    assert torch.equal(back, wk)
