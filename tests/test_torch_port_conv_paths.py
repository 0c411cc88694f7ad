"""The path rule of the port's 3x3 conv kernels (``ops/fused_conv.conv_path``)
at every conv shape the smoke run drives and at the vector path's edge, and
the deep and vector paths' weight orders.

``chip_smoke.path_shapes()`` lists the convs of every main path: the
large_unet step, the prompt, autoencoder and clip_res steps, the
``fused_deep`` blocks and the tensor-parallel slices (``tp_path_shapes``).
The rule gives the deep path to the fold-1 convs with 256 or more channels
in or out and to no level 0-1 conv of any model, the narrow path to the
channel counts that are not multiples of 8 (ClipRes's output block, the
prompt heatmap) and to more input channels than the vector forward's
resident weights fit, the vector path to the rest.  It is a function of the
channel counts alone (the operands' alignment aside, ``_path_arg``), so it
is checked here on the CPU; the card tests (``test_torch_port_cuda.py``)
check that the kernels take it.
"""

import importlib.util
import re
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


@pytest.mark.parametrize("k,n", [(32, 64), (64, 128), (128, 128), (8, 16), (24, 40), (40, 48)])
def test_vector_pack_is_the_wgmma_core_matrix_order(k, n):
    """``vector_pack`` puts w[nb*8 + n8, kb*8 + k8, ky, kx] at [3ky + kx, nb,
    kb, n8, k8], in bf16: per tap an (n x kp) matrix of 8 x 8 core
    matrices, 8 N rows of 8 K elements each, K zero-padded to kp, a
    multiple of 16."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((n, k, 3, 3)).astype(np.float32))
    packed = fused_conv.vector_pack(w)
    kp = -(-k // 16) * 16
    assert packed.shape == (9, n // 8, kp // 8, 8, 8)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    wb = w.to(torch.bfloat16)
    for tap, nb, kb, n8, k8 in ((0, 0, 0, 0, 0), (8, n // 8 - 1, k // 8 - 1, 7, 7), (4, n // 16, k // 16, 5, 2)):
        assert packed[tap, nb, kb, n8, k8] == wb[nb * 8 + n8, kb * 8 + k8, tap // 3, tap % 3]
    # K past k is zero, and the rest is w, every element once
    back = packed.permute(1, 3, 2, 4, 0).reshape(n, kp, 3, 3)
    assert torch.equal(back[:, :k], wb)
    assert not back[:, k:].any()


# [Ca | Cb] -> Co on the vector path's edge: it takes multiples of 8 whose
# input channels, padded to 16, number at most 192 (160 where Co <= 16)
FIT = [
    ((192, 0, 32), "vector"), ((184, 0, 64), "vector"), ((96, 96, 32), "vector"),
    ((160, 0, 16), "vector"), ((152, 0, 8), "vector"), ((8, 0, 8), "vector"),
    ((200, 0, 64), "narrow"), ((208, 0, 32), "narrow"), ((104, 104, 32), "narrow"),
    ((256, 0, 32), "narrow"), ((120, 120, 120), "narrow"), ((176, 0, 16), "narrow"),
    ((168, 0, 8), "narrow"), ((192, 0, 16), "narrow"), ((256, 0, 256), "deep"),
]


@pytest.mark.parametrize("channels,path", FIT, ids=[f"{c}-{p}" for c, p in FIT])
def test_conv_path_sends_what_the_vector_weights_do_not_fit_to_the_narrow_path(channels, path):
    assert fused_conv.conv_path(*channels) == path


def test_the_vector_limits_are_the_kernels():
    """``conv_path``'s VECTOR_CIN and VECTOR_CIN_N16 are the limits that
    ``csrc/conv3x3.cu`` asserts its forward's shared memory holds."""
    src = (Path(fused_conv.__file__).resolve().parents[1] / "csrc" / "conv3x3.cu").read_text()
    fits = re.search(r"fvec_bytes\(64, (\d+), 32, FXR_MIN\) <= FSMEM && fvec_bytes\(64, (\d+), 32", src)
    fits16 = re.search(r"fvec_bytes\(128, (\d+), 16, FXR_MIN\) <= FSMEM && fvec_bytes\(128, (\d+), 16", src)
    assert fits and fits16
    assert (int(fits[1]), int(fits[2])) == (fused_conv.VECTOR_CIN, fused_conv.VECTOR_CIN + 16)
    assert (int(fits16[1]), int(fits16[2])) == (fused_conv.VECTOR_CIN_N16, fused_conv.VECTOR_CIN_N16 + 16)


@pytest.mark.parametrize("channels,n,aligned,want", [
    ((64, 0, 64), 64, True, ("vector", 1)),
    ((64, 0, 64), 64, False, ("narrow", 0)),
    ((16, 3, 3), 3, True, ("narrow", 0)),
    ((256, 0, 256), 256, False, ("deep", 128)),
    ((256, 0, 64), 64, True, ("deep", 64)),
])
def test_path_arg_names_the_path_and_reads_the_alignment(channels, n, aligned, want):
    """The library's path argument: the vector path's shapes take the
    narrow path on an operand off 16 bytes, the deep path's do not (the
    library refuses them)."""
    buf = torch.zeros(64, dtype=torch.bfloat16)
    operand = buf[8:] if aligned else buf[1:]
    assert (operand.data_ptr() % 16 == 0) == aligned
    assert fused_conv._path_arg(*channels, n, operand, None) == want
