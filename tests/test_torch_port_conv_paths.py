"""The path rule of the port's 3x3 conv kernels (``ops/fused_conv.conv_path``)
at every conv shape the smoke run drives and at the vector path's edge, and
the deep and vector paths' weight orders.

``chip_smoke.path_shapes()`` lists the convs of every main path: the
large_unet step, the prompt, autoencoder and clip_res steps, the
``fused_deep`` blocks and the tensor-parallel slices (``tp_path_shapes``).
The rule gives the deep path to the fold-1 convs with 256 or more channels
in or out and to no level 0-1 conv of any model, the narrow path to the
channel counts that are not multiples of 8 (ClipRes's output block, the
prompt heatmap) and to more channels than the vector kernel's resident
weights fit (input channels in the forward, output channels in the
dgrad), the vector path to the rest.  It is a function of the
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
# input channels, padded to 16, number at most 192 (160 where Co <= 16),
# the forward's K, and whose output channels, padded to 16, number at most
# 192 (160 where Ca + Cb <= 16), the dgrad's K
FIT = [
    ((192, 0, 32), "vector"), ((184, 0, 64), "vector"), ((96, 96, 32), "vector"),
    ((160, 0, 16), "vector"), ((152, 0, 8), "vector"), ((8, 0, 8), "vector"),
    ((200, 0, 64), "narrow"), ((208, 0, 32), "narrow"), ((104, 104, 32), "narrow"),
    ((256, 0, 32), "narrow"), ((120, 120, 120), "narrow"), ((176, 0, 16), "narrow"),
    ((168, 0, 8), "narrow"), ((192, 0, 16), "narrow"), ((256, 0, 256), "deep"),
    # the dgrad's edge: its K is Co, its N is Cin
    ((96, 0, 192), "vector"), ((96, 0, 208), "narrow"), ((96, 0, 184), "vector"),
    ((32, 32, 192), "vector"), ((32, 32, 200), "narrow"), ((24, 0, 192), "vector"),
    ((16, 0, 160), "vector"), ((16, 0, 176), "narrow"), ((8, 0, 160), "vector"),
    ((8, 0, 168), "narrow"), ((8, 8, 176), "narrow"), ((192, 0, 192), "vector"),
    ((192, 0, 208), "narrow"),
]


@pytest.mark.parametrize("channels,path", FIT, ids=[f"{c}-{p}" for c, p in FIT])
def test_conv_path_sends_what_the_vector_weights_do_not_fit_to_the_narrow_path(channels, path):
    assert fused_conv.conv_path(*channels) == path


def _asserted_limits(rows: str):
    """The K limits that ``csrc/conv3x3.cu`` asserts its vector kernel's
    shared memory holds with ``rows`` transform rows: (fits, the next that
    does not) at an N tile of 32 on 64-pixel strips and of 16 on 128."""
    src = (Path(fused_conv.__file__).resolve().parents[1] / "csrc" / "conv3x3.cu").read_text()
    found = []
    for sw, n in ((64, 32), (128, 16)):
        m = re.search(rf"fvec_bytes\({sw}, (\d+), {n}, FXR_MIN, {rows}\) <= FSMEM &&\s+"
                      rf"fvec_bytes\({sw}, (\d+), {n}, FXR_MIN, {rows}\) > FSMEM", src)
        assert m, (sw, n, rows)
        found.append((int(m[1]), int(m[2])))
    return found


def test_the_vector_limits_are_the_kernels():
    """``conv_path``'s VECTOR_CIN and VECTOR_CIN_N16 are the limits that
    ``csrc/conv3x3.cu`` asserts its forward's shared memory holds."""
    fits, fits16 = _asserted_limits("FROWS_FWD")
    assert fits == (fused_conv.VECTOR_CIN, fused_conv.VECTOR_CIN + 16)
    assert fits16 == (fused_conv.VECTOR_CIN_N16, fused_conv.VECTOR_CIN_N16 + 16)


def test_the_dgrad_limits_are_the_kernels():
    """``conv_path``'s VECTOR_DGRAD_CO and VECTOR_DGRAD_CO_N16 are the
    limits that ``csrc/conv3x3.cu`` asserts its dgrad's shared memory holds
    (with the cotangent transform's four rows)."""
    fits, fits16 = _asserted_limits("FROWS_DGRAD")
    assert fits == (fused_conv.VECTOR_DGRAD_CO, fused_conv.VECTOR_DGRAD_CO + 16)
    assert fits16 == (fused_conv.VECTOR_DGRAD_CO_N16, fused_conv.VECTOR_DGRAD_CO_N16 + 16)


@pytest.mark.parametrize("k,n", [(16, 8), (32, 64), (64, 128), (24, 40), (40, 48)])
def test_vector_pack_for_the_dgrad_is_the_flipped_transposed_kernel(k, n):
    """``vector_pack(w, dgrad=True)`` of a conv's w (Co = k, Cin = n) packs
    the dgrad's weights: the kernel flipped in both taps and transposed,
    N = Cin, K = Co padded to 16."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((k, n, 3, 3)).astype(np.float32))
    packed = fused_conv.vector_pack(w, dgrad=True)
    assert torch.equal(packed, fused_conv.vector_pack(w.flip(2, 3).transpose(0, 1).contiguous()))


@pytest.mark.parametrize("cin,co", [(8, 16), (24, 40), (16, 8)])
def test_the_packed_dgrad_weights_read_as_the_kernel_reads_them(cin, co):
    """The vector kernel's product for output pixel p, N channel n: the sum
    over taps t = 3ky + kx and K channels k of the operand at p + (ky - 1,
    kx - 1), channel k, times packed[t][n/8][k/8][n%8][k%8].  With the
    dgrad's packing and the raw cotangent as the operand (zero outside the
    image) that is the plain dgrad."""
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.standard_normal((2, 5, 7, co)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((co, cin, 3, 3)).astype(np.float32))
    packed = fused_conv.vector_pack(w, dgrad=True).float()
    kp = packed.shape[2] * 8
    wt = packed.permute(1, 3, 2, 4, 0).reshape(cin, kp, 3, 3)[:, :co]  # [n, k, ky, kx]
    gp = torch.nn.functional.pad(g.float(), (0, 0, 1, 1, 1, 1))
    dx = torch.zeros(2, 5, 7, cin)
    for ky in range(3):
        for kx in range(3):
            dx += gp[:, ky:ky + 5, kx:kx + 7] @ wt[:, :, ky, kx].T
    ref = fused_conv.conv3x3_dgrad_plain(g, None, w, None, None)
    assert torch.allclose(dx.to(torch.bfloat16).float(), ref.float(), rtol=1e-2, atol=1e-2)


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
