"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present.  On a machine
with a card (and without jax, which the repo's root conftest.py imports)
run them with

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Inputs are bf16; the plain versions compute in fp32 (TF32 off) from the same
bf16 operands and round to bf16, so the two differ only by the order of the
fp32 sums and the bf16 rounding it can flip: tolerance 1e-2 of the output's
largest magnitude.  fp32 outputs (batch statistics, gradient sums) differ
only by the order of their sums: tolerance 1e-4 of the largest magnitude.
"""

import contextlib
from unittest import mock

import pytest
import torch

from image_segmentation_tpu_torch.ops import fused_conv as fc

pytestmark = pytest.mark.cuda
RTOL = 1e-2
SUM_RTOL = 1e-4
# a stats forward's outputs one bf16 step off the plain version's: at most
# this share of them, and above and below it in balance within this many
# standard deviations (_close_stats_to_own_outputs)
FLIP_SHARE = 1e-2
FLIP_SIGMAS = 4
# train steps, kernel path vs plain path (as chip_smoke.py holds them): loss
# within LOSS_RTOL, each weight gradient within GRAD_RL2 relative L2, or,
# where bf16 rounding dominates the leaf (the plain bf16 gradient itself
# more than GRAD_RL2 from the fp32 step's), no further from the fp32
# gradient than BF16_NOISE_FACTOR times the plain bf16 path
LOSS_RTOL = 2e-2
GRAD_RL2 = 5e-2
BF16_NOISE_FACTOR = 1.5


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _close(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == torch.bfloat16
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= RTOL * ref.float().abs().max().item(), err


def _close_all(got, ref):
    """Tuples of outputs: bf16 ones as _close, fp32 sums at SUM_RTOL."""
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if b.dtype == torch.bfloat16:
            _close(a, b)
        else:
            assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
            err = (a - b).abs().max().item()
            assert err <= SUM_RTOL * b.abs().max().item(), err


def _counted(wrapper, fn):
    before = wrapper.launches
    out = fn()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    return out


def _close_weight_grads(got: dict, ref: dict, ref32: dict) -> None:
    """Weight gradients of the kernel path ``got`` against the plain path
    ``ref`` (bf16) and ``ref32`` (the plain path in fp32); see GRAD_RL2."""
    for k, r in ref.items():
        if not k.endswith("weight") or (got[k] - r).norm() <= GRAD_RL2 * r.norm():
            continue
        scale = ref32[k].norm()
        p32, k32 = (r - ref32[k]).norm() / scale, (got[k] - ref32[k]).norm() / scale
        assert p32 > GRAD_RL2 and k32 <= BF16_NOISE_FACTOR * p32, (k, p32.item(), k32.item())


def _plain_wrappers(stack, *mods):
    for mod in mods:
        for w in mod.WRAPPERS:
            stack.enter_context(mock.patch.object(mod, w.__name__, getattr(mod, w.__name__ + "_plain")))


# (plain versions, compute dtype) of the kernel path, the plain path and the
# plain path's fp32 reference step
PATHS = ((False, torch.bfloat16), (True, torch.bfloat16), (True, torch.float32))


# odd sizes and channel counts exercise every tile edge
@pytest.mark.parametrize("shape,cb,co,pre", [
    ((2, 19, 37, 8), 0, 16, False),
    ((2, 19, 37, 24), 0, 40, True),
    ((1, 16, 32, 16), 16, 16, False),
    ((1, 9, 5, 3), 5, 7, False),
])
def test_conv3x3(gen, shape, cb, co, pre):
    ca = shape[-1]
    x = _randn(gen, *shape)
    xb = _randn(gen, *shape[:3], cb) if cb else None
    w = _randn(gen, co, ca + cb, 3, 3, dtype=torch.float32) * 0.2
    bias = _randn(gen, co, dtype=torch.float32)
    ab = dict(a=torch.rand(ca, generator=gen, device="cuda") + 0.5,
              b=_randn(gen, ca, dtype=torch.float32) * 0.5) if pre else {}
    got = _counted(fc.conv3x3, lambda: fc.conv3x3(x, w, bias, x_b=xb, **ab))
    _close(got, fc.conv3x3_plain(x, w, bias, x_b=xb, **ab))


@pytest.mark.parametrize("shape", [(2, 16, 32, 64), (1, 7, 9, 5)])
def test_maxpool2x2_affine_relu(gen, shape):
    z = _randn(gen, *shape)
    a = torch.rand(shape[-1], generator=gen, device="cuda") + 0.5
    b = _randn(gen, shape[-1], dtype=torch.float32) * 0.5
    got = _counted(fc.maxpool2x2_affine_relu, lambda: fc.maxpool2x2_affine_relu(z, a, b))
    ref = fc.maxpool2x2_affine_relu_plain(z, a, b)
    assert torch.equal(got, ref)  # a max of identical fp32 values: exact


@pytest.mark.parametrize("shape,co", [((2, 8, 16, 64), 32), ((1, 3, 5, 7), 9)])
def test_convtranspose2x2(gen, shape, co):
    x = _randn(gen, *shape)
    w = _randn(gen, shape[-1], co, 2, 2, dtype=torch.float32) * 0.3
    bias = _randn(gen, co, dtype=torch.float32)
    got = _counted(fc.convtranspose2x2, lambda: fc.convtranspose2x2(x, w, bias))
    _close(got, fc.convtranspose2x2_plain(x, w, bias))


@pytest.mark.parametrize("shape,cb,co,pre", [
    ((2, 19, 37, 8), 0, 16, False),
    ((2, 19, 37, 24), 0, 40, True),
    ((1, 9, 5, 3), 5, 7, False),
])
def test_conv3x3_stats(gen, shape, cb, co, pre):
    ca = shape[-1]
    x = _randn(gen, *shape)
    xb = _randn(gen, *shape[:3], cb) if cb else None
    w = _randn(gen, co, ca + cb, 3, 3, dtype=torch.float32) * 0.2
    bias = _randn(gen, co, dtype=torch.float32)
    ab = dict(a=torch.rand(ca, generator=gen, device="cuda") + 0.5,
              b=_randn(gen, ca, dtype=torch.float32) * 0.5) if pre else {}
    got = _counted(fc.conv3x3, lambda: fc.conv3x3(x, w, bias, x_b=xb, stats=True, **ab))
    _close_all(got, fc.conv3x3_plain(x, w, bias, x_b=xb, stats=True, **ab))


def _bwd_operands(gen, shape, co, affine):
    g, y = _randn(gen, *shape[:3], co), _randn(gen, *shape[:3], co)
    c1, c2 = (_randn(gen, co, dtype=torch.float32) * 0.1 for _ in range(2))
    aff = dict(a=torch.rand(co, generator=gen, device="cuda") + 0.5,
               b=_randn(gen, co, dtype=torch.float32) * 0.5) if affine else {}
    return g, y, c1, c2, aff


# (shape of the conv's input, Cb, Co, affine cotangent, post / split / neither)
BWD_CASES = [
    ((2, 19, 37, 8), 0, 16, False, None),
    ((2, 19, 37, 40), 0, 40, True, "post"),
    ((2, 11, 23, 24), 0, 24, False, "post"),
    ((1, 16, 32, 16), 16, 16, False, "split"),
    ((1, 9, 5, 3), 5, 7, True, None),
    # the vector dgrad: an N (the forward's Cin) of 8, a split at Na = 40
    # inside its N tile of 64, a width of 100 pixels (not a multiple of 64)
    ((2, 19, 37, 8), 0, 64, True, "post"),
    ((1, 13, 70, 40), 24, 64, False, "split"),
    ((2, 11, 100, 16), 0, 48, True, "post"),
]


@pytest.mark.parametrize("shape,cb,co,affine,epi", BWD_CASES)
def test_conv3x3_dgrad(gen, shape, cb, co, affine, epi):
    ca = shape[-1]
    g, y, c1, c2, aff = _bwd_operands(gen, shape, co, affine)
    w = _randn(gen, co, ca + cb, 3, 3, dtype=torch.float32) * 0.2
    kw = dict(aff)
    if epi == "post":
        kw.update(x_post=_randn(gen, *shape), a_post=torch.rand(ca, generator=gen, device="cuda") + 0.5,
                  b_post=_randn(gen, ca, dtype=torch.float32) * 0.5)
    elif epi == "split":
        kw.update(split=ca)
    got = _counted(fc.conv3x3_dgrad, lambda: fc.conv3x3_dgrad(g, y, w, c1, c2, **kw))
    _close_all(got, fc.conv3x3_dgrad_plain(g, y, w, c1, c2, **kw))


@pytest.mark.parametrize("shape,cb,co,affine,epi", BWD_CASES)
def test_conv3x3_wgrad(gen, shape, cb, co, affine, epi):
    ca = shape[-1]
    g, y, c1, c2, aff = _bwd_operands(gen, shape, co, affine)
    x = _randn(gen, *shape)
    kw = dict(aff, x_b=_randn(gen, *shape[:3], cb) if cb else None)
    if epi == "post":  # conv2's operand: bn1's affine + ReLU of x
        kw.update(a_pre=torch.rand(ca, generator=gen, device="cuda") + 0.5,
                  b_pre=_randn(gen, ca, dtype=torch.float32) * 0.5)
    got = _counted(fc.conv3x3_wgrad, lambda: fc.conv3x3_wgrad(g, y, x, c1, c2, **kw))
    _close_all(got, fc.conv3x3_wgrad_plain(g, y, x, c1, c2, **kw))


# ---- the conv kernels at the main paths' channel widths (32, 64, 128 and
# the [32|32], [64|64] decoder concats), small batches, ragged images: every
# load mode and epilogue of the tensor-core forward/dgrad and wgrad kernels

WIDE_FWD = [  # (shape of the conv's input, Cb, Co, pre-affine)
    ((2, 19, 37, 32), 0, 64, False),    # enc1.conv1
    ((2, 19, 37, 64), 0, 64, True),     # enc1.conv2
    ((1, 11, 23, 64), 0, 128, False),   # enc2.conv1
    ((1, 11, 23, 128), 0, 128, True),   # enc2.conv2
    ((2, 11, 23, 64), 64, 64, False),   # dec4.conv1 [64|64]
    ((2, 19, 37, 32), 32, 32, False),   # dec5.conv1 [32|32]
    ((2, 19, 37, 32), 0, 32, True),     # dec5.conv2
    ((2, 19, 37, 16), 0, 16, False),    # clip_res dec5.conv1
    ((2, 19, 37, 16), 0, 16, True),     # clip_res dec5.conv2
    ((2, 11, 23, 64), 0, 64, True),     # dec4.conv2
    ((2, 19, 37, 32), 0, 32, False),    # the autoencoder's dec3.conv1
    # the tensor-parallel Co/2 slices of the level 0-1 convs (Co 16, 32, 64)
    ((2, 19, 37, 64), 0, 32, True),     # enc1.conv2
    ((1, 11, 23, 64), 0, 64, False),    # enc2.conv1
    ((1, 11, 23, 128), 0, 64, True),    # enc2.conv2
    ((2, 11, 23, 64), 64, 32, False),   # dec4.conv1 [64|64]
    ((2, 19, 37, 32), 32, 16, False),   # dec5.conv1 [32|32]
    ((2, 19, 37, 32), 0, 16, True),     # dec5.conv2
    # the vector forward's strips (128 pixels, 64 at 128 input channels) and
    # runs: ragged widths over two and three strips, a run boundary inside an
    # image (more units than SMs), batch 3, one pixel
    ((1, 70, 150, 32), 0, 64, False),
    ((1, 13, 150, 64), 64, 64, False),
    ((3, 5, 131, 128), 0, 128, True),
    ((1, 1, 1, 64), 0, 64, True),
    ((1, 9, 37, 192), 0, 64, True),     # past 128 input channels: the k16 loop's tail
    # the most input channels the vector path takes (192, 160 at Co <= 16)
    # and, past them, the narrow path
    ((1, 9, 37, 96), 96, 32, False),    # [96|96] -> 32: 192
    ((1, 9, 37, 160), 0, 16, True),     # 160 -> 16
    ((1, 9, 37, 256), 0, 32, False),    # narrow: 256 -> 32
    ((1, 9, 37, 192), 0, 16, True),     # narrow: 192 -> 16
    ((1, 9, 37, 104), 104, 32, False),  # narrow: [104|104] -> 32
    # the dgrad's K (Co) at its edge and past it: the forward takes the rule's path too
    ((1, 9, 37, 96), 0, 192, False),    # 96 -> 192
    ((1, 9, 37, 16), 0, 160, True),     # 16 -> 160
    ((1, 9, 37, 96), 0, 208, False),    # narrow: 96 -> 208
    ((2, 19, 37, 16), 3, 3, False),     # clip_res out.conv1 [16|3] -> 3: the narrow path
    ((2, 19, 37, 3), 0, 3, True),       # clip_res out.conv2 3 -> 3
    # the narrow path: Cin 1, 3, 5, [16|3], [8|5], Co 1, 3, 5, 12, past one
    # 32-channel stage and one 32-channel N tile; H and W ragged against its
    # 32x16 pixel tile
    ((2, 37, 21, 1), 0, 32, False),     # prompt enc1.conv1, the heatmap
    ((2, 37, 21, 3), 0, 5, True),
    ((2, 37, 21, 5), 0, 12, True),
    ((2, 37, 21, 8), 5, 1, False),      # [8|5] -> 1
    ((1, 70, 19, 16), 3, 3, False),     # [16|3] -> 3 over three tile rows
    ((2, 19, 37, 40), 0, 3, True),      # two stages of K
    ((1, 11, 23, 45), 0, 12, False),
    ((1, 9, 13, 3), 0, 40, False),      # two N tiles
    ((2, 37, 21, 5), 0, 20, True),      # 20 of a 32-wide N tile
]


def _narrow(ca, cb, co) -> bool:
    """Whether the conv kernels take their narrow path for a conv of [Ca |
    Cb] -> Co channels (on operands at 16-byte boundaries): any count not a
    multiple of 8, or more channels than the vector kernel's resident
    weights fit: input channels in the forward (padded to 16: 192, or 160
    where Co <= 16), output channels in the dgrad (192, or 160 where Ca + Cb
    <= 16)."""
    cin, k = -(-(ca + cb) // 16) * 16, -(-co // 16) * 16
    return (bool(ca % 8 or cb % 8 or co % 8) or cin > (192 if co > 16 else 160)
            or k > (192 if ca + cb > 16 else 160))


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("shape,cb,co,pre", WIDE_FWD)
def test_conv3x3_at_main_path_widths(gen, shape, cb, co, pre, stats):
    ca = shape[-1]
    x = _randn(gen, *shape)
    xb = _randn(gen, *shape[:3], cb) if cb else None
    w = _randn(gen, co, ca + cb, 3, 3, dtype=torch.float32) / (9 * (ca + cb)) ** 0.5
    bias = _randn(gen, co, dtype=torch.float32) * 0.1
    ab = dict(a=torch.rand(ca, generator=gen, device="cuda") + 0.5,
              b=_randn(gen, ca, dtype=torch.float32) * 0.5) if pre else {}
    got = _counted(fc.conv3x3, lambda: fc.conv3x3(x, w, bias, x_b=xb, stats=stats, **ab))
    narrow = _narrow(ca, cb, co)
    assert fc.last_path(fc.conv3x3) == ("narrow" if narrow else "vector")
    ref = fc.conv3x3_plain(x, w, bias, x_b=xb, stats=stats, **ab)
    if stats and not narrow:  # the wgmma kernel's sums: held to its own outputs (see the helper)
        _close_stats_to_own_outputs(got, ref)
    else:
        _close_all(got, ref)


# (shape of the conv's input, Cb, Co, affine cotangent, post / split / raw / neither)
WIDE_BWD = [
    ((2, 19, 37, 64), 0, 64, False, "post"),     # enc1.conv2
    ((1, 11, 23, 128), 0, 128, False, "post"),   # enc2.conv2
    ((2, 19, 37, 32), 0, 32, True, "post"),      # dec5.conv2, bn2's affine on the cotangent
    ((2, 11, 23, 64), 64, 64, False, "split"),   # dec4.conv1
    ((2, 19, 37, 32), 32, 32, False, "split"),   # dec5.conv1
    ((1, 11, 23, 64), 0, 128, False, None),      # enc2.conv1
    ((2, 19, 37, 64), 0, 64, True, None),
    ((2, 19, 37, 64), 0, 64, False, "raw"),      # the unfused family: g itself
    ((2, 11, 23, 32), 0, 64, False, "raw"),
    ((2, 19, 37, 16), 0, 16, False, None),       # clip_res dec5.conv1
    ((2, 19, 37, 16), 0, 16, True, "post"),      # clip_res dec5.conv2
    ((2, 11, 23, 64), 0, 64, True, "post"),      # dec4.conv2
    ((2, 19, 37, 32), 0, 64, False, None),       # enc1.conv1
    ((2, 19, 37, 32), 0, 32, False, "raw"),      # the autoencoder's unfused dec3.conv1
    # the tensor-parallel Co/2 slices (Co 16, 32, 64)
    ((2, 19, 37, 64), 0, 32, False, "post"),     # enc1.conv2
    ((1, 11, 23, 128), 0, 64, False, "post"),    # enc2.conv2
    ((2, 11, 23, 64), 64, 32, False, "split"),   # dec4.conv1
    ((2, 19, 37, 32), 32, 16, False, "split"),   # dec5.conv1
    ((2, 19, 37, 32), 0, 16, True, "post"),      # dec5.conv2
    # the vector wgrad's strips and runs: ragged widths over two and three
    # strips, run boundaries inside an image, batch 3, one pixel
    ((1, 70, 150, 32), 0, 64, False, None),
    ((1, 13, 150, 64), 64, 64, True, "split"),
    ((3, 5, 131, 128), 0, 128, False, "post"),
    ((1, 1, 1, 64), 0, 64, True, "post"),
    ((1, 9, 37, 192), 0, 64, False, None),       # three input-channel tiles of dw
    # the vector path's most input channels, and past them the narrow path
    ((1, 9, 37, 96), 96, 32, False, "split"),    # [96|96] -> 32
    ((1, 9, 37, 160), 0, 16, True, "post"),      # 160 -> 16
    ((1, 9, 37, 256), 0, 32, False, None),       # narrow: 256 -> 32
    ((1, 9, 37, 192), 0, 16, True, "post"),      # narrow: 192 -> 16
    ((1, 9, 37, 104), 104, 32, False, "split"),  # narrow: [104|104] -> 32
    ((1, 9, 37, 208), 0, 32, False, "raw"),      # narrow: 208 -> 32
    # the dgrad's K (the forward's Co) at the vector path's edge (192, 160
    # where Cin <= 16) and past it (the narrow path in all three kernels)
    ((1, 9, 37, 96), 0, 192, False, None),       # 96 -> 192
    ((1, 9, 37, 64), 0, 192, True, "post"),      # 64 -> 192, affine cotangent and post
    ((1, 9, 37, 16), 0, 160, True, "post"),      # 16 -> 160
    ((1, 9, 37, 96), 0, 208, False, None),       # narrow: 96 -> 208
    ((1, 9, 37, 16), 0, 176, False, "raw"),      # narrow: 16 -> 176
    # the vector dgrad: N (the forward's Cin) of 8, a split at Na = 96 inside
    # an N tile of 128, 100- and 200-pixel rows (not multiples of 64)
    ((1, 9, 37, 8), 0, 64, False, "raw"),
    ((2, 11, 100, 96), 32, 64, False, "split"),
    ((1, 7, 200, 64), 0, 128, True, "post"),
    ((2, 19, 37, 16), 3, 3, False, "split"),     # clip_res out.conv1 [16|3] -> 3
    ((2, 19, 37, 3), 0, 3, True, "post"),        # clip_res out.conv2 3 -> 3
    # the narrow path in every load mode and epilogue
    ((2, 37, 21, 1), 0, 32, False, None),        # prompt enc1.conv1: the wgrad at Cin 1
    ((2, 37, 21, 3), 0, 5, True, "post"),
    ((2, 37, 21, 5), 0, 12, False, "raw"),
    ((2, 37, 21, 5), 0, 3, True, None),
    ((2, 37, 21, 8), 5, 1, False, "split"),      # [8|5]
    ((2, 37, 21, 5), 3, 3, True, "split"),       # [5|3]: dx split at an odd Na
    ((1, 70, 19, 16), 3, 3, False, "split"),     # [16|3] over three tile rows
    ((1, 11, 23, 3), 0, 40, False, "post"),      # dx: two stages of K; dw: two N tiles
    ((2, 19, 37, 40), 0, 3, False, None),        # dw: two input-channel tiles
    ((2, 19, 37, 20), 0, 3, True, "post"),       # dx: 20 of a 32-wide N tile, the post adjoint
]


def _wide_bwd(gen, shape, cb, co, affine, epi):
    """Operands of one dgrad and one wgrad call of a WIDE_BWD case."""
    ca = shape[-1]
    g, y, c1, c2, aff = _bwd_operands(gen, shape, co, affine)
    if epi == "raw":
        y = c1 = c2 = None
        aff = {}
    w = _randn(gen, co, ca + cb, 3, 3, dtype=torch.float32) / (9 * (ca + cb)) ** 0.5
    x = _randn(gen, *shape)
    dkw, wkw = dict(aff), dict(aff, x_b=_randn(gen, *shape[:3], cb) if cb else None)
    if epi == "post":
        dkw.update(x_post=x, a_post=torch.rand(ca, generator=gen, device="cuda") + 0.5,
                   b_post=_randn(gen, ca, dtype=torch.float32) * 0.5)
        wkw.update(a_pre=dkw["a_post"], b_pre=dkw["b_post"])
    elif epi == "split":
        dkw.update(split=ca)
    return g, y, c1, c2, w, x, dkw, wkw


@pytest.mark.parametrize("shape,cb,co,affine,epi", WIDE_BWD)
def test_conv3x3_dgrad_at_main_path_widths(gen, shape, cb, co, affine, epi):
    g, y, c1, c2, w, _, kw, _ = _wide_bwd(gen, shape, cb, co, affine, epi)
    got = _counted(fc.conv3x3_dgrad, lambda: fc.conv3x3_dgrad(g, y, w, c1, c2, **kw))
    ca = kw.get("split") or shape[-1] + cb  # the forward's [Ca | Cb], split where dx is
    narrow = _narrow(ca, shape[-1] + cb - ca, co)
    assert fc.last_path(fc.conv3x3_dgrad) == ("narrow" if narrow else "vector")
    _close_all(got, fc.conv3x3_dgrad_plain(g, y, w, c1, c2, **kw))


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("shape,cb,co,epi", [
    ((2, 9, 70, 32), 0, 64, None),       # 64 -> 32, a 128-pixel strip
    ((2, 9, 37, 64), 0, 64, "post"),
    ((1, 11, 23, 64), 64, 128, "split"),
    ((1, 5, 200, 128), 0, 128, None),    # K = 128: 64-pixel strips
])
def test_conv3x3_dgrad_zero_outside_the_image_after_the_transform(gen, shape, cb, co, epi, affine):
    """g = y = 0 with c1 = 1: the transformed cotangent is round(c1) in the
    image and zero outside it (SAME padding pads the transformed tensor,
    _gfold_transform), so the border pixels' dx sums fewer taps than the
    others'; a kernel that transformed the zero padding too is off there."""
    ca = shape[-1]
    cin = ca + cb
    g = torch.zeros(*shape[:3], co, device="cuda", dtype=torch.bfloat16)
    y = torch.zeros_like(g)
    c1 = torch.rand(co, generator=gen, device="cuda") + 1.0
    c2 = _randn(gen, co, dtype=torch.float32) * 0.1
    aff = dict(a=torch.rand(co, generator=gen, device="cuda") + 0.5,
               b=torch.rand(co, generator=gen, device="cuda") + 0.5) if affine else {}
    w = _randn(gen, co, cin, 3, 3, dtype=torch.float32) / (9 * cin) ** 0.5
    kw = dict(aff)
    if epi == "post":
        kw.update(x_post=_randn(gen, *shape), a_post=torch.rand(ca, generator=gen, device="cuda") + 0.5,
                  b_post=_randn(gen, ca, dtype=torch.float32) * 0.5)
    elif epi == "split":
        kw.update(split=ca)
    got = _counted(fc.conv3x3_dgrad, lambda: fc.conv3x3_dgrad(g, y, w, c1, c2, **kw))
    assert fc.last_path(fc.conv3x3_dgrad) == "vector"
    ref = fc.conv3x3_dgrad_plain(g, y, w, c1, c2, **kw)
    _close_all(got, ref)
    edge = ref if epi is None else ref[0]
    assert not torch.equal(edge[:, 0], edge[:, shape[1] // 2])  # the border differs


@pytest.mark.parametrize("shape,cb,co,affine,epi", WIDE_BWD)
def test_conv3x3_wgrad_at_main_path_widths(gen, shape, cb, co, affine, epi):
    g, y, c1, c2, _, x, _, kw = _wide_bwd(gen, shape, cb, co, affine, epi)
    got = _counted(fc.conv3x3_wgrad, lambda: fc.conv3x3_wgrad(g, y, x, c1, c2, **kw))
    assert fc.last_path(fc.conv3x3_wgrad) == ("narrow" if _narrow(shape[-1], cb, co) else "vector")
    _close_all(got, fc.conv3x3_wgrad_plain(g, y, x, c1, c2, **kw))


@pytest.mark.parametrize("co", [32, 64])
@pytest.mark.parametrize("stats", [False, True])
def test_conv3x3_forward_and_wgrad_at_one_input_channel(gen, co, stats):
    """Cin = 1 (the prompt heatmap): K padded with zeros to one k16 slice."""
    x = _randn(gen, 2, 11, 23, 1)
    w = _randn(gen, co, 1, 3, 3, dtype=torch.float32) * 0.5
    bias = _randn(gen, co, dtype=torch.float32)
    got = _counted(fc.conv3x3, lambda: fc.conv3x3(x, w, bias, stats=stats))
    _close_all(got, fc.conv3x3_plain(x, w, bias, stats=stats))
    g, y, c1, c2, _ = _bwd_operands(gen, (2, 11, 23, 1), co, stats)
    if not stats:  # the raw cotangent
        y = c1 = c2 = None
    got = _counted(fc.conv3x3_wgrad, lambda: fc.conv3x3_wgrad(g, y, x, c1, c2))
    _close_all(got, fc.conv3x3_wgrad_plain(g, y, x, c1, c2))


# ---- the deep path (ops/fused_conv.conv_path): the fold-1 blocks' convs
# of chip_smoke.deep_path_shapes (large_unet's enc3, enc4, dec2, dec3) and
# the tensor-parallel unet's Co/2 slices (Co 64 and 128), at batch 1-2 on
# ragged maps against the deep kernels' 4 x 64 pixel tiles

DEEP_FWD = [  # (shape of the conv's input, Cb, Co, pre-affine)
    ((2, 20, 36, 128), 0, 256, False),    # enc3.conv1
    ((2, 20, 36, 256), 0, 256, True),     # enc3.conv2
    ((1, 20, 36, 256), 0, 512, False),    # enc4.conv1
    ((1, 13, 70, 512), 0, 512, True),     # enc4.conv2, two column tiles
    ((2, 20, 36, 256), 256, 256, False),  # dec2.conv1 [256|256]
    ((2, 20, 36, 128), 128, 128, False),  # dec3.conv1 [128|128]
    ((2, 20, 36, 256), 0, 128, True),     # the Co/2 slice of enc3.conv2
    ((2, 20, 36, 128), 128, 64, False),   # the Co/2 slice of dec3.conv1
    ((1, 9, 5, 256), 0, 64, True),        # one tile, mostly outside the image
]


def _close_stats_to_own_outputs(got, ref):
    """A ``stats`` forward's ``(y, S, Q)``: y as :func:`_close`, and each
    element within one bf16 step of the plain y (plus the fp32 sums' own
    floor, SUM_RTOL of its largest magnitude); S and Q at SUM_RTOL of the
    float64 sums of the kernel's OWN bf16 outputs, which is what they sum
    (JAX sums the cast output, pallas_conv.py:452-453, 564-565).  The
    kernel's fp32 products sum in another order than the plain conv's, so
    some outputs round to the neighbouring bf16 value; the plain version's
    Q sums its own roundings and moves with them, by up to SUM_RTOL at
    batch 1 and 512 channels.  What ties y, S and Q to the plain version
    beyond that: the outputs off the plain ones are at most FLIP_SHARE of
    them, and as many above as below (to FLIP_SIGMAS standard deviations of
    a fair coin), as the rounding to nearest of sums taken in another order
    gives; a rounding with a bias (truncation: half the outputs a step
    down) fails both."""
    y, s, q = got
    _close(y, ref[0])
    yf, rf = y.float(), ref[0].float()
    mag = torch.maximum(yf.abs(), rf.abs()).clamp(min=2.0**-126)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    over = (yf - rf).abs() - step - SUM_RTOL * rf.abs().max()
    assert over.max().item() <= 0.0, over.max().item()
    side = torch.sign(yf - rf)
    off, lean = int(side.ne(0).sum().item()), int(side.sum().item())
    assert off <= FLIP_SHARE * y.numel(), (off, y.numel())
    assert abs(lean) <= FLIP_SIGMAS * (off ** 0.5 + 1), (lean, off)
    yd = y.double()
    for name, got_sum, own in (("S", s, yd.sum((0, 1, 2))), ("Q", q, (yd * yd).sum((0, 1, 2)))):
        assert got_sum.dtype == torch.float32
        err = (got_sum.double() - own).abs().max().item()
        assert err <= SUM_RTOL * own.abs().max().item(), (name, err)
    flips = int((y != ref[0]).sum().item())
    q_plain = (q.double() - ref[2].double()).abs().max().item() / ref[2].abs().max().item()
    q_own = ((q.double() - (yd * yd).sum((0, 1, 2))).abs().max()
             / (yd * yd).sum((0, 1, 2)).abs().max()).item()
    print(f"stats: {flips} of {y.numel()} outputs one bf16 step off the plain version's; "
          f"Q off its own outputs {q_own!r}, off the plain Q {q_plain!r} (relative)")


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("shape,cb,co,pre", DEEP_FWD)
def test_conv3x3_deep_path(gen, shape, cb, co, pre, stats):
    ca = shape[-1]
    assert fc.conv_path(ca, cb, co) == "deep"
    x = _randn(gen, *shape)
    xb = _randn(gen, *shape[:3], cb) if cb else None
    w = _randn(gen, co, ca + cb, 3, 3, dtype=torch.float32) / (9 * (ca + cb)) ** 0.5
    bias = _randn(gen, co, dtype=torch.float32) * 0.1
    ab = dict(a=torch.rand(ca, generator=gen, device="cuda") + 0.5,
              b=_randn(gen, ca, dtype=torch.float32) * 0.5) if pre else {}
    got = _counted(fc.conv3x3, lambda: fc.conv3x3(x, w, bias, x_b=xb, stats=stats, **ab))
    assert fc.last_path(fc.conv3x3) == "deep"
    ref = fc.conv3x3_plain(x, w, bias, x_b=xb, stats=stats, **ab)
    if stats:
        _close_stats_to_own_outputs(got, ref)
    else:
        _close_all(got, ref)


# (shape of the conv's input, Cb, Co, affine cotangent, post / split / raw / neither)
DEEP_BWD = [
    ((2, 20, 36, 256), 0, 256, False, "post"),   # enc3.conv2
    ((1, 13, 70, 512), 0, 512, True, "post"),    # enc4.conv2, bn2's affine on the cotangent
    ((1, 20, 36, 128), 0, 256, False, None),     # enc3.conv1
    ((1, 20, 36, 256), 0, 512, True, None),      # enc4.conv1
    ((2, 20, 36, 256), 256, 256, False, "split"),  # dec2.conv1
    ((2, 20, 36, 128), 128, 128, True, "split"),   # dec3.conv1
    ((2, 20, 36, 256), 0, 128, True, "post"),    # the Co/2 slice of enc3.conv2
    ((2, 20, 36, 128), 128, 64, False, "split"),  # the Co/2 slice of dec3.conv1
    ((2, 20, 36, 256), 0, 64, False, None),      # one 64-channel K stage of dx
    ((2, 20, 36, 256), 0, 256, False, "raw"),    # the cotangent itself
]


@pytest.mark.parametrize("shape,cb,co,affine,epi", DEEP_BWD)
def test_conv3x3_dgrad_deep_path(gen, shape, cb, co, affine, epi):
    g, y, c1, c2, w, _, kw, _ = _wide_bwd(gen, shape, cb, co, affine, epi)
    got = _counted(fc.conv3x3_dgrad, lambda: fc.conv3x3_dgrad(g, y, w, c1, c2, **kw))
    assert fc.last_path(fc.conv3x3_dgrad) == "deep"
    _close_all(got, fc.conv3x3_dgrad_plain(g, y, w, c1, c2, **kw))


@pytest.mark.parametrize("shape,cb,co,affine,epi", DEEP_BWD)
def test_conv3x3_wgrad_deep_path(gen, shape, cb, co, affine, epi):
    g, y, c1, c2, _, x, _, kw = _wide_bwd(gen, shape, cb, co, affine, epi)
    got = _counted(fc.conv3x3_wgrad, lambda: fc.conv3x3_wgrad(g, y, x, c1, c2, **kw))
    assert fc.last_path(fc.conv3x3_wgrad) == "deep"
    _close_all(got, fc.conv3x3_wgrad_plain(g, y, x, c1, c2, **kw))


def test_conv3x3_deep_path_long_chunk(gen):
    """The wgrad over more pixels than one register sum holds (its flushes
    into the partial rows) and a forward whose blocks walk many tiles."""
    shape, co = (8, 64, 64, 256), 256
    g, y, c1, c2, w, x, dkw, wkw = _wide_bwd(gen, shape, 0, co, True, "post")
    got = _counted(fc.conv3x3_wgrad, lambda: fc.conv3x3_wgrad(g, y, x, c1, c2, **wkw))
    _close_all(got, fc.conv3x3_wgrad_plain(g, y, x, c1, c2, **wkw))
    bias = _randn(gen, co, dtype=torch.float32) * 0.1
    fkw = dict(a=dkw["a_post"], b=dkw["b_post"], stats=True)
    got = _counted(fc.conv3x3, lambda: fc.conv3x3(x, w, bias, **fkw))
    _close_all(got, fc.conv3x3_plain(x, w, bias, **fkw))


def test_conv3x3_deep_path_refuses_misaligned_operands(gen):
    """No fallback: a shape the rule gives the deep path launches the deep
    kernel or raises."""
    x = _randn(gen, 1 * 8 * 8 * 256 + 1)[1:].view(1, 8, 8, 256)  # 2 bytes off 16
    w = _randn(gen, 256, 256, 3, 3, dtype=torch.float32) * 0.01
    bias = _randn(gen, 256, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fc.conv3x3(x, w, bias)


def test_conv_kernels_are_deterministic(gen):
    """Two launches on the same inputs: bit-identical outputs and sums (the
    cross-block sums are partial rows added in a fixed order, no atomics),
    on the vector path (one run, and several strips and runs of an image),
    on the narrow path (ClipRes's output block) and on the deep path (the
    fold-1 blocks)."""
    shape, co = (2, 19, 37, 64), 64
    g, y, c1, c2, w, x, dkw, wkw = _wide_bwd(gen, shape, 0, co, True, "post")
    bias = _randn(gen, co, dtype=torch.float32)
    calls = [
        lambda: fc.conv3x3(x, w, bias, a=dkw["a_post"], b=dkw["b_post"], stats=True),
        lambda: fc.conv3x3_dgrad(g, y, w, c1, c2, **dkw),
        lambda: fc.conv3x3_wgrad(g, y, x, c1, c2, **wkw),
    ]
    ng, ny, nc1, nc2, nw, nx, ndkw, nwkw = _wide_bwd(gen, (2, 70, 37, 16), 3, 3, False, "split")
    nbias = _randn(gen, 3, dtype=torch.float32)
    calls += [
        lambda: fc.conv3x3(nx, nw, nbias, x_b=nwkw["x_b"], stats=True),
        lambda: fc.conv3x3_dgrad(ng, ny, nw, nc1, nc2, **ndkw),
        lambda: fc.conv3x3_wgrad(ng, ny, nx, nc1, nc2, **nwkw),
    ]
    # the deep path: a fold-1 decoder's conv2 (post) and conv1 ([x | xb], split)
    for dshape, dcb, dco, depi in (((2, 20, 36, 256), 0, 256, "post"),
                                   ((2, 20, 36, 128), 128, 128, "split")):
        dg, dy, dc1, dc2, dw, dx, ddkw, dwkw = _wide_bwd(gen, dshape, dcb, dco, True, depi)
        dbias = _randn(gen, dco, dtype=torch.float32)
        fkw = (dict(a=ddkw["a_post"], b=ddkw["b_post"]) if depi == "post"
               else dict(x_b=dwkw["x_b"]))
        calls += [
            lambda dx=dx, dw=dw, dbias=dbias, fkw=fkw: fc.conv3x3(dx, dw, dbias, stats=True, **fkw),
            lambda dg=dg, dy=dy, dw=dw, dc1=dc1, dc2=dc2, ddkw=ddkw:
                fc.conv3x3_dgrad(dg, dy, dw, dc1, dc2, **ddkw),
            lambda dg=dg, dy=dy, dx=dx, dc1=dc1, dc2=dc2, dwkw=dwkw:
                fc.conv3x3_wgrad(dg, dy, dx, dc1, dc2, **dwkw),
        ]
    # the vector path over several strips and runs of one image
    rg, ry, rc1, rc2, rw, rx, rdkw, rwkw = _wide_bwd(gen, (1, 70, 150, 64), 0, 64, True, "post")
    rbias = _randn(gen, 64, dtype=torch.float32)
    calls += [
        lambda: fc.conv3x3(rx, rw, rbias, a=rdkw["a_post"], b=rdkw["b_post"], stats=True),
        lambda: fc.conv3x3_wgrad(rg, ry, rx, rc1, rc2, **rwkw),
    ]
    for call in calls:
        first, second = call(), call()
        torch.cuda.synchronize()
        for a, b in zip(first, second, strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(2, 16, 32, 64), (1, 7, 9, 5), (4, 64, 64, 3), (4, 64, 64, 16)])
def test_bn_relu_bwd_reduce(gen, shape):
    g, y = _randn(gen, *shape), _randn(gen, *shape)
    a = torch.rand(shape[-1], generator=gen, device="cuda") + 0.5
    b = _randn(gen, shape[-1], dtype=torch.float32) * 0.5
    got = _counted(fc.bn_relu_bwd_reduce, lambda: fc.bn_relu_bwd_reduce(g, y, a, b))
    _close_all(got, fc.bn_relu_bwd_reduce_plain(g, y, a, b))


@pytest.mark.parametrize("shape", [(2, 16, 32, 64), (1, 6, 10, 5)])
def test_maxpool2x2_affine_relu_bwd(gen, shape):
    # few distinct values, so windows hold ties the routing must break alike
    z = (torch.randint(-3, 4, shape, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    a = torch.rand(shape[-1], generator=gen, device="cuda") + 0.5
    b = _randn(gen, shape[-1], dtype=torch.float32) * 0.5
    dp = _randn(gen, shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    got = _counted(fc.maxpool2x2_affine_relu_bwd, lambda: fc.maxpool2x2_affine_relu_bwd(z, a, b, dp))
    ref = fc.maxpool2x2_affine_relu_bwd_plain(z, a, b, dp)
    assert torch.equal(got[0], ref[0])  # the same routing and one product: exact
    _close_all(got, ref)


# ---- K3 and the pool backward: one cooperative launch each (a persistent
# grid that sums across its blocks in a fixed order after a grid-wide
# barrier); the vector path for C a multiple of 8, for the pool a narrow
# path through shared memory otherwise.  Long runs (1M pixels), the channel
# counts the design treats apart, the sums against float64 at a main-path
# shape, bit-identical repeats, one CUDA kernel a call.

REDUCE_CHANNELS = [3, 5, 16, 32, 64, 256, 512]


def _affine(gen, c):
    return (torch.rand(c, generator=gen, device="cuda") + 0.5,
            _randn(gen, c, dtype=torch.float32) * 0.5)


def _pool_operands(gen, shape):
    # few distinct values, so windows hold ties the routing must break alike
    z = (torch.randint(-3, 4, shape, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    dp = _randn(gen, shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    return (z, *_affine(gen, shape[-1]), dp)


def _device_kernels(fn, attempts: int = 3) -> dict:
    """CUDA kernels of one call of ``fn`` (after a warm-up call), from
    torch.profiler: name -> launches; a trace that comes back empty is
    taken again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            total = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
            if total > 0:
                out[evt.key] = evt.count
        if out:
            break
    return out


@pytest.mark.parametrize("c", REDUCE_CHANNELS)
def test_bn_relu_bwd_reduce_long_run(gen, c):
    shape = (4, 512, 512, c)  # 1M pixels
    g, y = _randn(gen, *shape), _randn(gen, *shape)
    a, b = _affine(gen, c)
    got = _counted(fc.bn_relu_bwd_reduce, lambda: fc.bn_relu_bwd_reduce(g, y, a, b))
    _close_all(got, fc.bn_relu_bwd_reduce_plain(g, y, a, b))


@pytest.mark.parametrize("c", REDUCE_CHANNELS)
def test_maxpool2x2_affine_relu_bwd_long_run(gen, c):
    z, a, b, dp = _pool_operands(gen, (4, 512, 512, c))  # 1M pixels
    got = _counted(fc.maxpool2x2_affine_relu_bwd, lambda: fc.maxpool2x2_affine_relu_bwd(z, a, b, dp))
    ref = fc.maxpool2x2_affine_relu_bwd_plain(z, a, b, dp)
    assert torch.equal(got[0], ref[0])
    _close_all(got, ref)


@pytest.mark.parametrize("shape", [(2, 38, 70, 3), (3, 10, 14, 5), (1, 2, 2, 3), (2, 4, 6, 24)])
def test_maxpool2x2_affine_relu_bwd_narrow_runs(gen, shape):
    """The narrow path's runs: W/2 * C odd (16-byte groups of 8 window
    rows), a last run shorter than the others, a single window, and C = 24
    (three 8-channel groups a window on the vector path)."""
    z, a, b, dp = _pool_operands(gen, shape)
    got = _counted(fc.maxpool2x2_affine_relu_bwd, lambda: fc.maxpool2x2_affine_relu_bwd(z, a, b, dp))
    ref = fc.maxpool2x2_affine_relu_bwd_plain(z, a, b, dp)
    assert torch.equal(got[0], ref[0])
    _close_all(got, ref)


def test_bn_relu_bwd_reduce_sums_against_float64(gen):
    """dec4.bn2 of the large_unet step (batch 16, 256x256, 64 channels):
    the kernel's fp32 sums within SUM_RTOL of the float64 sums of the same
    products (the mask decided in fp32, as both versions decide it)."""
    shape = (16, 256, 256, 64)
    g, y = _randn(gen, *shape), _randn(gen, *shape)
    a, b = _affine(gen, 64)
    da, db = fc.bn_relu_bwd_reduce(g, y, a, b)
    ar, br = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    p = torch.where(y.float() * ar + br > 0, g.double(), 0.0)
    for got, ref in ((da, (p * y.double()).sum((0, 1, 2))), (db, p.sum((0, 1, 2)))):
        err = (got.double() - ref).abs().max().item()
        assert err <= SUM_RTOL * ref.abs().max().item(), err


def test_maxpool2x2_affine_relu_bwd_sums_against_float64(gen):
    """enc2's pool of the large_unet step (batch 16, 256x256, 128 channels):
    dz equal to the plain version's, and the affine sums within SUM_RTOL of
    float64 sums over the same routing, rebuilt as the first maximum of each
    window in row-major order."""
    z, a, b, dp = _pool_operands(gen, (16, 256, 256, 128))
    dz, da, db = fc.maxpool2x2_affine_relu_bwd(z, a, b, dp)
    ref = fc.maxpool2x2_affine_relu_bwd_plain(z, a, b, dp)
    assert torch.equal(dz, ref[0])
    ar, br = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    # the routed cotangent, rebuilt in float64 from the plain routing
    u = torch.relu(z.float() * ar + br).view(16, 128, 2, 128, 2, 128)
    flat = u.permute(0, 1, 3, 5, 2, 4).reshape(16, 128, 128, 128, 4)
    sel = flat.argmax(-1, keepdim=True)  # the first maximum in row-major order
    mask = torch.zeros_like(flat, dtype=torch.bool).scatter_(-1, sel, True)
    first = mask.view(16, 128, 128, 128, 2, 2).permute(0, 1, 4, 2, 5, 3).reshape(z.shape)
    pre = z.float() * ar + br
    g = dp.double().repeat_interleave(2, 1).repeat_interleave(2, 2)
    p = torch.where(first & (pre > 0), g, 0.0)
    for got, want in ((da, (p * z.double()).sum((0, 1, 2))), (db, p.sum((0, 1, 2)))):
        err = (got.double() - want).abs().max().item()
        assert err <= SUM_RTOL * want.abs().max().item(), err


@pytest.mark.parametrize("c", [3, 64, 512])
def test_reduction_kernels_are_deterministic_and_one_launch(gen, c):
    """Two calls on the same inputs: bit-identical sums (and dz); each call
    runs exactly one CUDA kernel, which adds the blocks' partial rows
    itself (no second pass, no PyTorch op on the device)."""
    shape = (2, 96, 160, c)
    g, y = _randn(gen, *shape), _randn(gen, *shape)
    a, b = _affine(gen, c)
    z, pa, pb, dp = _pool_operands(gen, shape)
    for call, kernel in ((lambda: fc.bn_relu_bwd_reduce(g, y, a, b), "bnred_kernel"),
                         (lambda: fc.maxpool2x2_affine_relu_bwd(z, pa, pb, dp), "pool_bwd")):
        first, second = call(), call()
        torch.cuda.synchronize()
        for u, v in zip(first, second, strict=True):
            assert torch.equal(u, v)
        kernels = _device_kernels(call)
        assert len(kernels) == 1 and list(kernels.values()) == [1], kernels
        assert kernel in next(iter(kernels)), kernels


def test_reduction_wrappers_refuse_what_the_kernels_do_not_take(gen):
    """No fallback and no conversion on the card: operands off 16 bytes
    fail in the kernel's launch, an fp64 affine and a channel count past
    the kernels' layouts raise before it."""
    g = _randn(gen, 1 * 4 * 4 * 8 + 1)[1:].view(1, 4, 4, 8)  # 2 bytes off 16
    y = _randn(gen, 1, 4, 4, 8)
    a, b = _affine(gen, 8)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fc.bn_relu_bwd_reduce(g, y, a, b)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fc.maxpool2x2_affine_relu_bwd(g, a, b, y[:, :2, :2].contiguous())
    with pytest.raises(TypeError, match="float32"):
        fc.bn_relu_bwd_reduce(y, y, a.double(), b)
    with pytest.raises(ValueError, match="no such shape"):
        c = 257  # lcm(257, 8) / 8 = 257 vectors a period: past one block
        fc.bn_relu_bwd_reduce(_randn(gen, 1, 2, 2, c), _randn(gen, 1, 2, 2, c), *_affine(gen, c))


@pytest.mark.parametrize("shape,co", [((2, 8, 16, 64), 32), ((1, 3, 5, 7), 9)])
def test_convtranspose2x2_bwd(gen, shape, co):
    x = _randn(gen, *shape)
    w = _randn(gen, shape[-1], co, 2, 2, dtype=torch.float32) * 0.3
    g = _randn(gen, shape[0], 2 * shape[1], 2 * shape[2], co)
    got = _counted(fc.convtranspose2x2_bwd, lambda: fc.convtranspose2x2_bwd(x, w, g))
    _close_all(got, fc.convtranspose2x2_bwd_plain(x, w, g))


# ---- the ConvTranspose kernels at the main paths' widths (Cin -> Co = 128
# -> 64, 64 -> 32, 64 -> 64) on images whose rows the pixel tiles cross
# (Win 24, 32, 13) with ragged M; Co not a multiple of 8 at Cin 64 (12: the
# 16-byte path, 10: the element path); enough pixels that blocks walk
# several tiles; and off the main paths, Cin past one 128-channel stage and
# 4*Co past one 256-column tile
WIDE_CT = [
    ((2, 7, 24, 128), 64),   # dec4
    ((3, 5, 32, 64), 32),    # dec5
    ((3, 5, 32, 64), 64),    # the autoencoder's dec1, dec2
    ((2, 9, 40, 32), 16),    # clip_res dec5
    ((2, 7, 24, 64), 12),
    ((1, 9, 13, 64), 10),
    ((8, 64, 96, 64), 32),
    ((4, 64, 96, 128), 64),
]
OFF_PATH_CT = [((1, 6, 10, 160), 16), ((1, 6, 10, 24), 128)]


def _ct_operands(gen, shape, co):
    x = _randn(gen, *shape)
    w = _randn(gen, shape[-1], co, 2, 2, dtype=torch.float32) / (4 * shape[-1]) ** 0.5
    g = _randn(gen, shape[0], 2 * shape[1], 2 * shape[2], co)
    bias = _randn(gen, co, dtype=torch.float32) * 0.1
    return x, w, g, bias


@pytest.mark.parametrize("shape,co", WIDE_CT + OFF_PATH_CT)
def test_convtranspose2x2_at_main_path_widths(gen, shape, co):
    x, w, _, bias = _ct_operands(gen, shape, co)
    got = _counted(fc.convtranspose2x2, lambda: fc.convtranspose2x2(x, w, bias))
    _close(got, fc.convtranspose2x2_plain(x, w, bias))


@pytest.mark.parametrize("shape,co", WIDE_CT + OFF_PATH_CT[:1])
def test_convtranspose2x2_bwd_at_main_path_widths(gen, shape, co):
    x, w, g, _ = _ct_operands(gen, shape, co)
    got = _counted(fc.convtranspose2x2_bwd, lambda: fc.convtranspose2x2_bwd(x, w, g))
    _close_all(got, fc.convtranspose2x2_bwd_plain(x, w, g))


def test_convtranspose2x2_bwd_refuses_co_above_64(gen):
    x, w, g, _ = _ct_operands(gen, (1, 2, 2, 8), 65)
    with pytest.raises(ValueError, match="Co <= 64"):
        fc.convtranspose2x2_bwd(x, w, g)


def test_convtranspose_kernels_are_deterministic(gen):
    """Two launches on the same inputs: bit-identical y, dx, dw and db (the
    chunks' partial rows are added in a fixed order, no atomics)."""
    x, w, g, bias = _ct_operands(gen, (4, 64, 96, 128), 64)
    for call in (lambda: (fc.convtranspose2x2(x, w, bias),),
                 lambda: fc.convtranspose2x2_bwd(x, w, g)):
        first, second = call(), call()
        torch.cuda.synchronize()
        for a, b in zip(first, second, strict=True):
            assert torch.equal(a, b)


def test_autograd_functions_train_through_the_kernels(gen):
    """One training step of the preset's small LargeUNet on the card: the
    kernel path and the plain path give the same loss and gradients within
    the bf16 limits (LOSS_RTOL, and GRAD_RL2 per weight gradient or the
    fp32 route)."""
    from image_segmentation_tpu_torch.models.registry import build_model
    from image_segmentation_tpu_torch.ops import conv1x1 as c11

    torch.manual_seed(0)
    args = dict(stem_features=8, encoder_features=(16, 32, 64, 128), w2d_level0=True,
                w2d_impl="pallas_fused", w2d_level1_fold2=True)
    x = torch.rand((2, 64, 64, 3), generator=gen, device="cuda")
    t = torch.randint(0, 3, (2, 64, 64), generator=gen, device="cuda")
    grads, losses = [], []
    sd = None
    dgrad = fc.conv3x3_dgrad  # the wrapper, whose count the plain run must not move
    for plain, dtype in PATHS:
        m = build_model("large_unet", device="cuda", dtype=dtype, **args)
        if sd is None:
            sd = m.state_dict()
        m.load_state_dict(sd)
        with contextlib.ExitStack() as stack:
            if plain:
                _plain_wrappers(stack, fc, c11)
            before = dgrad.launches
            loss = torch.nn.functional.cross_entropy(m(x, train=True).permute(0, 3, 1, 2), t)
            loss.backward()
            assert dgrad.launches == before + (0 if plain else 8)
        losses.append(loss.item())
        grads.append({k: p.grad.float() for k, p in m.named_parameters()})
    assert abs(losses[0] - losses[1]) <= LOSS_RTOL * abs(losses[1])
    _close_weight_grads(*grads)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = _randn(gen, 1, 4, 4, 8)
    w, bias = torch.zeros((8, 8, 3, 3), device="cuda"), torch.zeros(8, device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        fc.conv3x3(x.float(), w, bias)
    with pytest.raises(ValueError, match="contiguous"):
        fc.conv3x3(x.transpose(1, 2), w, bias)
    with pytest.raises(RuntimeError, match="forward-only"):
        fc.conv3x3(x, w.requires_grad_(), bias)


# ---- the augmentor's kernels: the shifts must be exact; the colour stage
# within 1e-5 in fp32 (the per-image gray sum in another order) and one
# bf16 step in bf16

@pytest.mark.parametrize("axis", ["row", "col"])
@pytest.mark.parametrize("shape", [
    (3, 17, 33),    # W % 4 != 0: rows start off the 16-byte grid
    (2, 64, 64),
    (1, 5, 130),
    (1, 5, 3),      # W < 4
    (1, 2100, 40),  # columns: a height no window of one strip holds
])
def test_shift(gen, axis, shape):
    from image_segmentation_tpu_torch.ops import roll

    n, h, w = shape
    size, length = (w, h) if axis == "row" else (h, w)
    x = torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device="cuda", dtype=torch.int32)
    s = torch.randint(-(size - 1), size, (n, length), generator=gen, device="cuda",
                      dtype=torch.int32)
    s[0, 0], s[-1, -1], s[0, length // 2] = size - 1, -(size - 1), 0
    wrapper = roll.row_shift if axis == "row" else roll.col_shift
    plain = roll.row_shift_plain if axis == "row" else roll.col_shift_plain
    got = _counted(wrapper, lambda: wrapper(x, s))
    assert torch.equal(got, plain(x, s))


@pytest.mark.parametrize("axis", ["row", "col"])
def test_shift_of_an_unaligned_view_by_any_int32_shift(gen, axis):
    """x and out 4 bytes past a 16-byte boundary, shifts over all of int32
    (every one past the plane's size moves the whole row or column out)."""
    from image_segmentation_tpu_torch.ops import roll

    shape = (2, 19, 37)
    n, h, w = shape
    length = h if axis == "row" else w
    buf = torch.randint(-2**31, 2**31 - 1, (n * h * w + 1,), generator=gen, device="cuda",
                        dtype=torch.int32)
    x = buf[1:].view(shape)
    s = torch.randint(-2**31, 2**31 - 1, (n, length), generator=gen, device="cuda", dtype=torch.int32)
    s[:, ::2] %= 40  # half of them within the plane
    s[0, 1], s[1, 1] = 2**31 - 1, -2**31
    wrapper = roll.row_shift if axis == "row" else roll.col_shift
    plain = roll.row_shift_plain if axis == "row" else roll.col_shift_plain
    got = _counted(wrapper, lambda: wrapper(x, s))
    assert torch.equal(got, plain(x, s))
    out = torch.empty(n * h * w + 1, dtype=torch.int32, device="cuda")[1:].view(shape)
    with mock.patch("torch.empty_like", return_value=out):
        wrapper(x, s)
    assert torch.equal(out, plain(x, s))


@pytest.mark.parametrize("n,size", [(16, 512), (64, 256)])
def test_shift_shears_at_main_path_sizes(gen, n, size):
    """The three shears of the augmentor's rotation over the large_unet
    batch and the prompt step's packed stack: many strips and planes."""
    from image_segmentation_tpu_torch.ops import roll
    from image_segmentation_tpu_torch.ops.augment import _shear3_shifts

    angles = torch.rand(n, generator=torch.Generator().manual_seed(n)) * 180.0 - 90.0
    _, sx, sy = _shear3_shifts(angles.to("cuda"), n, size, size)
    x = torch.randint(-2**31, 2**31 - 1, (n, size, size), generator=gen, device="cuda",
                      dtype=torch.int32)
    got = roll.row_shift(roll.col_shift(roll.row_shift(x, sx), sy), sx)
    ref = roll.row_shift_plain(roll.col_shift_plain(roll.row_shift_plain(x, sx), sy), sx)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape,view", [
    ((3, 37, 45), None),
    ((2, 64, 32), None),
    ((1, 3, 3), None),
    ((1, 3, 200), None),     # H = 3, a tile of 128 columns and a tail
    ((2, 130, 3), None),     # W = 3, three bands
    ((2, 150, 261), None),   # neither a multiple of the band nor of the tile
    ((16, 512, 512), None),  # the augmentor's batch: several bands and tiles an image
    ((2, 37, 45), "offset"),  # the image 1 byte past a 16-byte boundary
])
def test_preprocess(gen, shape, view):
    from image_segmentation_tpu_torch.ops import preprocess as pp
    from image_segmentation_tpu_torch.ops.augment import DataAugmentor

    n, h, w = shape
    u8 = torch.randint(0, 256, (n * h * w * 3 + 1,), generator=gen, device="cuda", dtype=torch.uint8)
    u8 = (u8[1:] if view == "offset" else u8[:-1]).view(n, h, w, 3)
    p = DataAugmentor(4).sample(n, torch.Generator().manual_seed(n * h)).to("cuda")
    got = _counted(pp.preprocess, lambda: pp.preprocess(u8, p.jitter, p.blur))
    ref = pp.preprocess_plain(u8, p.jitter, p.blur)
    assert got.dtype == torch.float32 and (got - ref).abs().max().item() <= 1e-5
    got16 = pp.preprocess(u8, p.jitter, p.blur, out_dtype=torch.bfloat16)
    ref16 = pp.preprocess_plain(u8, p.jitter, p.blur, out_dtype=torch.bfloat16).float()
    step = torch.exp2(torch.floor(torch.log2(ref16.abs().clamp(min=2.0**-126))) - 7)
    assert got16.dtype == torch.bfloat16 and bool(((got16.float() - ref16).abs() <= step).all())


def test_augmentor_on_the_card_equals_the_plain_path(gen):
    """apply_u8 on the kernels (shifts and the fused colour stage) against
    the same call on the plain versions: masks exact, images within 1e-5."""
    from image_segmentation_tpu_torch.ops import preprocess as pp
    from image_segmentation_tpu_torch.ops import roll
    from image_segmentation_tpu_torch.ops.augment import DataAugmentor

    images = torch.randint(0, 256, (6, 96, 96, 3), generator=gen, device="cuda", dtype=torch.uint8)
    masks = torch.randint(0, 3, (6, 96, 96), generator=gen, device="cuda", dtype=torch.uint8)
    aug = DataAugmentor(2, backend="pallas")
    params = aug.sample(6, torch.Generator().manual_seed(1)).to("cuda")
    before = roll.col_shift.launches
    ki, km = aug.apply_u8(params, images, masks)
    torch.cuda.synchronize()
    assert roll.col_shift.launches == before + 1
    with contextlib.ExitStack() as stack:
        for m in (roll, pp):
            for w in m.WRAPPERS:
                stack.enter_context(mock.patch.object(m, w.__name__, getattr(m, w.__name__ + "_plain")))
        pi, pm = aug.apply_u8(params, images, masks)
    assert torch.equal(km, pm)
    assert (ki - pi).abs().max().item() <= 1e-5


# ---- the prompt path: the 1-channel heatmap (Cin = 1, wgrad alone) and the
# cross-attention kernel

def test_conv3x3_stats_and_wgrad_at_one_input_channel(gen):
    """The prompt encoder's enc1.conv1 reads the 1-channel heatmap."""
    x = _randn(gen, 2, 19, 37, 1)
    w = _randn(gen, 32, 1, 3, 3, dtype=torch.float32) * 0.5
    bias = _randn(gen, 32, dtype=torch.float32)
    got = _counted(fc.conv3x3, lambda: fc.conv3x3(x, w, bias, stats=True))
    _close_all(got, fc.conv3x3_plain(x, w, bias, stats=True))
    g, y, c1, c2, _ = _bwd_operands(gen, (2, 19, 37, 1), 32, False)
    got = _counted(fc.conv3x3_wgrad, lambda: fc.conv3x3_wgrad(g, y, x, c1, c2))
    _close_all(got, fc.conv3x3_wgrad_plain(g, y, x, c1, c2))


def test_input_grad_false_block_launches_no_conv1_dgrad(gen):
    """One training step of the prompt encoder's enc1: 2 forward convs, 2
    wgrads, 1 dgrad (conv2's), and the same parameter gradients as the
    plain path."""
    from image_segmentation_tpu_torch.models.fused import FusedConvBlockDownsample

    torch.manual_seed(0)
    blk = FusedConvBlockDownsample(1, 32, input_grad=False, device="cuda")
    x = torch.rand((2, 64, 64, 1), generator=gen, device="cuda")
    wrappers = (fc.conv3x3, fc.conv3x3_dgrad, fc.conv3x3_wgrad)
    grads = []
    for plain, dtype in PATHS:
        blk.zero_grad(set_to_none=True)
        before = [w.launches for w in wrappers]
        with contextlib.ExitStack() as stack:
            if plain:
                _plain_wrappers(stack, fc)
            blk(x.to(dtype), train=True).float().square().mean().backward()
        torch.cuda.synchronize()
        want = [0, 0, 0] if plain else [2, 1, 2]
        assert [w.launches - b for w, b in zip(wrappers, before)] == want
        grads.append({k: p.grad.float().clone() for k, p in blk.named_parameters()})
    _close_weight_grads(*grads)


@pytest.mark.parametrize("b,length,d,s,heads", [
    (2, 100, 64, 8, 4),     # a tail query tile, four heads
    (1, 33, 512, 77, 1),    # K/V in five chunks of 16 keys
    (2, 64, 96, 1, 3),      # one key, a head dim off the warp width
])
def test_cross_attention(gen, b, length, d, s, heads):
    from image_segmentation_tpu_torch.ops import cross_attention as ca

    q, k, v = _randn(gen, b, length, d), _randn(gen, b, s, d), _randn(gen, b, s, d)
    got = _counted(ca.cross_attention, lambda: ca.cross_attention(q, k, v, heads))
    _close(got, ca.cross_attention_plain(q, k, v, heads))
    with pytest.raises(RuntimeError, match="no gradient"):
        ca.cross_attention(q.float().requires_grad_().to(torch.bfloat16), k, v, heads)


def _unaligned(gen, *shape):
    """A contiguous bf16 tensor that starts 2 bytes past a 16-byte
    boundary: every row off the kernels' 16-byte paths."""
    n = 1
    for d in shape:
        n *= d
    return _randn(gen, n + 1)[1:].view(shape)


@pytest.mark.parametrize("b,length,d,s,heads", [
    (2, 100, 32, 1, 1),       # dh 32, one key
    (2, 100, 256, 7, 4),      # dh 64, seven keys masked in one n-tile pair
    (8, 4100, 512, 8, 1),     # the fusion's dh 512: blocks walk many query tiles
    (4, 1024, 512, 8, 8),     # heads 8 (dh 64), the CLIP bottleneck
    (2, 333, 768, 32, 8),     # dh 96: a narrow last piece of the q ring
    (3, 77, 512, 64, 1),      # 64 keys: the scores' register limit
    (2, 100, 768, 60, 6),     # K/V of 4 of the 6 heads fit a block: two head groups, one partial
    (2, 50, 1024, 16, 1),     # dh 1024 on the tensor cores (fewer warps)
    (2, 50, 1024, 64, 1),     # dh 1024 at 64 keys: the long-context path
    (2, 70, 512, 65, 4),      # 65 keys: the long-context path
    (2, 40, 60, 5, 3),        # dh 20: element loads and stores
])
def test_cross_attention_tensor_core_path(gen, b, length, d, s, heads):
    from image_segmentation_tpu_torch.ops import cross_attention as ca

    q, k, v = _randn(gen, b, length, d), _randn(gen, b, s, d), _randn(gen, b, s, d)
    got = _counted(ca.cross_attention, lambda: ca.cross_attention(q, k, v, heads))
    _close(got, ca.cross_attention_plain(q, k, v, heads))


@pytest.mark.parametrize("s,heads", [(8, 1), (77, 4)])
def test_cross_attention_unaligned_views(gen, s, heads):
    from image_segmentation_tpu_torch.ops import cross_attention as ca

    q, k, v = _unaligned(gen, 2, 50, 512), _unaligned(gen, 2, s, 512), _unaligned(gen, 2, s, 512)
    got = _counted(ca.cross_attention, lambda: ca.cross_attention(q, k, v, heads))
    _close(got, ca.cross_attention_plain(q, k, v, heads))


def test_cross_attention_is_deterministic(gen):
    from image_segmentation_tpu_torch.ops import cross_attention as ca

    q, k, v = _randn(gen, 4, 1024, 512), _randn(gen, 4, 8, 512), _randn(gen, 4, 8, 512)
    first, second = ca.cross_attention(q, k, v, 1), ca.cross_attention(q, k, v, 1)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_fusion_with_a_multi_token_context_launches_the_kernel_once(gen):
    from image_segmentation_tpu_torch.ops import cross_attention as ca

    m = ca.CrossAttentionFusion(64, 4, kv_dim=32, device="cuda")
    spatial = _randn(gen, 2, 8, 8, 64)
    ctx = _randn(gen, 2, 5, 32)
    with torch.no_grad():
        got = _counted(ca.cross_attention, lambda: m(spatial, ctx))
        before = ca.cross_attention.launches
        one = m(spatial, ctx[:, 0])  # one token: the exact path, no kernel
        assert ca.cross_attention.launches == before
        with mock.patch.object(ca, "cross_attention", ca.cross_attention_plain):
            ref = m(spatial, ctx)
    assert one.shape == got.shape == (2, 8, 8, 64)
    _close(got, ref)


# ---- K11 (the 1x1 conv's backward), the conv kernels' unfused forms
# (w2d_impl="pallas") and the autoencoder

def _offset(t):
    """A contiguous view of ``t[1:]``: an operand that need not start on a
    16-byte boundary (the kernels' scalar paths)."""
    return t[1:]


@pytest.mark.parametrize("input_grad", [True, False])
@pytest.mark.parametrize("shape,co,view", [
    ((2, 19, 37, 3), 32, None),    # the stem; a tail tile of pixels
    ((2, 19, 37, 32), 3, None),    # the output conv
    ((1, 9, 5, 12), 8, None),
    ((3, 5, 7, 3), 7, _offset),    # odd byte offsets
])
def test_conv1x1_bwd(gen, shape, co, view, input_grad):
    from image_segmentation_tpu_torch.ops import conv1x1 as c11

    x, g = _randn(gen, *shape), _randn(gen, *shape[:3], co)
    if view is not None:
        x, g = view(x), view(g)
    w = _randn(gen, co, shape[-1], 1, 1, dtype=torch.float32) * 0.3
    got = _counted(c11.conv1x1_bwd, lambda: c11.conv1x1_bwd(x, g, w, input_grad=input_grad))
    ref = c11.conv1x1_bwd_plain(x, g, w, input_grad=input_grad)
    assert (got[0] is None) is (not input_grad)
    _close_all(tuple(t for t in got if t is not None), tuple(t for t in ref if t is not None))


def _shifted(t):
    """``t`` copied into a buffer one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.flatten()
    return buf[1:].view(t.shape)


@pytest.mark.parametrize("input_grad", [True, False])
@pytest.mark.parametrize("shape,co,view", [
    ((2, 512, 512, 3), 32, None),   # the stem: blocks walk many tiles
    ((2, 512, 512, 32), 3, None),   # the output conv
    ((2, 19, 37, 8), 7, None),
    ((2, 19, 37, 3), 7, None),
    ((1, 30, 40, 63), 32, None),    # Co * (Ci + 1) = 2048, MAX_SUMS: two table blocks
    ((1, 30, 40, 7), 256, None),    # the same edge, Co 256
    ((1, 10, 13, 511), 4, None),    # the same edge, Ci 511: eight table blocks, dx by elements
    ((2, 19, 37, 32), 3, _offset),  # g unaligned (x[1:] stays on 16 bytes at 32 channels)
    ((2, 19, 37, 32), 3, _shifted),  # both unaligned: the wide x by elements
])
def test_conv1x1_bwd_tensor_core_path(gen, shape, co, view, input_grad):
    from image_segmentation_tpu_torch.ops import conv1x1 as c11

    x, g = _randn(gen, *shape), _randn(gen, *shape[:3], co)
    if view is not None:
        x, g = view(x), view(g)
    w = _randn(gen, co, x.shape[-1], 1, 1, dtype=torch.float32) * 0.3
    got = _counted(c11.conv1x1_bwd, lambda: c11.conv1x1_bwd(x, g, w, input_grad=input_grad))
    ref = c11.conv1x1_bwd_plain(x, g, w, input_grad=input_grad)
    _close_all(tuple(t for t in got if t is not None), tuple(t for t in ref if t is not None))


def test_conv1x1_bwd_is_deterministic(gen):
    """Two launches: bit-identical dx, dw and db (per-warp sums added in
    warp order, per-block partial rows in a fixed second pass)."""
    from image_segmentation_tpu_torch.ops import conv1x1 as c11

    for ci, co in ((3, 32), (32, 3)):
        x, g = _randn(gen, 4, 256, 256, ci), _randn(gen, 4, 256, 256, co)
        w = _randn(gen, co, ci, 1, 1, dtype=torch.float32) * 0.3
        first, second = c11.conv1x1_bwd(x, g, w), c11.conv1x1_bwd(x, g, w)
        torch.cuda.synchronize()
        for a, b in zip(first, second, strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("shape,cb,co,affine,epi", [
    ((2, 37, 21, 16), 0, 16, False, "post"),   # would be the vector path, but for the offset
    ((2, 37, 21, 32), 0, 32, True, None),
    ((2, 37, 21, 16), 3, 3, False, "split"),   # clip_res out.conv1
    ((2, 37, 21, 8), 8, 8, False, "raw"),
])
def test_conv3x3_kernels_on_unaligned_operands(gen, shape, cb, co, affine, epi):
    """Operands one element past a 16-byte boundary (``_shifted``) take the
    narrow path of the forward (x), the dgrad (g and y) and the wgrad (x,
    g and y), whatever their channel counts."""
    g, y, c1, c2, w, x, dkw, wkw = _wide_bwd(gen, shape, cb, co, affine, epi)
    g, x = _shifted(g), _shifted(x)
    y = None if y is None else _shifted(y)
    bias = _randn(gen, co, dtype=torch.float32)
    pre = dict(a=dkw["a_post"], b=dkw["b_post"]) if epi == "post" else {}
    got = _counted(fc.conv3x3, lambda: fc.conv3x3(x, w, bias, x_b=wkw["x_b"], stats=True, **pre))
    assert fc.last_path(fc.conv3x3) == "narrow"
    _close_all(got, fc.conv3x3_plain(x, w, bias, x_b=wkw["x_b"], stats=True, **pre))
    got = _counted(fc.conv3x3_dgrad, lambda: fc.conv3x3_dgrad(g, y, w, c1, c2, **dkw))
    assert fc.last_path(fc.conv3x3_dgrad) == "narrow"
    _close_all(got, fc.conv3x3_dgrad_plain(g, y, w, c1, c2, **dkw))
    got = _counted(fc.conv3x3_wgrad, lambda: fc.conv3x3_wgrad(g, y, x, c1, c2, **wkw))
    assert fc.last_path(fc.conv3x3_wgrad) == "narrow"
    _close_all(got, fc.conv3x3_wgrad_plain(g, y, x, c1, c2, **wkw))


@pytest.mark.parametrize("shape,co", [((2, 19, 37, 8), 16), ((1, 9, 5, 3), 7)])
def test_conv3x3_unfused_forms(gen, shape, co):
    """``make_folded_conv3x3``'s forward, dx of the raw cotangent (y
    unread), dw and db."""
    x, g = _randn(gen, *shape), _randn(gen, *shape[:3], co)
    w = _randn(gen, co, shape[-1], 3, 3, dtype=torch.float32) * 0.2
    bias = _randn(gen, co, dtype=torch.float32)
    _close(_counted(fc.conv3x3, lambda: fc.conv3x3(x, w, bias)), fc.conv3x3_plain(x, w, bias))
    _close(_counted(fc.conv3x3_dgrad, lambda: fc.conv3x3_dgrad(g, None, w, None, None)),
           fc.conv3x3_dgrad_plain(g, None, w, None, None))
    _close_all(_counted(fc.conv3x3_wgrad, lambda: fc.conv3x3_wgrad(g, None, x, None, None)),
               fc.conv3x3_wgrad_plain(g, None, x, None, None))


@pytest.mark.parametrize("impl,per_step", [
    ("pallas_fused", {"conv3x3": 10, "conv3x3_dgrad": 10, "conv1x1_bwd": 2}),
    ("pallas", {"conv3x3": 10, "conv3x3_dgrad": 10, "conv1x1_bwd": 2}),
])
def test_autoencoder_train_step_kernels_vs_plain(gen, impl, per_step):
    """One training step of the autoencoder preset (and of its unfused
    ``w2d_impl="pallas"`` form) at 64x64, batch 2: the kernel path and the
    plain path give the same MSE and weight gradients within the bf16
    limits (LOSS_RTOL, and GRAD_RL2 per weight gradient or the fp32
    route)."""
    from image_segmentation_tpu_torch.config import preset
    from image_segmentation_tpu_torch.models.registry import build_model
    from image_segmentation_tpu_torch.ops import conv1x1 as c11

    torch.manual_seed(0)
    args = dict(preset("autoencoder").model_args, w2d_impl=impl)
    x = torch.rand((2, 64, 64, 3), generator=gen, device="cuda")
    wrappers = {"conv3x3": fc.conv3x3, "conv3x3_dgrad": fc.conv3x3_dgrad,
                "conv1x1_bwd": c11.conv1x1_bwd}
    grads, losses, sd = [], [], None
    for plain, dtype in PATHS:
        m = build_model("autoencoder", device="cuda", dtype=dtype, **args)
        sd = sd or m.state_dict()
        m.load_state_dict(sd)
        with contextlib.ExitStack() as stack:
            if plain:
                _plain_wrappers(stack, fc, c11)
            before = {k: w.launches for k, w in wrappers.items()}
            loss = ((m(x, train=True) - x) ** 2).mean()
            loss.backward()
            torch.cuda.synchronize()
            launched = {k: w.launches - before[k] for k, w in wrappers.items()}
        assert launched == ({k: 0 for k in wrappers} if plain else per_step)
        losses.append(loss.item())
        grads.append({k: p.grad.float() for k, p in m.named_parameters()})
    assert abs(losses[0] - losses[1]) <= LOSS_RTOL * abs(losses[1])
    _close_weight_grads(*grads)


# ---- the ClipRes models: dec5 and the output block on the kernels

@pytest.mark.parametrize("name,per_step", [
    ("clip_res", {"conv3x3": 4, "conv3x3_dgrad": 4, "convtranspose2x2_bwd": 1}),
    ("clip_res_class", {"conv3x3": 2, "conv3x3_dgrad": 2, "convtranspose2x2_bwd": 1}),
])
def test_clip_res_train_step_kernels_vs_plain(gen, name, per_step):
    """One training step of ClipRes (the ``clip_res`` preset's args) and of
    ClipResSegmentationClassification (``segment_classifier``'s) with a
    small CLIP tower at 64x64, batch 2: the kernel path and the plain path
    give the same loss and weight gradients within the bf16 limits
    (LOSS_RTOL, and GRAD_RL2 per weight gradient or the fp32 route), the
    class head's included; the frozen ResNet gets no gradient."""
    from image_segmentation_tpu_torch.config import preset
    from image_segmentation_tpu_torch.engine.train import make_loss_fn
    from image_segmentation_tpu_torch.models.registry import build_model

    torch.manual_seed(0)
    cls = name == "clip_res_class"
    args = dict(preset("segment_classifier" if cls else "clip_res").model_args,
                clip_kwargs=dict(hidden=64, layers=1, heads=2, mlp_dim=128, patch=32, proj_dim=64))
    x = torch.rand((2, 64, 64, 3), generator=gen, device="cuda")
    batch = {"masks": torch.randint(0, 2 if cls else 3, (2, 64, 64), generator=gen, device="cuda"),
             "labels": torch.tensor([0.0, 1.0], device="cuda")}
    loss_fn = make_loss_fn("class_binary" if cls else "hybrid")
    wrappers = {"conv3x3": fc.conv3x3, "conv3x3_dgrad": fc.conv3x3_dgrad,
                "convtranspose2x2_bwd": fc.convtranspose2x2_bwd}
    grads, losses, sd = [], [], None
    for plain, dtype in PATHS:
        m = build_model(name, device="cuda", dtype=dtype, **args)
        sd = sd or m.state_dict()
        m.load_state_dict(sd)
        with contextlib.ExitStack() as stack:
            if plain:
                _plain_wrappers(stack, fc)
            before = {k: w.launches for k, w in wrappers.items()}
            loss = loss_fn(m(x, train=True), batch)
            loss.backward()
            torch.cuda.synchronize()
            launched = {k: w.launches - before[k] for k, w in wrappers.items()}
        assert launched == ({k: 0 for k in wrappers} if plain else per_step)
        assert all(p.grad is None for p in m.encoder.parameters())
        losses.append(loss.item())
        grads.append({k: p.grad.float() for k, p in m.named_parameters() if p.grad is not None})
    assert abs(losses[0] - losses[1]) <= LOSS_RTOL * abs(losses[1])
    if cls:
        assert "class_head.weight" in grads[0]
    _close_weight_grads(*grads)


# ---- the robustness battery on the card ------------------------------------

@pytest.mark.parametrize("kind", ["int", "float"])
def test_perturbations_on_the_card_equal_the_cpu(gen, kind):
    """Every family at every point, on the same host draws: the card's
    output equals the CPU's (uint8-equal; the float battery within 1e-6,
    where the card may divide by 255 as a multiply by its reciprocal), so a
    card run and a CPU run perturb alike."""
    import numpy as np

    from image_segmentation_tpu_torch.data import perturbations as P

    u8 = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (3, 37, 29, 3),
                                                             dtype=np.uint8))
    x = u8 if kind == "int" else u8.float() / 255.0
    g = torch.Generator().manual_seed(0)
    for name, info in P.SWEEPS[kind].items():
        for p in info["params"]:
            draws = P.sample(kind, name, x.shape, p, g)
            ref = P.apply(kind, name, x, p, draws)
            got = P.apply(kind, name, x.cuda(), p,
                          None if draws is None else tuple(d.cuda() for d in draws)).cpu()
            if kind == "int":
                assert torch.equal(got, ref), (name, p)
            else:
                assert (got - ref).abs().max().item() <= 1e-6, (name, p)


def test_salt_pepper_on_the_card_is_deterministic(gen):
    """The last draw at a pixel wins on the card too (scatter_reduce amax,
    not a scatter with repeated indices): two runs and the CPU agree."""
    from image_segmentation_tpu_torch.data import perturbations as P

    img = torch.randint(0, 256, (2, 8, 8, 3), dtype=torch.uint8, generator=torch.Generator()
                        .manual_seed(1))
    pos = torch.randint(0, 64, (2, 4000), generator=torch.Generator().manual_seed(2))
    salt = torch.rand((2, 4000), generator=torch.Generator().manual_seed(3)) < 0.5
    ref = P.salt_pepper_draws(img, 4000 / 64, pos, salt)
    for _ in range(2):
        got = P.salt_pepper_draws(img.cuda(), 4000 / 64, pos.cuda(), salt.cuda()).cpu()
        assert torch.equal(got, ref)


def test_apply_perturbation_on_the_card_equals_the_cpu(gen):
    """``apply_perturbation`` on a card batch moves its host draws there:
    every integer family's last point equals the CPU's (uint8)."""
    from image_segmentation_tpu_torch.data import perturbations as P

    img = torch.randint(0, 256, (2, 37, 29, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(4))
    for name, info in P.INT_SWEEPS.items():
        p = info["params"][-1]
        got = P.apply_perturbation(name, img.cuda(), p).cpu()
        assert torch.equal(got, P.apply_perturbation(name, img, p)), name


@pytest.mark.parametrize("form", ["pair", "pre_affine", "element", "pool", "convtranspose"])
def test_operator_equals_its_direct_launch(gen, form):
    """Each ``imgseg::`` operator of an exported program on a card tensor
    is its wrapper's kernel: the same bits, one launch counted."""
    if form == "pool":
        z, a, b = _randn(gen, 2, 32, 32, 64), torch.rand(64, device="cuda") + 0.5, \
            torch.randn(64, device="cuda")
        call = lambda: torch.ops.imgseg.maxpool2x2_affine_relu(z, a, b)  # noqa: E731
        direct, wrapper = lambda: fc.maxpool2x2_affine_relu(z, a, b), fc.maxpool2x2_affine_relu  # noqa: E731
    elif form == "convtranspose":
        x, w, bias = _randn(gen, 2, 16, 16, 64), torch.randn(64, 32, 2, 2, device="cuda"), \
            torch.randn(32, device="cuda")
        call = lambda: torch.ops.imgseg.convtranspose2x2(x, w, bias)  # noqa: E731
        direct, wrapper = lambda: fc.convtranspose2x2(x, w, bias), fc.convtranspose2x2  # noqa: E731
    else:
        ca, cb, co = {"pair": (32, 32, 32), "pre_affine": (32, 0, 64), "element": (16, 3, 3)}[form]
        x = _randn(gen, 2, 32, 32, ca)
        xb = _randn(gen, 2, 32, 32, cb) if cb else None
        w, bias = torch.randn(co, ca + cb, 3, 3, device="cuda") * 0.1, torch.randn(co, device="cuda")
        a = torch.rand(ca, device="cuda") + 0.5 if form == "pre_affine" else None
        b = torch.randn(ca, device="cuda") if form == "pre_affine" else None
        call = lambda: torch.ops.imgseg.conv3x3(x, w, bias, xb, a, b)  # noqa: E731
        direct, wrapper = lambda: fc.conv3x3(x, w, bias, x_b=xb, a=a, b=b), fc.conv3x3  # noqa: E731
    before = wrapper.launches
    got = call()
    assert wrapper.launches == before + 1
    assert torch.equal(got, direct())


def test_prefetch_to_device_hands_out_batches_in_order(gen):
    """``prefetch_to_device`` to the card: the batches arrive in order and
    whole while the consumer's stream is busy with earlier ones (the copies
    on the side stream, the consumer waiting on each copy's event)."""
    from image_segmentation_tpu_torch.data.pipeline import prefetch_to_device

    host = [(torch.full((4, 256, 256, 3), i, dtype=torch.uint8),
             torch.full((4, 256, 256), 255 - i, dtype=torch.uint8)) for i in range(12)]
    busy = torch.randn(2048, 2048, device="cuda")
    seen = []
    for i, (images, masks) in enumerate(prefetch_to_device(iter(host), size=3, device="cuda")):
        for _ in range(4):  # keep the consumer stream busy past the next copies
            busy = busy @ busy / 2048
        assert images.device.type == "cuda" and images.shape == (4, 256, 256, 3)
        seen.append((int(images.float().mean().item()), int(masks.float().mean().item()),
                     bool((images == i).all()), bool((masks == 255 - i).all())))
    assert seen == [(i, 255 - i, True, True) for i in range(12)]


@pytest.mark.parametrize("size,batch,count", [(8, 4, 1), (8, 4, 2), (256, 16, 1)])
def test_native_loader_on_the_card_equals_its_cpu_batches(gen, size, batch, count):
    """The native loader to the card, each batch copied straight from its
    page-locked ring slot (slots small enough to share a page, and large
    ones), equals the batches it copies out on the CPU, over an epoch left
    after two batches and two whole epochs, while the consumer's stream is
    busy and every batch is held to the end."""
    import itertools

    import numpy as np

    from image_segmentation_tpu_torch.data.datasets import ArrayDataset
    from image_segmentation_tpu_torch.data.native_loader import NativeBatchPipeline

    rng = np.random.default_rng(size + count)
    data = ArrayDataset(rng.integers(0, 256, (22, size, size, 3), dtype=np.uint8),
                        rng.integers(0, 3, (22, size, size), dtype=np.uint8))
    kw = dict(augmentations_per_datapoint=1, shuffle=True, drop_last=True, seed=3,
              process_index=count - 1, process_count=count)
    card = NativeBatchPipeline(data, batch, device="cuda", **kw)
    cpu = NativeBatchPipeline(data, batch, device="cpu", **kw)
    busy = torch.randn(1024, 1024, device="cuda")
    for epoch, take in ((0, 2), (1, None), (2, None)):
        held, want = [], list(itertools.islice(cpu.epoch(epoch), take))
        for images, masks in itertools.islice(card.epoch(epoch), take):
            for _ in range(4):  # keep the consumer stream busy past the next copies
                busy = busy @ busy / 1024
            held.append((images, masks))
        assert len(held) == len(want) == (take or 44 // batch)
        for (gi, gm), (wi, wm) in zip(held, want):
            assert gi.device.type == "cuda" and torch.equal(gi.cpu(), wi)
            assert torch.equal(gm.cpu(), wm)


# ---- tensor parallelism -------------------------------------------------------

@pytest.fixture(scope="module")
def tp_blocks():
    """Two gloo ranks on the card, one model group (tests/_torch_port_tp_worker.run_block;
    imported by its own name: pytest puts tests/ on the path, and the ranks
    inherit it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from image_segmentation_tpu_torch.parallel import mesh

    ranks = mesh.launch("_torch_port_tp_worker:run_block", 2, [], backend="gloo",
                        timeout=600)
    return ranks


@pytest.mark.parametrize("case", ["encoder", "decoder", "conv1 only", "conv2 only", "upsample",
                                  "fold-1 decoder"])
def test_tensor_parallel_fused_blocks_vs_plain(tp_blocks, case):
    """The TP form of FusedBlockFunction (both convs, or one, on their Co/2
    slices), the pool on the slice and the ConvTranspose kernel at (data=1,
    model=2) against the whole block on the plain versions: the output, the
    input gradients and every gathered parameter gradient within GRAD_RL2
    relative L2, or, where bf16 rounding dominates (plain bf16 itself more
    than GRAD_RL2 from fp32), no further from fp32 than BF16_NOISE_FACTOR
    times the plain path; equal on both ranks."""
    r0, r1 = (r[case] for r in tp_blocks)
    assert r0 == r1 and r0.pop("sharded")
    for key, (err, p32, k32) in r0.items():
        assert err <= GRAD_RL2 or (p32 > GRAD_RL2 and k32 <= BF16_NOISE_FACTOR * p32), (
            key, err, p32, k32)
