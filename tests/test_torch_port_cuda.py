"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present.  On a machine
with a card (and without jax, which the repo's root conftest.py imports)
run them with

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Inputs are bf16; the plain versions compute in fp32 (TF32 off) from the same
bf16 operands and round to bf16, so the two differ only by the order of the
fp32 sums and the bf16 rounding it can flip: tolerance 1e-2 of the output's
largest magnitude.
"""

import pytest
import torch

from image_segmentation_tpu_torch.ops import fused_conv as fc

pytestmark = pytest.mark.cuda
RTOL = 1e-2


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


def _counted(wrapper, fn):
    before = wrapper.launches
    out = fn()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    return out


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


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = _randn(gen, 1, 4, 4, 8)
    w, bias = torch.zeros((8, 8, 3, 3), device="cuda"), torch.zeros(8, device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        fc.conv3x3(x.float(), w, bias)
    with pytest.raises(ValueError, match="contiguous"):
        fc.conv3x3(x.transpose(1, 2), w, bias)
    with pytest.raises(RuntimeError, match="forward-only"):
        fc.conv3x3(x, w.requires_grad_(), bias)
