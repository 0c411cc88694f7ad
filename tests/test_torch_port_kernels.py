"""The port's three kernel wrappers (image_segmentation_tpu_torch/ops/
fused_conv.py) against the JAX Pallas kernels they replace.

On the CPU a wrapper runs its plain PyTorch version; the JAX side runs the
Pallas kernel in interpret mode on the width-folded layout, and the result
is unfolded with ``models/folded.d2w`` to compare like with like.  The
tolerance is the JAX suite's own for these kernels (rtol = atol = 1e-5,
test_pallas_conv.py:406/482): both sides are fp32 and differ only in the
order of the sums.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu.models.folded import concat_perm, d2w, w2d
from image_segmentation_tpu.ops.pallas_conv import (
    make_folded_conv_bn3x3,
    make_folded_convtranspose2x2,
    make_folded_pool,
)
from image_segmentation_tpu.utils.torch_export import (
    conv_kernel_to_torch,
    conv_transpose_kernel_to_torch,
)
from image_segmentation_tpu_torch.ops import fused_conv

jax.config.update("jax_default_matmul_precision", "highest")
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("fold", [1, 2, 4])
def test_conv3x3_matches_pallas(fold, pre):
    rng = np.random.default_rng(100 + 10 * fold + pre)
    b, h, w, ci, co = 2, 8, 16, 8, 16
    x = _normal(rng, (b, h, w, ci))
    k = _normal(rng, (3, 3, ci, co), 0.2)
    bias = _normal(rng, (co,), 0.5)
    a = rng.uniform(0.5, 1.5, ci).astype(np.float32)
    bb = _normal(rng, (ci,), 0.5)
    conv = make_folded_conv_bn3x3(ci, co, fold, pre=pre, interpret=True)
    ab = (jnp.asarray(a), jnp.asarray(bb)) if pre else ()
    ref = d2w(conv(jnp.asarray(w2d(x, fold)), jnp.asarray(k), jnp.asarray(bias), *ab), co, fold)
    out = fused_conv.conv3x3(
        _t(x), _t(conv_kernel_to_torch(k)), _t(bias),
        **(dict(a=_t(a), b=_t(bb)) if pre else {}),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("fold", [1, 2, 4])
def test_conv3x3_two_inputs_matches_pallas(fold):
    """The decoder's [up | skip] input, joined on load (folded.py:615, 779)."""
    rng = np.random.default_rng(200 + fold)
    b, h, w, ca, cb, co = 2, 8, 16, 8, 4, 8
    xa = _normal(rng, (b, h, w, ca))
    xb = _normal(rng, (b, h, w, cb))
    k = _normal(rng, (3, 3, ca + cb, co), 0.2)
    bias = _normal(rng, (co,), 0.5)
    conv = make_folded_conv_bn3x3(
        ca + cb, co, fold, in_perm=concat_perm(ca, cb, fold), in_split=fold * ca,
        interpret=True,
    )
    ref = d2w(conv(jnp.asarray(w2d(xa, fold)), jnp.asarray(w2d(xb, fold)),
                   jnp.asarray(k), jnp.asarray(bias)), co, fold)
    out = fused_conv.conv3x3(_t(xa), _t(conv_kernel_to_torch(k)), _t(bias), x_b=_t(xb))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("fold", [2, 4])
def test_pool_matches_pallas(fold):
    rng = np.random.default_rng(300 + fold)
    c = 8
    # few distinct levels, so windows hold ties (and ReLU adds zero ties)
    z = (rng.integers(-3, 4, (2, 8, 16, c)) * 0.5).astype(np.float32)
    a = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bb = _normal(rng, (c,), 0.5)
    u = np.maximum(z * a + bb, 0).reshape(2, 4, 2, 8, 2, c)
    wmax = u.max(axis=(2, 4), keepdims=True)
    assert ((u == wmax).sum(axis=(2, 4)) > 1).any(), "no tied windows"
    ab = np.stack([np.tile(a, fold), np.tile(bb, fold)])
    pool = make_folded_pool(c, fold, interpret=True, with_ab=True)
    ref = d2w(pool(jnp.asarray(w2d(z, fold)), jnp.asarray(ab)), c, fold // 2)
    out = fused_conv.maxpool2x2_affine_relu(_t(z), _t(a), _t(bb))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("fold", [2, 4])
def test_convtranspose_matches_pallas(fold):
    rng = np.random.default_rng(400 + fold)
    b, hin, win, ci, co = 2, 4, 8, 12, 8
    m = fold // 2
    x = _normal(rng, (b, hin, win, ci))
    k = _normal(rng, (2, 2, ci, co), 0.3)
    bias = _normal(rng, (co,), 0.5)
    ct = make_folded_convtranspose2x2(ci, co, fold, interpret=True)
    xf = jnp.asarray(x.reshape(b, hin, win // m, m * ci))
    ref = d2w(ct(xf, jnp.asarray(k), jnp.asarray(bias)), co, fold)
    out = fused_conv.convtranspose2x2(
        _t(x), _t(conv_transpose_kernel_to_torch(k)), _t(bias)
    )
    assert out.shape == (b, 2 * hin, 2 * win, co)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _wrapper_calls(device):
    x = torch.zeros((1, 4, 4, 2), device=device)
    return [
        lambda: fused_conv.conv3x3(x, torch.zeros((3, 2, 3, 3), device=device),
                                   torch.zeros(3, device=device)),
        lambda: fused_conv.maxpool2x2_affine_relu(x, torch.ones(2, device=device),
                                                  torch.zeros(2, device=device)),
        lambda: fused_conv.convtranspose2x2(x, torch.zeros((2, 3, 2, 2), device=device),
                                            torch.zeros(3, device=device)),
    ]


def test_cpu_tensors_take_the_plain_version_uncounted():
    before = [w.launches for w in fused_conv.WRAPPERS]
    for call in _wrapper_calls("cpu"):
        call()
    assert [w.launches for w in fused_conv.WRAPPERS] == before


@pytest.mark.parametrize("which", [0, 1, 2])
def test_other_devices_raise(which):
    with pytest.raises(ValueError, match="unsupported device"):
        _wrapper_calls("meta")[which]()


def test_conv3x3_rejects_bad_operand_combinations():
    x = torch.zeros((1, 4, 4, 2))
    w, bias = torch.zeros((3, 4, 3, 3)), torch.zeros(3)
    with pytest.raises(ValueError, match="second input"):
        fused_conv.conv3x3(x, w, bias, x_b=x, a=torch.ones(2), b=torch.zeros(2))
    with pytest.raises(ValueError, match="both a and b"):
        fused_conv.conv3x3(x, w, bias, a=torch.ones(2))
