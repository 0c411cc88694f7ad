"""The port's 1x1-conv backward (K11, image_segmentation_tpu_torch/ops/
conv1x1.py) and its one-conv Function (``fused_conv.Conv3x3Function``)
against the JAX Pallas kernels they replace, on the CPU.

The JAX side runs ``make_folded_1x1`` and ``make_folded_conv3x3`` at fold 4
in interpret mode under ``jax.vjp`` on the width-folded layout, and the
results are unfolded with ``models/folded.d2w``; the port's Functions run
their wrappers' plain versions under autograd on the plain NHWC tensors.
Tolerance rtol = atol = 1e-5, the JAX suite's own for these kernels
(test_pallas_conv.py:406/482): both sides are fp32 and differ only in the
order of the sums.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu.models.folded import d2w, w2d
from image_segmentation_tpu.ops.pallas_conv import make_folded_1x1, make_folded_conv3x3
from image_segmentation_tpu.utils.torch_export import conv_kernel_to_torch
from image_segmentation_tpu_torch.ops import conv1x1, fused_conv

jax.config.update("jax_default_matmul_precision", "highest")
TOL = dict(rtol=1e-5, atol=1e-5)
FOLD = 4


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _params(t):
    return t.detach().clone().requires_grad_()


def _jax_vjp(fn, x, k, bias, g, ci, co):
    """(y, dx, dk (torch layout), db) of ``fn`` on the folded view of x."""
    y4, vjp = jax.vjp(fn, jnp.asarray(w2d(x, FOLD)), jnp.asarray(k), jnp.asarray(bias))
    dx4, dk, db = vjp(jnp.asarray(w2d(g, FOLD)))
    return (np.asarray(d2w(y4, co, FOLD)), np.asarray(d2w(dx4, ci, FOLD)),
            conv_kernel_to_torch(np.asarray(dk)), np.asarray(db))


def _port_vjp(fn, x, k, bias, g, input_grad=True):
    xt = torch.from_numpy(x).requires_grad_(input_grad)
    w, b = _params(torch.from_numpy(conv_kernel_to_torch(k))), _params(torch.from_numpy(bias))
    y = fn(xt, w, b)
    y.backward(torch.from_numpy(g))
    return y, xt.grad, w.grad, b.grad


@pytest.mark.parametrize("ci,co", [(3, 32), (32, 3), (8, 12)])
def test_conv1x1_matches_make_folded_1x1(ci, co):
    """The stem (3 -> 32), the output conv (32 -> 3) and a shape of
    neither; JAX's vjp is K11, the port's backward conv1x1_bwd."""
    rng = np.random.default_rng(ci * 100 + co)
    x, g = _normal(rng, (2, 4, 16, ci)), _normal(rng, (2, 4, 16, co))
    k, bias = _normal(rng, (1, 1, ci, co), ci ** -0.5), _normal(rng, (co,), 0.5)
    ref = _jax_vjp(make_folded_1x1(ci, co, FOLD, "float32", interpret=True), x, k, bias, g, ci, co)
    got = _port_vjp(conv1x1.Conv1x1Function.apply, x, k, bias, g)
    for name, a, b in zip(("y", "dx", "dw", "db"), got, ref):
        np.testing.assert_allclose(a.detach().numpy(), b, err_msg=name, **TOL)
    plain = conv1x1.conv1x1_bwd_plain(torch.from_numpy(x), torch.from_numpy(g),
                                      torch.from_numpy(conv_kernel_to_torch(k)))
    for name, a, b in zip(("dx", "dw", "db"), plain, ref[1:]):
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **TOL)


def test_conv1x1_asks_for_no_input_gradient_of_the_image():
    """The stem's input is the image: its backward takes no dx, and the
    parameter gradients are the same."""
    rng = np.random.default_rng(3)
    x, g = _normal(rng, (2, 4, 8, 3)), _normal(rng, (2, 4, 8, 32))
    k, bias = _normal(rng, (1, 1, 3, 32)), _normal(rng, (32,))
    calls = []

    def spy(*args, **kw):
        calls.append(kw["input_grad"])
        return conv1x1.conv1x1_bwd_plain(*args, **kw)

    with mock.patch.object(conv1x1, "conv1x1_bwd", spy):
        _, dx, dw, db = _port_vjp(conv1x1.Conv1x1Function.apply, x, k, bias, g, input_grad=False)
        ref = _port_vjp(conv1x1.Conv1x1Function.apply, x, k, bias, g)
    assert calls == [False, True] and dx is None
    assert torch.equal(dw, ref[2]) and torch.equal(db, ref[3])


@pytest.mark.parametrize("ci,co", [(8, 16), (32, 8)])
def test_conv3x3_function_matches_make_folded_conv3x3(ci, co):
    """``w2d_impl="pallas"``'s conv: forward :1978, dx :2005, dw and db
    :2016 against Conv3x3Function on conv3x3 and its no-transform
    dgrad/wgrad."""
    rng = np.random.default_rng(ci + co)
    x, g = _normal(rng, (2, 8, 16, ci)), _normal(rng, (2, 8, 16, co))
    k, bias = _normal(rng, (3, 3, ci, co), (9 * ci) ** -0.5), _normal(rng, (co,), 0.5)
    ref = _jax_vjp(make_folded_conv3x3(ci, co, FOLD, interpret=True), x, k, bias, g, ci, co)
    got = _port_vjp(fused_conv.Conv3x3Function.apply, x, k, bias, g)
    for name, a, b in zip(("y", "dx", "dw", "db"), got, ref):
        np.testing.assert_allclose(a.detach().numpy(), b, err_msg=name, **TOL)


def test_conv3x3_function_skips_dgrad_without_an_input_gradient():
    rng = np.random.default_rng(4)
    x, g = _normal(rng, (1, 4, 8, 4)), _normal(rng, (1, 4, 8, 8))
    k, bias = _normal(rng, (3, 3, 4, 8)), _normal(rng, (8,))
    with mock.patch.object(fused_conv, "conv3x3_dgrad",
                           mock.Mock(wraps=fused_conv.conv3x3_dgrad)) as dgrad:
        _, dx, dw, _ = _port_vjp(fused_conv.Conv3x3Function.apply, x, k, bias, g,
                                 input_grad=False)
        assert dgrad.call_count == 0 and dx is None and dw is not None
        _port_vjp(fused_conv.Conv3x3Function.apply, x, k, bias, g)
        assert dgrad.call_count == 1


def test_the_no_transform_mode_is_the_raw_cotangent():
    """dgrad/wgrad with y, c1, c2 None equal the transform with c1 = c2 = 0
    (then ge = round(g) = g), and partial transforms are refused."""
    rng = np.random.default_rng(5)
    g, y, x = (torch.from_numpy(_normal(rng, (1, 5, 6, c))) for c in (8, 8, 4))
    w = torch.from_numpy(_normal(rng, (8, 4, 3, 3)))
    zero = torch.zeros(8)
    assert torch.equal(fused_conv.conv3x3_dgrad(g, None, w, None, None),
                       fused_conv.conv3x3_dgrad(g, y, w, zero, zero))
    for a, b in zip(fused_conv.conv3x3_wgrad(g, None, x, None, None),
                    fused_conv.conv3x3_wgrad(g, y, x, zero, zero)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="together"):
        fused_conv.conv3x3_dgrad(g, y, w, None, None)
    with pytest.raises(ValueError, match="affine"):
        fused_conv.conv3x3_wgrad(g, None, x, None, None, a=zero, b=zero)
    with pytest.raises(ValueError, match="neither post nor split"):
        fused_conv.conv3x3_dgrad(g, None, w, None, None, split=2)


def test_conv1x1_bwd_dispatch():
    """A CPU tensor takes the plain version uncounted; another device
    raises."""
    x, g, w = torch.zeros((1, 2, 2, 3)), torch.zeros((1, 2, 2, 4)), torch.zeros((4, 3, 1, 1))
    before = conv1x1.conv1x1_bwd.launches
    dx, dw, db = conv1x1.conv1x1_bwd(x, g, w)
    assert conv1x1.conv1x1_bwd.launches == before
    assert dx.shape == x.shape and dw.shape == w.shape and db.shape == (4,)
    with pytest.raises(ValueError, match="unsupported device"):
        conv1x1.conv1x1_bwd(x.to("meta"), g.to("meta"), w.to("meta"))
