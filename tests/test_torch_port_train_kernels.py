"""The training forms of the port's kernel functions (image_segmentation_tpu_
torch/ops/fused_conv.py) against the JAX Pallas kernels they replace.

On the CPU a wrapper runs its plain PyTorch version, and the autograd
Functions run on the wrappers; the JAX side runs its Pallas kernels in
interpret mode on the width-folded layout (folds 1, 2, 4), unfolded with
``models/folded.d2w`` to compare like with like.  Inputs come from numpy
seeds; everything is fp32.

Tolerances: rtol = atol = 1e-5 for values that are one fp32 sum deep (conv
outputs, the pool and ConvTranspose gradients, the BN-ReLU reduction: the
JAX suite's own for these kernels, test_pallas_conv.py:406/482); the
block's batch statistics and gradients are several chained fp32 sums over
the batch with cancellation in ``E[y^2] - mean^2`` and in the BN backward,
and are held to rtol = atol = 1e-4 (the JAX suite holds the same block's
gradients to 5e-4 against its dense twin, test_pallas_conv.py:153).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu.models.folded import concat_perm, d2w, w2d
from image_segmentation_tpu.ops.pallas_conv import (
    _bn_relu_bwd_reduce_pallas,
    make_folded_block,
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
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a, grad=False) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("fold,pre", [(1, False), (2, True), (4, False), (4, True)])
def test_conv3x3_stats_matches_pallas(fold, pre):
    rng = np.random.default_rng(500 + 10 * fold + pre)
    b, h, w, ci, co = 2, 8, 16, 8, 16
    x = _normal(rng, (b, h, w, ci))
    k = _normal(rng, (3, 3, ci, co), 0.2)
    bias = _normal(rng, (co,), 0.5)
    a = rng.uniform(0.5, 1.5, ci).astype(np.float32)
    bb = _normal(rng, (ci,), 0.5)
    conv = make_folded_conv_bn3x3(ci, co, fold, pre=pre, stats=True, interpret=True)
    ab = (jnp.asarray(a), jnp.asarray(bb)) if pre else ()
    y4, s, q = conv(jnp.asarray(w2d(x, fold)), jnp.asarray(k), jnp.asarray(bias), *ab)
    y, S, Q = fused_conv.conv3x3(
        _t(x), _t(conv_kernel_to_torch(k)), _t(bias), stats=True,
        **(dict(a=_t(a), b=_t(bb)) if pre else {}),
    )
    np.testing.assert_allclose(y.numpy(), np.asarray(d2w(y4, co, fold)), **TOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(s), **TOL)
    np.testing.assert_allclose(Q.numpy(), np.asarray(q), **TOL)


# (case, fold): "plain" = an encoder block; "split" = a decoder block over
# [up | skip]; "raw" = raw_out with cotangents on mean2/var2 (the encoder
# feeding the affine pool).  Every case also has cotangents on mean1/var1.
BLOCK_CASES = [(c, f) for c in ("plain", "split", "raw") for f in (1, 2, 4)]


@pytest.mark.parametrize("case,fold", BLOCK_CASES)
def test_block_forward_and_gradients_match_pallas(case, fold):
    rng = np.random.default_rng(600 + 10 * fold + BLOCK_CASES.index((case, fold)))
    bsz, h, w, co = 2, 4, 8, 8
    ca, cb = (4, 4) if case == "split" else (6, 0)
    ci = ca + cb
    xa = _normal(rng, (bsz, h, w, ca))
    xb = _normal(rng, (bsz, h, w, cb)) if cb else None
    k1 = _normal(rng, (3, 3, ci, co), 0.3)
    k2 = _normal(rng, (3, 3, co, co), 0.3)
    vecs = [_normal(rng, (co,), 0.3) for _ in range(2)]  # conv biases
    bn = [rng.uniform(0.5, 1.5, co).astype(np.float32), _normal(rng, (co,), 0.3),
          rng.uniform(0.5, 1.5, co).astype(np.float32), _normal(rng, (co,), 0.3)]
    gz = _normal(rng, (bsz, h, w, co))
    cts = [_normal(rng, (co,)) for _ in range(4)]  # on mean1, var1, mean2, var2
    raw = case == "raw"

    blk = make_folded_block(
        ci, co, fold, in_perm=concat_perm(ca, cb, fold) if cb else None, eps=1e-5,
        interpret=True, in_split=fold * ca if cb else None, raw_out=raw,
    )
    xs = [jnp.asarray(w2d(xa, fold))] + ([jnp.asarray(w2d(xb, fold))] if cb else [])
    params = [jnp.asarray(v) for v in (k1, vecs[0], k2, vecs[1], *bn)]

    def jloss(*args):
        z4, *stats = blk(*args)
        out = jnp.sum(z4 * jnp.asarray(w2d(gz, fold)))
        return out + sum(jnp.sum(s * c) for s, c in zip(stats, cts)), (z4, stats)

    (_, (z4, jstats)), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(xs) + 8)), has_aux=True)(*xs, *params)

    tx = [_t(xa, True)] + ([_t(xb, True)] if cb else [])
    tp = [_t(conv_kernel_to_torch(k1), True), _t(vecs[0], True),
          _t(conv_kernel_to_torch(k2), True), _t(vecs[1], True)] + [_t(v, True) for v in bn]
    z, *stats = fused_conv.FusedBlockFunction.apply(
        tx[0], tx[1] if cb else None, *tp, raw, 1e-5)
    loss = (z * _t(gz)).sum() + sum((s * _t(c)).sum() for s, c in zip(stats, cts))
    loss.backward()

    np.testing.assert_allclose(z.detach().numpy(), np.asarray(d2w(z4, co, fold)), **BLOCK_TOL)
    for got, ref in zip(stats, jstats):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **BLOCK_TOL)
    jx, jp = jgrads[:len(xs)], jgrads[len(xs):]
    for t, g, c in zip(tx, jx, (ca, cb)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(d2w(g, c, fold)), **BLOCK_TOL)
    refs = [conv_kernel_to_torch(jp[0]), jp[1], conv_kernel_to_torch(jp[2]), *jp[3:]]
    names = ["w1", "c1b", "w2", "c2b", "scale1", "bias1", "scale2", "bias2"]
    for t, ref, name in zip(tp, refs, names):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), err_msg=name, **BLOCK_TOL)


# the channel counts the CUDA kernels treat apart: 3 (the pool's narrow
# path; a period of 3 vectors in K3), 8, 16, 64, 256 (one to 32 8-channel
# groups a window)
@pytest.mark.parametrize("c", [3, 8, 16, 64, 256])
@pytest.mark.parametrize("fold", [2, 4])
def test_pool_vjp_matches_pallas(fold, c):
    """Tied windows included: equal positive values in one window, where
    the cotangent must reach the same (first, row-major) position."""
    rng = np.random.default_rng(700 + fold + (0 if c == 8 else 10 * c))  # c = 8: the first seeds
    z = (rng.integers(-3, 4, (2, 8, 16, c)) * 0.5).astype(np.float32)
    a = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bb = _normal(rng, (c,), 0.5)
    u = np.maximum(z * a + bb, 0).reshape(2, 4, 2, 8, 2, c)
    wmax = u.max(axis=(2, 4), keepdims=True)
    assert (((u == wmax) & (wmax > 0)).sum(axis=(2, 4)) > 1).any(), "no tied positive windows"
    dp = _normal(rng, (2, 4, 8, c))
    ab = np.stack([np.tile(a, fold), np.tile(bb, fold)])
    pool = make_folded_pool(c, fold, interpret=True, with_ab=True)
    _, vjp = jax.vjp(pool, jnp.asarray(w2d(z, fold)), jnp.asarray(ab))
    dz4, dab = vjp(jnp.asarray(w2d(dp, fold // 2)))
    tz, ta, tb = _t(z, True), _t(a, True), _t(bb, True)
    p = fused_conv.PoolFunction.apply(tz, ta, tb)
    p.backward(_t(dp))
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(d2w(dz4, c, fold)), **TOL)
    dab = np.asarray(dab).reshape(2, fold, c).sum(1)
    np.testing.assert_allclose(ta.grad.numpy(), dab[0], **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), dab[1], **TOL)


@pytest.mark.parametrize("fold", [2, 4])
def test_convtranspose_vjp_matches_pallas(fold):
    rng = np.random.default_rng(800 + fold)
    b, hin, win, ci, co = 2, 4, 8, 12, 8
    m = fold // 2
    x = _normal(rng, (b, hin, win, ci))
    k = _normal(rng, (2, 2, ci, co), 0.3)
    bias = _normal(rng, (co,), 0.5)
    gy = _normal(rng, (b, 2 * hin, 2 * win, co))
    ct = make_folded_convtranspose2x2(ci, co, fold, interpret=True)
    _, vjp = jax.vjp(ct, jnp.asarray(x.reshape(b, hin, win // m, m * ci)),
                     jnp.asarray(k), jnp.asarray(bias))
    dxf, dk, db = vjp(jnp.asarray(w2d(gy, fold)))
    tx, tw, tb = _t(x, True), _t(conv_transpose_kernel_to_torch(k), True), _t(bias, True)
    fused_conv.ConvTransposeFunction.apply(tx, tw, tb).backward(_t(gy))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dxf).reshape(x.shape), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), conv_transpose_kernel_to_torch(dk), **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(db), **TOL)


@pytest.mark.parametrize("c", [3, 16, 64, 256])
def test_bn_relu_bwd_reduce_matches_pallas(c):
    rng = np.random.default_rng(900 + (0 if c == 16 else c))  # c = 16: the first seed
    g = _normal(rng, (2, 8, 16, c))
    y = _normal(rng, (2, 8, 16, c))
    a = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bb = _normal(rng, (c,), 0.5)
    da, db = _bn_relu_bwd_reduce_pallas(jnp.asarray(g), jnp.asarray(y),
                                        jnp.asarray(np.stack([a, bb])),
                                        h_tile=None, interpret=True)
    got = fused_conv.bn_relu_bwd_reduce(_t(g), _t(y), _t(a), _t(bb))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(da), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(db), **TOL)


def test_dgrad_and_wgrad_plain_versions_are_autograd_of_the_conv():
    """conv3x3_dgrad/wgrad without the BN transform (c1 = c2 = 0) are the
    plain conv's autograd gradients, with the post epilogue and the split."""
    rng = np.random.default_rng(950)
    x = _t(_normal(rng, (2, 5, 7, 6)), True)
    w = _t(_normal(rng, (4, 6, 3, 3), 0.3), True)
    bias = _t(_normal(rng, (4,)), True)
    a, b = _t(rng.uniform(0.5, 1.5, 6)), _t(_normal(rng, (6,), 0.5))
    g = _t(_normal(rng, (2, 5, 7, 4)))
    fused_conv.conv3x3_plain(x, w, bias, a=a, b=b).backward(g)
    y = torch.zeros_like(g)
    zero = torch.zeros(4)
    with torch.no_grad():
        dx, _, _ = fused_conv.conv3x3_dgrad(g, y, w, zero, zero, x_post=x, a_post=a, b_post=b)
        dw, db = fused_conv.conv3x3_wgrad(g, y, x, zero, zero, a_pre=a, b_pre=b)
        dxa, dxb = fused_conv.conv3x3_dgrad(g, y, w, zero, zero, split=2)
        full = fused_conv.conv3x3_dgrad(g, y, w, zero, zero)
    np.testing.assert_allclose(dx.numpy(), x.grad.numpy(), **TOL)
    np.testing.assert_allclose(dw.numpy(), w.grad.numpy(), **TOL)
    np.testing.assert_allclose(db.numpy(), bias.grad.numpy(), **TOL)
    np.testing.assert_array_equal(torch.cat([dxa, dxb], -1).numpy(), full.numpy())


def _train_wrapper_calls(device):
    z = torch.zeros((1, 4, 4, 2), device=device)
    v = torch.zeros(2, device=device)
    w = torch.zeros((2, 2, 3, 3), device=device)
    return [
        lambda: fused_conv.conv3x3_dgrad(z, z, w, v, v),
        lambda: fused_conv.conv3x3_wgrad(z, z, z, v, v),
        lambda: fused_conv.bn_relu_bwd_reduce(z, z, v, v),
        lambda: fused_conv.maxpool2x2_affine_relu_bwd(z, v, v, z[:, :2, :2]),
        lambda: fused_conv.convtranspose2x2_bwd(z[:, :2, :2], torch.zeros((2, 2, 2, 2), device=device), z),
    ]


def test_backward_wrappers_on_cpu_take_the_plain_version_uncounted():
    before = [w.launches for w in fused_conv.WRAPPERS]
    for call in _train_wrapper_calls("cpu"):
        call()
    assert [w.launches for w in fused_conv.WRAPPERS] == before
    assert len(fused_conv.WRAPPERS) == 8


@pytest.mark.parametrize("which", range(5))
def test_backward_wrappers_raise_on_other_devices(which):
    with pytest.raises(ValueError, match="unsupported device"):
        _train_wrapper_calls("meta")[which]()
