"""The port's augmentor (image_segmentation_tpu_torch/ops/augment.py) and its
two kernel modules (ops/roll.py, ops/preprocess.py) against the JAX
package, on the CPU, where the kernel wrappers run their plain versions.

Inputs come from numpy seeds; random draws are JAX's own (its key splits,
as ``DataAugmentor.apply_u8`` makes them) handed to the port as
``AugmentParams``.  The JAX side runs the shift kernel as
``pallas_row_shift``/``pallas_col_shift`` in interpret mode and as the XLA
roll form ``_row_shift``, the colour kernel as ``pallas_preprocess``
(interpret mode off the TPU), and ``_rotate_shear3`` under both settings of
``IMGSEG_PALLAS_ROLL``.

Tolerances:

- the geometry (shift tables, shifts, every rotation method, masks) moves
  whole values: bit for bit;
- the colour stage: atol 2e-6, the JAX suite's own between its two colour
  backends (test_pallas_preprocess.py:38).  Both sides are fp32; they
  differ in the order of the gray mean's sum and of the 3-term gray dot
  product (the largest difference seen is about 6e-7).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu.ops import augment as J
from image_segmentation_tpu.ops.pallas_preprocess import pallas_preprocess
from image_segmentation_tpu.ops.pallas_roll import (
    pack_u8x4 as jax_pack,
    pallas_col_shift,
    pallas_row_shift,
    unpack_u8x4 as jax_unpack,
)
from image_segmentation_tpu_torch.ops import augment as A
from image_segmentation_tpu_torch.ops import preprocess as P
from image_segmentation_tpu_torch.ops import roll

COLOUR_ATOL = 2e-6
KEY = jax.random.PRNGKey(3)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _jax_params(key, n, max_degrees=90.0) -> A.AugmentParams:
    """JAX's draws for ``DataAugmentor.apply_u8(key, ...)`` on n samples."""
    kg, kc, kb = jax.random.split(key, 3)
    k_flip, k_rot = jax.random.split(kg)
    return A.AugmentParams(
        flip=_t(jax.random.bernoulli(k_flip, 0.5, (n,))),
        angles=_t(jax.random.uniform(k_rot, (n,), minval=-max_degrees, maxval=max_degrees)),
        jitter=_t(J.sample_jitter_factors(kc, n)),
        blur=_t(J.sample_blur_weights(kb, n)),
    )


def _shifts(rng, n, length, size):
    """Shifts in [-(size-1), size-1], the extremes included."""
    s = rng.integers(-(size - 1), size, (n, length)).astype(np.int32)
    s[0, 0], s[-1, -1] = size - 1, -(size - 1)
    return s


# ---- the shifts (K6) -------------------------------------------------------

@pytest.mark.parametrize("axis", ["row", "col"])
@pytest.mark.parametrize("h,w", [(16, 16), (8, 24), (24, 8)])
def test_shift_plain_matches_pallas_kernel(axis, h, w):
    rng = np.random.default_rng(h * w + (axis == "row"))
    x = jax_pack(jnp.asarray(rng.integers(0, 256, (3, h, w, 4), dtype=np.uint8)))
    s = _shifts(rng, 3, h, w) if axis == "row" else _shifts(rng, 3, w, h)
    kernel = pallas_row_shift if axis == "row" else pallas_col_shift
    ref = np.asarray(kernel(x, jnp.asarray(s), interpret=True))
    plain = roll.row_shift_plain if axis == "row" else roll.col_shift_plain
    wrapper = roll.row_shift if axis == "row" else roll.col_shift
    np.testing.assert_array_equal(plain(_t(x), _t(s)).numpy(), ref)
    before = wrapper.launches
    np.testing.assert_array_equal(wrapper(_t(x), _t(s)).numpy(), ref)
    assert wrapper.launches == before  # a CPU tensor launches nothing


@pytest.mark.parametrize("axis", ["row", "col"])
def test_shift_plain_matches_xla_roll_form(axis):
    """The XLA form needs |s| <= max_shift; within that it equals the
    kernel's (as tests/test_pallas_roll.py pins on the JAX side)."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (3, 16, 16, 4), dtype=np.uint8)
    s = rng.integers(-7, 8, (3, 16)).astype(np.int32)
    if axis == "row":
        ref = J._row_shift(jnp.asarray(x), jnp.asarray(s), 7)
        got = roll.row_shift_plain(roll.pack_u8x4(_t(x)), _t(s))
    else:
        xt = jnp.swapaxes(jnp.asarray(x), 1, 2)
        ref = jnp.swapaxes(J._row_shift(xt, jnp.asarray(s), 7), 1, 2)
        got = roll.col_shift_plain(roll.pack_u8x4(_t(x)), _t(s))
    np.testing.assert_array_equal(roll.unpack_u8x4(got).numpy(), np.asarray(ref))


def test_pack_unpack_match_jax_bitcast():
    x = np.random.default_rng(8).integers(0, 256, (2, 5, 7, 4), dtype=np.uint8)
    packed = roll.pack_u8x4(_t(x))
    assert packed.dtype == torch.int32 and packed.shape == (2, 5, 7)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_pack(jnp.asarray(x))))
    np.testing.assert_array_equal(roll.unpack_u8x4(packed).numpy(),
                                  np.asarray(jax_unpack(jax_pack(jnp.asarray(x)))))


def test_shift_wrappers_refuse_bad_operands():
    x = torch.zeros((2, 4, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="shifts must have shape"):
        roll.row_shift(x, torch.zeros((2, 6), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        roll.col_shift(x.float(), torch.zeros((2, 6), dtype=torch.int32))
    assert len(roll.WRAPPERS) == 2 and len(P.WRAPPERS) == 1


# ---- shift tables and geometry ---------------------------------------------

@pytest.mark.parametrize("size", [32, 33, 512])
def test_shear3_shift_tables_match_jax(size):
    rng = np.random.default_rng(size)
    angles = np.concatenate([[0.0, 45.0, -45.0, 90.0, -90.0, 44.99, -44.99, 22.5],
                             rng.uniform(-90, 90, 24)]).astype(np.float32)
    ref = J._shear3_shifts(jnp.asarray(angles), 32, size, size)
    got = A._shear3_shifts(_t(angles), 32, size, size)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("method,pallas_roll", [
    ("shear3", "0"), ("shear3", "1"), ("gather", "0"), ("two_pass", "0")])
def test_geometry_matches_jax_on_u8x4(method, pallas_roll, monkeypatch):
    monkeypatch.setenv("IMGSEG_PALLAS_ROLL", pallas_roll)
    rng = np.random.default_rng(9)
    stacked = rng.integers(0, 256, (10, 32, 32, 4), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    ref = J.random_geometric(key, jnp.asarray(stacked), 90.0, method)
    k_flip, k_rot = jax.random.split(key)
    flip = _t(jax.random.bernoulli(k_flip, 0.5, (10,)))
    angles = _t(jax.random.uniform(k_rot, (10,), minval=-90.0, maxval=90.0))
    got = A.apply_geometric(_t(stacked), flip, angles, method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape,dtype", [((6, 24, 24, 5), np.float32),   # the roll form
                                         ((4, 16, 24, 4), np.uint8)])    # non-square: gather
def test_geometry_matches_jax_off_the_packed_path(shape, dtype):
    rng = np.random.default_rng(10)
    stacked = rng.integers(0, 256, shape).astype(dtype)
    key = jax.random.PRNGKey(6)
    ref = J.random_geometric(key, jnp.asarray(stacked))
    k_flip, k_rot = jax.random.split(key)
    n = shape[0]
    got = A.apply_geometric(_t(stacked), _t(jax.random.bernoulli(k_flip, 0.5, (n,))),
                            _t(jax.random.uniform(k_rot, (n,), minval=-90.0, maxval=90.0)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---- the colour stage (K9 and the "xla" backend) ----------------------------

COLOUR_SHAPES = [(4, 16, 16), (2, 32, 8), (8, 8, 32)]  # test_pallas_preprocess.py:30


def _colour_inputs(n, h, w):
    imgs = np.random.default_rng(n * h * w).integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    kj, kb = jax.random.split(KEY)
    return imgs, J.sample_jitter_factors(kj, n), J.sample_blur_weights(kb, n)


@pytest.mark.parametrize("n,h,w", COLOUR_SHAPES)
def test_color_jitter_and_blur_match_jax(n, h, w):
    imgs, jf, bw = _colour_inputs(n, h, w)
    x = J.normalize_image(jnp.asarray(imgs))
    ref_jit = J.apply_color_jitter(x, jf)
    got_jit = A.apply_color_jitter(A.normalize_image(_t(imgs)), _t(jf))
    np.testing.assert_allclose(got_jit.numpy(), np.asarray(ref_jit), rtol=0, atol=COLOUR_ATOL)
    ref = J.apply_gaussian_blur_5x5(ref_jit, bw)
    got = A.apply_gaussian_blur_5x5(_t(ref_jit), _t(bw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=COLOUR_ATOL)


@pytest.mark.parametrize("n,h,w", COLOUR_SHAPES)
def test_preprocess_plain_matches_pallas_kernel_and_xla_stage(n, h, w):
    imgs, jf, bw = _colour_inputs(n, h, w)
    got = P.preprocess_plain(_t(imgs), _t(jf), _t(bw))
    ref = pallas_preprocess(jnp.asarray(imgs), jf, bw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=COLOUR_ATOL)
    xla = A.apply_gaussian_blur_5x5(A.apply_color_jitter(A.normalize_image(_t(imgs)), _t(jf)), _t(bw))
    np.testing.assert_allclose(got.numpy(), xla.numpy(), rtol=0, atol=COLOUR_ATOL)
    before = P.preprocess.launches
    assert torch.equal(P.preprocess(_t(imgs), _t(jf), _t(bw)), got)
    assert P.preprocess.launches == before


def test_preprocess_identity_factors_and_bf16_output():
    imgs, jf, bw = _colour_inputs(4, 16, 16)
    ident = torch.tensor([[1.0, 1.0, 1.0, 0.0]]).repeat(4, 1)
    delta = torch.tensor([[0.0, 0.0, 1.0, 0.0, 0.0]]).repeat(4, 1)
    out = P.preprocess(_t(imgs), ident, delta)
    np.testing.assert_allclose(out.numpy(), imgs / 255.0, rtol=0, atol=COLOUR_ATOL)
    f32 = P.preprocess(_t(imgs), _t(jf), _t(bw))
    bf16 = P.preprocess(_t(imgs), _t(jf), _t(bw), out_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16 and torch.equal(bf16, f32.to(torch.bfloat16))
    with pytest.raises(ValueError, match="h, w >= 3"):
        P.preprocess(_t(imgs)[:, :2], _t(jf), _t(bw))


def test_hsv_branch_selection_is_by_order():
    """The sextant by order comparisons: a round trip returns the pixel
    (the JAX suite's regression pixels, test_pallas_preprocess.py:68)."""
    x = torch.tensor([[[[0.67285, 0.20383, 0.02030], [0.5, 0.499999, 0.01]]]])
    h, s, v = A._rgb_to_hsv(x)
    np.testing.assert_allclose(A._hsv_to_rgb(h, s, v).numpy(), x.numpy(), atol=1e-5)
    jh, js, jv = J._rgb_to_hsv(jnp.asarray(x.numpy()))
    for a, b in ((h, jh), (s, js), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=COLOUR_ATOL)


# ---- the augmentor ----------------------------------------------------------

N, SIZE = 10, 32


def _batch(seed=11):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (N, SIZE, SIZE, 3), dtype=np.uint8),
            rng.integers(0, 3, (N, SIZE, SIZE), dtype=np.uint8))


@pytest.mark.parametrize("backend,geometry", [
    ("xla", "shear3"), ("pallas", "shear3"), ("xla", "gather"), ("xla", "two_pass")])
def test_augmentor_apply_u8_matches_jax(backend, geometry):
    images, masks = _batch()
    key = jax.random.PRNGKey(7)
    ref_i, ref_m = J.DataAugmentor(4, backend=backend, geometry=geometry).apply_u8(
        key, jnp.asarray(images), jnp.asarray(masks))
    got_i, got_m = A.DataAugmentor(4, backend=backend, geometry=geometry).apply_u8(
        _jax_params(key, N), _t(images), _t(masks))
    assert got_m.dtype == torch.int64 and got_i.dtype == torch.float32
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_allclose(got_i.numpy(), np.asarray(ref_i), rtol=0, atol=COLOUR_ATOL)
    # positions 0 and 5 keep their clean values, exactly
    for k in (0, 5):
        assert torch.equal(got_i[k], A.normalize_image(_t(images[k])))
        assert torch.equal(got_m[k], _t(masks[k]).long())
    assert not torch.equal(got_i[1], A.normalize_image(_t(images[1])))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_augmentor_call_matches_jax(backend):
    images, masks = _batch(12)
    x = images.astype(np.float32) / 255.0
    m = masks.astype(np.int32)
    key = jax.random.PRNGKey(8)
    ref_i, ref_m = J.DataAugmentor(4, backend=backend)(key, jnp.asarray(x), jnp.asarray(m))
    got_i, got_m = A.DataAugmentor(4, backend=backend)(_jax_params(key, N), _t(x), _t(m))
    assert got_m.dtype == torch.int32
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_allclose(got_i.numpy(), np.asarray(ref_i), rtol=0, atol=COLOUR_ATOL)
    for k in (0, 5):
        assert torch.equal(got_i[k], _t(x[k])) and torch.equal(got_m[k], _t(m[k]))


def test_apply_u8_equals_call_on_normalized_images():
    images, masks = _batch(13)
    aug = A.DataAugmentor(4)
    params = aug.sample(N, torch.Generator().manual_seed(0))
    ui, um = aug.apply_u8(params, _t(images), _t(masks))
    ci, cm = aug(params, A.normalize_image(_t(images)), _t(masks).long())
    assert torch.equal(um, cm)
    np.testing.assert_allclose(ui.numpy(), ci.numpy(), rtol=0, atol=COLOUR_ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_draws_in_jax_ranges_and_repeats(seed):
    aug = A.DataAugmentor(4, max_degrees=90.0)
    p = aug.sample(256, torch.Generator().manual_seed(seed))
    q = aug.sample(256, torch.Generator().manual_seed(seed))
    for f in dataclasses.fields(p):
        assert torch.equal(getattr(p, f.name), getattr(q, f.name)), f.name
    assert p.flip.dtype == torch.bool and p.flip.shape == (256,) and 0 < int(p.flip.sum()) < 256
    assert p.angles.shape == (256,) and p.angles.dtype == torch.float32
    assert -90.0 <= float(p.angles.min()) and float(p.angles.max()) <= 90.0
    for k, (lo, hi) in enumerate([(0.6, 1.4), (0.7, 1.3), (0.8, 1.2), (-0.2, 0.2)]):
        col = p.jitter[:, k]
        assert lo <= float(col.min()) and float(col.max()) <= hi, k
    assert p.blur.shape == (256, 5) and bool((p.blur >= 0).all())
    np.testing.assert_allclose(p.blur.sum(1).numpy(), 1.0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(p.blur.numpy(), p.blur.flip(1).numpy(), rtol=0, atol=1e-7)
    other = aug.sample(256, torch.Generator().manual_seed(seed + 100))
    assert not torch.equal(p.angles, other.angles)


def test_augmentor_refuses_unknown_options():
    with pytest.raises(ValueError, match="backend"):
        A.DataAugmentor(4, backend="triton")
    with pytest.raises(ValueError, match="geometry"):
        A.DataAugmentor(4, geometry="affine")
