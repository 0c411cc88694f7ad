"""The port's robustness battery (image_segmentation_tpu_torch/data/
perturbations.py) against the JAX package's, on the CPU, with no model.

One uint8 batch (3, 37, 29, 3) from a numpy seed (odd sizes reach the
edges of the blur, the squares and the salt-and-pepper positions).  Every
family is applied at every point of its grid, the parameter passed as the
JAX Evaluator passes it (``jnp.float32(param)``, engine/evaluate.py:159).
The random families' applying halves get JAX's own draws, made here with
the ``jax.random`` calls of each JAX function on its key.  The integer
battery must be uint8-equal; the float battery within 1e-6 (float32 ops
in the same order; the tolerance covers one rounding of XLA's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu.data import perturbations as JP
from image_segmentation_tpu_torch.data import perturbations as P

FLOAT_TOL = dict(rtol=0, atol=1e-6)
SHAPE = (3, 37, 29, 3)
U8 = np.random.default_rng(5).integers(0, 256, SHAPE, dtype=np.uint8)
F32 = U8.astype(np.float32) / np.float32(255.0)
KEY = jax.random.fold_in(jax.random.PRNGKey(42), 3)  # the Evaluator's key of batch 3

INT_DETERMINISTIC = ["gaussian_blur", "contrast_increase", "contrast_decrease",
                     "brightness_increase", "brightness_decrease"]
FLOAT_DETERMINISTIC = ["blur", "contrast_increase", "contrast_decrease",
                       "brightness_increase", "brightness_decrease"]


def jax_draws(kind, name, param, key=KEY, shape=SHAPE):
    """The draws the JAX function of (kind, name) makes from ``key`` at
    ``param``, as numpy arrays in the port's order."""
    n, h, w, _ = shape
    if name == "gaussian_noise":
        return (np.asarray(jax.random.normal(key, shape, jnp.float32)),)
    if name == "occlusion":
        size = int(np.round(np.float32(param)))
        ky, kx = jax.random.split(key)
        if kind == "int":
            hi_y, hi_x = max(h - size + 1, 1), max(w - size + 1, 1)
        else:
            hi_y, hi_x = max(h - size, 0) + 1, max(w - size, 0) + 1
        return (np.asarray(jax.random.randint(ky, (n,), 0, hi_y)),
                np.asarray(jax.random.randint(kx, (n,), 0, hi_x)))
    if name == "salt_pepper_noise":
        m = int(round(float(max(JP._INT_SP_PARAMS)) * h * w))
        kpos, kval = jax.random.split(key)
        return (np.asarray(jax.random.randint(kpos, (n, m), 0, h * w)),
                np.asarray(jax.random.bernoulli(kval, 0.5, (n, m))))
    if name == "salt_pepper":
        return (np.asarray(jax.random.uniform(key, (n, 1, h, w))),)
    raise KeyError(name)


def to_torch(draws):
    return tuple(torch.from_numpy(np.array(d)).long() if d.dtype.kind == "i"
                 else torch.from_numpy(np.array(d)) for d in draws)


def jax_out(kind, name, images, param):
    info = (JP.INT_SWEEPS if kind == "int" else JP.FLOAT_SWEEPS)[name]
    return np.asarray(info["fn"](KEY, jnp.asarray(images), jnp.float32(param)))


@pytest.mark.parametrize("kind", ["int", "float"])
def test_grids_equal_jax(kind):
    """Same families in the same order, same grids, the same Python values
    (their reprs go into the CSVs)."""
    port, ref = P.SWEEPS[kind], (JP.INT_SWEEPS if kind == "int" else JP.FLOAT_SWEEPS)
    assert list(port) == list(ref)
    for name in ref:
        assert port[name]["params"] == ref[name]["params"], name
        assert [repr(p) for p in port[name]["params"]] == [repr(p) for p in ref[name]["params"]]
        assert port[name]["random"] == ref[name]["random"], name


@pytest.mark.parametrize("name", INT_DETERMINISTIC)
def test_int_deterministic_families_equal_jax(name):
    for param in P.INT_SWEEPS[name]["params"]:
        got = P.apply("int", name, torch.from_numpy(U8), param, None).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_out("int", name, U8, param), err_msg=f"{name} {param}")


def test_contrast_rounds_the_factor_to_float32_first():
    """30 * float32(1.05) = 31.499998 rounds to 31; in float64 30 * 1.05 =
    31.5 rounds half to even to 32."""
    img = np.full((1, 2, 2, 3), 30, np.uint8)
    got = P.contrast_scale(torch.from_numpy(img), 1.05).numpy()
    assert (got == 31).all()
    np.testing.assert_array_equal(got, np.asarray(JP.contrast_scale(jnp.asarray(img),
                                                                    jnp.float32(1.05))))
    assert round(30 * 1.05) == 32


@pytest.mark.parametrize("name", ["gaussian_noise", "occlusion", "salt_pepper_noise"])
def test_int_random_families_on_jax_draws_equal_jax(name):
    for param in P.INT_SWEEPS[name]["params"]:
        draws = to_torch(jax_draws("int", name, param))
        got = P.apply("int", name, torch.from_numpy(U8), param, draws).numpy()
        np.testing.assert_array_equal(got, jax_out("int", name, U8, param), err_msg=f"{name} {param}")


@pytest.mark.parametrize("name", FLOAT_DETERMINISTIC)
def test_float_deterministic_families_equal_jax(name):
    for param in P.FLOAT_SWEEPS[name]["params"]:
        got = P.apply("float", name, torch.from_numpy(F32), param, None).numpy()
        np.testing.assert_allclose(got, jax_out("float", name, F32, param), **FLOAT_TOL,
                                   err_msg=f"{name} {param}")


@pytest.mark.parametrize("name", ["gaussian_noise", "occlusion", "salt_pepper"])
def test_float_random_families_on_jax_draws_equal_jax(name):
    for param in P.FLOAT_SWEEPS[name]["params"]:
        draws = to_torch(jax_draws("float", name, param))
        got = P.apply("float", name, torch.from_numpy(F32), param, draws).numpy()
        np.testing.assert_allclose(got, jax_out("float", name, F32, param), **FLOAT_TOL,
                                   err_msg=f"{name} {param}")


def _sequential_salt_pepper(images, amount, pos, salt):
    """The reference's loop: the live draws applied one after another."""
    out = images.copy()
    n, h, w, _ = images.shape
    num = int(np.round(np.float32(amount) * np.float32(h * w)))
    for i in range(n):
        for d in range(num):
            y, x = divmod(int(pos[i, d]), w)
            out[i, y, x, :] = 255 if salt[i, d] else 0
    return out


def test_salt_pepper_last_draw_wins():
    img = np.full((1, 4, 4, 3), 100, np.uint8)
    pos = torch.tensor([[5, 5, 7, 5, 9]])
    salt = torch.tensor([[True, False, True, True, True]])
    amount = 3 / 16  # 3 live draws: pixel 5 twice (pepper wins), pixel 7 salt
    got = P.salt_pepper_draws(torch.from_numpy(img), amount, pos, salt).numpy()
    assert (got[0, 1, 1] == 0).all() and (got[0, 1, 3] == 255).all()
    assert (got[0, 2, 1] == 100).all()  # the dead draw 4 at pixel 9 is not applied
    np.testing.assert_array_equal(got, _sequential_salt_pepper(img, amount, pos.numpy(),
                                                               salt.numpy()))
    # many repeats: every pixel of a 3x3 image drawn ~20 times
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (2, 3, 3, 3), dtype=np.uint8)
    pos = torch.from_numpy(rng.integers(0, 9, (2, 200)))
    salt = torch.from_numpy(rng.random((2, 200)) < 0.5)
    for amount in (0.0, 1.0, 17.0, 200 / 9):
        got = P.salt_pepper_draws(torch.from_numpy(img), amount, pos, salt).numpy()
        np.testing.assert_array_equal(got, _sequential_salt_pepper(img, amount, pos.numpy(),
                                                                   salt.numpy()))


@pytest.mark.parametrize("size", [29, 30, 37, 45])
def test_int_occlusion_that_does_not_fit_does_nothing(size):
    """A square of side >= H (37) or W (29) is skipped in the integer
    battery, as the reference skips it."""
    y0, x0 = P.sample_occlusion(SHAPE, size, torch.Generator().manual_seed(0))
    images = torch.from_numpy(U8)
    assert torch.equal(P.occlusion(images, size, y0, x0), images)
    assert not torch.equal(P.float_occlusion(torch.from_numpy(F32), size, y0, x0),
                           torch.from_numpy(F32))


def test_amount_zero_and_size_zero_are_identities():
    g = torch.Generator().manual_seed(0)
    images, floats = torch.from_numpy(U8), torch.from_numpy(F32)
    assert torch.equal(P.apply("int", "salt_pepper_noise", images, 0.0,
                               P.sample("int", "salt_pepper_noise", SHAPE, 0.0, g)), images)
    assert torch.equal(P.apply("float", "salt_pepper", floats, 0.0,
                               P.sample("float", "salt_pepper", SHAPE, 0.0, g)), floats)
    for kind, x in (("int", images), ("float", floats)):
        assert torch.equal(P.apply(kind, "occlusion", x, 0,
                                   P.sample(kind, "occlusion", SHAPE, 0, g)), x)


def test_samplers_shapes_bounds_and_draw_count():
    n, h, w, _ = SHAPE
    g = torch.Generator().manual_seed(3)
    (z,) = P.sample("int", "gaussian_noise", SHAPE, 4, g)
    assert z.shape == SHAPE and z.dtype == torch.float32
    for size in (0, 5, 20, 29, 40):
        y0, x0 = P.sample("int", "occlusion", SHAPE, size, g)
        assert y0.shape == x0.shape == (n,)
        assert 0 <= int(y0.min()) and int(y0.max()) < max(h - size + 1, 1)
        assert 0 <= int(x0.min()) and int(x0.max()) < max(w - size + 1, 1)
    pos, salt = P.sample("int", "salt_pepper_noise", SHAPE, 0.02, g)
    m = int(round(0.18 * h * w))
    assert P.salt_pepper_max_draws(h, w, 0.18) == m == 193
    assert pos.shape == salt.shape == (n, m) and salt.dtype == torch.bool
    assert 0 <= int(pos.min()) and int(pos.max()) < h * w
    (u,) = P.sample("float", "salt_pepper", SHAPE, 0.1, g)
    assert u.shape == (n, 1, h, w) and 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert P.sample("int", "gaussian_blur", SHAPE, 3, g) is None
    # one seed, one draw
    a = P.sample("int", "salt_pepper_noise", SHAPE, 0.1, torch.Generator().manual_seed(9))
    b = P.sample("int", "salt_pepper_noise", SHAPE, 0.1, torch.Generator().manual_seed(9))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_apply_perturbation_dispatch():
    images = torch.from_numpy(U8)
    out = P.apply_perturbation("gaussian_noise", images, 10.0)
    assert out.dtype == torch.uint8 and out.shape == images.shape and not torch.equal(out, images)
    again = P.apply_perturbation("gaussian_noise", images, 10.0)
    assert torch.equal(out, again)
    assert torch.equal(P.apply_perturbation("brightness_increase", images, 0), images)
