"""The port's Evaluator (image_segmentation_tpu_torch/engine/evaluate.py)
against the JAX package's, on the CPU in fp32.

Model: the ``large_unet`` preset's model args at narrow widths (stem 8,
encoders 16/32/64/128, as tests/test_torch_port_slice.py), one random
parameter tree with running statistics away from the identity on both
sides; JAX runs its Pallas kernels in interpret mode with the kernel
width gate lowered (``IMGSEG_PALLAS_MIN_WP=1``), on a one-device mesh; the
port's kernel blocks run their plain versions.  Data: 6 synthetic 32x32
images at batch 4, so the remainder batch of 2 counts as one batch.

Each point is held to JAX's ``_run_sweep_point`` twice: the model inputs
of every batch, exactly (uint8 for the integer battery; the float
battery within 1e-6), and the mean metrics within rtol = atol = 2e-4, the
forward tolerance of the port (test_torch_port_slice.py; an argmax flip at
a near-tie pixel moves a 4096-pixel batch's accuracy by 2.4e-4 / 2 in the
mean).  The random families get JAX's draws through ``draws``.
"""

import csv
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu.config import preset
from image_segmentation_tpu.data import datasets as jax_datasets
from image_segmentation_tpu.data import perturbations as JP
from image_segmentation_tpu.engine.evaluate import Evaluator as JaxEvaluator
from image_segmentation_tpu.models.unet import LargeUNet as JaxLargeUNet
from image_segmentation_tpu.ops.augment import normalize_image as jax_normalize
from image_segmentation_tpu.parallel import mesh as jax_mesh
from image_segmentation_tpu.utils import io as jax_io
from image_segmentation_tpu_torch.data import perturbations as P
from image_segmentation_tpu_torch.data.datasets import synthetic_dataset
from image_segmentation_tpu_torch.engine.evaluate import Evaluator
from image_segmentation_tpu_torch.models.registry import build_model
from image_segmentation_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_perturbations import jax_draws

jax.config.update("jax_default_matmul_precision", "highest")
METRIC_TOL = dict(rtol=2e-4, atol=2e-4)
FLOAT_TOL = dict(rtol=0, atol=1e-6)
SMALL = dict(stem_features=8, encoder_features=(16, 32, 64, 128))
PRESET = preset("large_unet").model_args
SEED = 42  # both Evaluators' default
BATCH = 4
POINTS = [("clean", None, None),
          ("int", "gaussian_blur", 0), ("int", "gaussian_blur", 3),
          ("int", "contrast_increase", 1.0), ("int", "contrast_increase", 1.05),
          ("int", "salt_pepper_noise", 0.0), ("int", "salt_pepper_noise", 0.18),
          ("float", "gaussian_noise", 1e-6), ("float", "gaussian_noise", 18),
          ("float", "occlusion", 0), ("float", "occlusion", 15)]


def _tree(seed, **model_args):
    shapes = jax.eval_shape(lambda: JaxLargeUNet(dtype=jnp.float32, **SMALL, **model_args).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if "scale" in name or "var" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _port_model(tree, **model_args):
    m = build_model("large_unet", device="cpu", dtype=torch.float32, **SMALL, **model_args)
    m.load_state_dict(state_dict_from_jax(tree["params"], tree["batch_stats"]), strict=True)
    return m


def _jax_draws(kind, name, batch_index, param, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), batch_index)
    return tuple(torch.from_numpy(np.array(d)).long() if d.dtype.kind == "i"
                 else torch.from_numpy(np.array(d))
                 for d in jax_draws(kind, name, param, key=key, shape=shape))


@pytest.fixture(scope="module")
def both():
    """(JAX Evaluator, port Evaluator on JAX's draws, port Evaluator on its
    own sampler, the data) over one tree."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMGSEG_PALLAS_MIN_WP", "1")
        tree = _tree(0, **PRESET)
        data = synthetic_dataset(length=6, height=32, width=32, seed=9)
        jax_data = jax_datasets.synthetic_dataset(length=6, height=32, width=32, seed=9)
        np.testing.assert_array_equal(data.images, jax_data.images)
        jm = JaxLargeUNet(dtype=jnp.float32, **SMALL, **PRESET)
        mesh = jax_mesh.make_mesh(devices=jax.devices()[:1])
        jev = JaxEvaluator(jm, tree, jax_data, batch_size=BATCH, mesh=mesh)
        model = _port_model(tree, **PRESET)
        pev = Evaluator(model, data, batch_size=BATCH, device="cpu", draws=_jax_draws)
        own = Evaluator(model, data, batch_size=BATCH, device="cpu")
        yield dict(jax=jev, port=pev, own=own, data=data)


def _batches(data):
    for i, start in enumerate(range(0, len(data), BATCH)):
        yield i, data.images[start:start + BATCH]


@pytest.mark.parametrize("kind,name,param", POINTS, ids=[f"{k}-{n}-{p}" for k, n, p in POINTS])
def test_point_matches_jax(both, kind, name, param):
    jev, pev = both["jax"], both["port"]
    # the model inputs of every batch
    for i, images in _batches(both["data"]):
        x = torch.from_numpy(images)
        got = pev.perturb(kind, name, x, param, pev.batch_draws(kind, name, i, param, x.shape))
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), i)
        if kind == "clean":
            ref = jax_normalize(jnp.asarray(images))
        elif kind == "int":
            ref = JP.INT_SWEEPS[name]["fn"](key, jnp.asarray(images), jnp.float32(param))
        else:
            ref = JP.FLOAT_SWEEPS[name]["fn"](key, jax_normalize(jnp.asarray(images)),
                                             jnp.float32(param))
        if kind == "int":
            assert got.dtype == torch.uint8
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=f"batch {i}")
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FLOAT_TOL,
                                       err_msg=f"batch {i}")
    # the mean metrics
    ref = jev._run_sweep_point(kind, name, param)
    got = pev._run_sweep_point(kind, name, param)
    np.testing.assert_allclose(got, ref, **METRIC_TOL)
    if kind == "clean":
        assert pev.test() == dict(zip(("iou", "pixel_accuracy", "dice"), got))


@pytest.mark.parametrize("kind,name,params", [
    ("int", "gaussian_noise", [4, 12]), ("int", "occlusion", [0, 15]),
    ("int", "salt_pepper_noise", [0.06, 0.18]), ("float", "salt_pepper", [0.0, 0.1]),
    ("float", "contrast_decrease", [1.0, 0.6])])
def test_family_path_equals_per_point_path(both, kind, name, params):
    """The port's one path, a family's points over one stream of the split
    (a batch's draws shared by the points, occlusion's per point), on
    JAX's draws, against JAX's per-point path, which streams the split once
    for each point."""
    pev = both["port"]
    fam = pev._run_sweep_family(kind, name, params)
    pts = [both["jax"]._run_sweep_point(kind, name, p) for p in params]
    np.testing.assert_allclose(fam, pts, **METRIC_TOL)
    assert pev.family_seconds[(kind, name)] > 0


def test_identity_points_equal_the_clean_split(both):
    own = both["own"]
    clean = own._run_sweep_point("clean", None, None)
    for kind in ("int", "float"):
        for name, info in P.SWEEPS[kind].items():
            if kind == "float" and name == "gaussian_noise":
                continue  # its first point is 1e-6, not 0
            first = own._run_sweep_point(kind, name, info["params"][0])
            np.testing.assert_allclose(first, clean, rtol=0, atol=1e-6, err_msg=f"{kind} {name}")


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_csv_schemas_equal_jax(both, tmp_path):
    """The integer grid's 81-line CSV and the float battery's 8 files: the
    JAX headers, families, grids (as written) and file names; the
    brightness decrease in a file of its own."""
    own = both["own"]
    res = own.robustness_evaluation(str(tmp_path / "results" / "robustness_scores.csv"))
    rows = _read(tmp_path / "results" / "robustness_scores.csv")
    assert len(rows) == 81 and rows[0] == jax_io.ROBUSTNESS_CSV_HEADER
    want = [(n, str(p)) for n, info in JP.INT_SWEEPS.items() for p in info["params"]]
    assert [(r[0], r[1]) for r in rows[1:]] == want
    for r in rows[1:]:
        assert len(r[2].split(".")[1]) == 4 and 0.0 <= float(r[2]) <= 1.0
    assert list(res) == list(JP.INT_SWEEPS)
    out = tmp_path / "augmentation-results"
    fres = own.test_robustness(str(out))
    assert sorted(os.listdir(out)) == sorted(f"{n}.csv" for n in JP.FLOAT_SWEEPS)
    for name, info in JP.FLOAT_SWEEPS.items():
        rows = _read(out / f"{name}.csv")
        assert rows[0] == jax_io.AUGMENTATION_CSV_HEADER
        assert [r[0] for r in rows[1:]] == [str(p) for p in info["params"]]
        assert all(0.0 <= float(v) <= 1.0 for r in rows[1:] for v in r[1:])
    assert _read(out / "brightness_increase.csv") != _read(out / "brightness_decrease.csv")
    assert len(fres) == 8


def test_binary_picks_the_binary_metrics():
    """A one-logit model with binary masks: ``binary=True`` gives JAX's
    binary metrics (standard model args, the plain forward)."""
    tree = _tree(1, out_channels=1)
    data = synthetic_dataset(length=6, height=32, width=32, num_classes=2, seed=4)
    jax_data = jax_datasets.synthetic_dataset(length=6, height=32, width=32, num_classes=2,
                                              seed=4)
    jm = JaxLargeUNet(dtype=jnp.float32, out_channels=1, **SMALL)
    mesh = jax_mesh.make_mesh(devices=jax.devices()[:1])
    ref = JaxEvaluator(jm, tree, jax_data, batch_size=BATCH, binary=True, mesh=mesh).test()
    model = _port_model(tree, out_channels=1)
    got = Evaluator(model, data, batch_size=BATCH, binary=True, device="cpu").test()
    np.testing.assert_allclose([got[k] for k in ref], list(ref.values()), **METRIC_TOL)


def test_wrong_device_and_prompt_models_raise(both):
    model, data = both["own"].model, both["data"]
    with pytest.raises(ValueError, match="not on cuda"):
        Evaluator(model, data, device="cuda")
    fusion = build_model("prompt_fusion", device="cpu", dtype=torch.float32)
    with pytest.raises(TypeError, match="second input"):
        Evaluator(fusion, data, device="cpu")
