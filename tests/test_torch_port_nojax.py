"""The port imports no jax: a fresh interpreter imports every module of
image_segmentation_tpu_torch (config, entry, cli.*, data.*, engine.*,
models.*, ops.*, parallel.*, utils.*) and chip_smoke.py, runs a tiny CPU
forward and an augmented train step of the preset model through the
wrappers, the augmentor and the Trainer, saves and restores that Trainer's checkpoint,
runs two points of the robustness battery through the Evaluator, an
augmented prompt train step of a small clip_unet_prompt (the prompt
preset's model args, a small CLIP tower) and a reconstruction step of the
autoencoder on its unfused blocks, the world-size-1 collectives, the Pet
loader's npz route, the native loader, an exported program and the
memory report, and finds no module of jax, flax or the JAX package
(image_segmentation_tpu) loaded."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = """
import importlib, pkgutil, sys
import torch
import image_segmentation_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
import chip_smoke
from image_segmentation_tpu_torch import config
from image_segmentation_tpu_torch.data import datasets, pipeline
from image_segmentation_tpu_torch.engine import train
from image_segmentation_tpu_torch.models.registry import build_model
from image_segmentation_tpu_torch.ops import losses
args = chip_smoke.train_config().model_args
m = build_model("large_unet", device="cpu", dtype=torch.float32,
                stem_features=4, encoder_features=(8, 8, 8, 8), **args).eval()
with torch.no_grad():
    out = m(torch.zeros((1, 32, 32, 3)))
assert out.shape == (1, 32, 32, 3), out.shape
cfg = config.TrainConfig(model="large_unet", bf16=False, batch_size=2,
                         model_args=dict(args, stem_features=4, encoder_features=(8, 8, 8, 8)),
                         data=config.DataConfig(dataset="synthetic", synthetic_length=2,
                                                image_size=32, augmentations_per_datapoint=1))
t = train.Trainer(cfg, device="cpu", make_artifacts=False)
assert t.augmentor is not None
images, masks = next(pipeline.BatchPipeline(t.train_data, 2, device="cpu").epoch(0))
assert float(t.train_step(images, masks, step_key=3)) > 0
import tempfile
from image_segmentation_tpu_torch.engine import evaluate
with tempfile.TemporaryDirectory() as tmp:
    t.save(tmp + "/model_1.npz")
    t.restore(tmp + "/model_1.npz")
ev = evaluate.Evaluator(t.model, t.val_data, batch_size=2, device="cpu")
for kind, name, p in (("int", "salt_pepper_noise", 0.1), ("float", "occlusion", 5)):
    assert 0 <= ev._run_sweep_family(kind, name, [p])[0][2] <= 1
pcfg = config.preset("prompt")
pcfg = config.TrainConfig(
    model="clip_unet_prompt", loss=pcfg.loss, bf16=False, batch_size=2,
    model_args=dict(pcfg.model_args, clip_kwargs=dict(hidden=32, layers=1, heads=2, mlp_dim=64,
                                                      patch=32, proj_dim=32)),
    data=config.DataConfig(dataset="synthetic", synthetic_length=2, image_size=32,
                           augmentations_per_datapoint=1))
pt = train.Trainer(pcfg, device="cpu", make_artifacts=False)
assert pt.task == "prompt"
train_pipe, _ = pt._pipelines()
images, raw = next(train_pipe.epoch(0))
assert float(pt.train_step(images, raw, step_key=3)) > 0
acfg = config.preset("autoencoder")
acfg = config.TrainConfig(
    model="autoencoder", loss=acfg.loss, bf16=False, batch_size=2,
    model_args=dict(acfg.model_args, w2d_impl="pallas"),
    data=config.DataConfig(dataset="synthetic", synthetic_length=2, image_size=32))
at = train.Trainer(acfg, device="cpu", make_artifacts=False)
assert at.task == "reconstruction"
images, masks = next(pipeline.BatchPipeline(at.train_data, 2, device="cpu").epoch(0))
assert float(at.train_step(images, masks, step_key=3)) > 0
from image_segmentation_tpu_torch import entry
from image_segmentation_tpu_torch.cli import export_torch, profiler, train_distributed
from image_segmentation_tpu_torch.data import datasets, host_augment, native_loader, records
from image_segmentation_tpu_torch.engine import export
from image_segmentation_tpu_torch.parallel import mesh
from image_segmentation_tpu_torch.utils import profiling
assert mesh.world_size() == 1 and mesh.is_main() and not mesh.active()
assert mesh.average_gradients([]) is None and float(mesh.global_mean(torch.ones(3))) == 1.0
shapes = datasets.synthetic_shapes_dataset(4, 32, 32)
assert records.remap_mask_batch(shapes.masks.astype("uint8") * 38).max() <= 2
with tempfile.TemporaryDirectory() as tmp:
    import numpy as np
    np.savez(tmp + "/test_arrays.npz", images=shapes.images, masks=shapes.masks)
    pet = datasets.load_pet_dataset("test", tmp)
    assert np.array_equal(pet.images, shapes.images)
    if native_loader.native_loader_available():
        nat = native_loader.NativeBatchPipeline(pet, 2, device="cpu", shuffle=False)
        assert len(list(nat.epoch(0))) == 2
    export.export_model(m, "large_unet", dict(args, stem_features=4, encoder_features=(8, 8, 8, 8)),
                        out_dir=tmp, exported_program=True, torch_format=True, image_size=32)
    with torch.no_grad():
        assert torch.equal(export.load_program(tmp + "/model.pt2")(torch.zeros((2, 32, 32, 3))),
                           m(torch.zeros((2, 32, 32, 3))))
assert profiling.format_memory_report() == "no device memory stats available"
jax_mods = sorted(k for k in sys.modules if k.split(".")[0] in
                  ("jax", "jaxlib", "flax", "image_segmentation_tpu"))
assert not jax_mods, jax_mods
print("ok")
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
