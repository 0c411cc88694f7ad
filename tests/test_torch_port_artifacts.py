"""The port's run artifacts and checkpoints (utils/io.py, utils/checkpoint.py,
``Trainer(make_artifacts=True)``, ``Trainer.restore``), its plotting and
its three CLIs, against the JAX package's on the CPU in fp32.

One configuration for both Trainers: LargeUNet at narrow widths (stem 8,
encoders 16/32/64/128, the standard model args, so the JAX train step
compiles without the interpret-mode kernels), 32x32 synthetic images,
batch 8, 16 images a split, no augmentation, ``bf16=False``, Adam's eps
1e-3 (as tests/test_torch_port_train.py, for the same reason), one save
dir.  Each Trainer writes its run folder at construction; the port's
starts from the JAX Trainer's initial tree; both train one epoch (2 steps
and an evaluation), which writes ``loss.csv``'s row and ``model_1.npz``.

Tolerances are tests/test_torch_port_train.py's: losses rtol 5e-4, atol
5e-5; the state after the steps rtol 5e-4, atol 1e-3 (its standard
configuration: the JAX Trainer's fp32 gradient on the CPU is itself up to
9 % off float64 there); eval metrics rtol = atol = 2e-4.  What a file
holds by conversion alone (restored state, keys, shapes, the count and
step) must be exact.
"""

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu import config as jax_config
from image_segmentation_tpu.engine.train import Trainer as JaxTrainer
from image_segmentation_tpu.utils import checkpoint as jax_ckpt
from image_segmentation_tpu.utils import plotting as jax_plotting
from image_segmentation_tpu_torch import config as port_config
from image_segmentation_tpu_torch.engine.train import Trainer, jax_param_count
from image_segmentation_tpu_torch.models.registry import MODEL_NAMES, build_model
from image_segmentation_tpu_torch.utils import checkpoint as ckpt
from image_segmentation_tpu_torch.utils import plotting
from image_segmentation_tpu_torch.utils.convert import (
    jax_from_state_dict,
    leaves,
    state_dict_from_jax,
)

jax.config.update("jax_default_matmul_precision", "highest")
REPO = Path(__file__).resolve().parents[1]
LOSS_TOL = dict(rtol=5e-4, atol=5e-5)
STATE_TOL = dict(rtol=5e-4, atol=1e-3)
METRIC_TOL = dict(rtol=2e-4, atol=2e-4)
SMALL = dict(stem_features=8, encoder_features=(16, 32, 64, 128))
BATCH = 8
SMALL_TOWER = dict(hidden=32, layers=1, heads=2, mlp_dim=64, patch=32, proj_dim=32)


def _cfg(pkg, save_dir, model="large_unet", model_args=SMALL, aug=0):
    return pkg.TrainConfig(
        model=model, model_args=dict(model_args), batch_size=BATCH, num_epochs=1, bf16=False,
        seed=0, save_dir=save_dir, optimizer=pkg.OptimizerConfig(eps=1e-3),
        data=pkg.DataConfig(dataset="synthetic", synthetic_length=2 * BATCH, image_size=32,
                            augmentations_per_datapoint=aug))


def _batches(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (BATCH, 32, 32, 3), dtype=np.uint8),
             rng.integers(0, 3, (BATCH, 32, 32)).astype(np.uint8)) for _ in range(n)]


def _flat(tree):
    return {"/".join(p): np.asarray(v) for p, v in leaves(tree)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    save_dir = str(tmp_path_factory.mktemp("runs"))
    jt = JaxTrainer(_cfg(jax_config, save_dir))
    state0 = jax.device_get(jt.state)
    pt = Trainer(_cfg(port_config, save_dir), device="cpu")
    pt.model.load_state_dict(state_dict_from_jax(state0["params"], state0["batch_stats"]))
    jax_hist = jt.train(1)["history"]
    port_hist = pt.train(1)["history"]
    template = jax.device_get(jt.state)

    # a fresh port Trainer resumes from the JAX checkpoint; both go on for 2 steps
    resumed = Trainer(_cfg(port_config, save_dir), device="cpu", make_artifacts=False)
    jax_file = os.path.join(jt.run_dir, "model_1.npz")
    resumed.restore(jax_file)
    restored = _flat(resumed.state_tree())
    jax_losses, port_losses = [], []
    for images, masks in _batches(3, 2):
        jt.state, loss = jt._train_step(jt.state, jnp.asarray(images), jnp.asarray(masks),
                                        jax.random.PRNGKey(0))
        jax_losses.append(float(loss))
        port_losses.append(float(resumed.train_step(torch.from_numpy(images),
                                                    torch.from_numpy(masks))))
    return dict(jax=jt, port=pt, jax_hist=jax_hist, port_hist=port_hist, template=template,
                jax_file=jax_file, port_file=os.path.join(pt.run_dir, "model_1.npz"),
                restored=restored, jax_losses=jax_losses, port_losses=port_losses,
                resumed=resumed)


def test_run_folders_and_files(runs):
    jt, pt = runs["jax"], runs["port"]
    assert os.path.dirname(jt.run_dir.rstrip("/")) == os.path.dirname(pt.run_dir.rstrip("/"))
    assert {os.path.basename(d.rstrip("/")) for d in (jt.run_dir, pt.run_dir)} == {"run-001",
                                                                                   "run-002"}
    for d in (jt.run_dir, pt.run_dir):
        assert sorted(os.listdir(d)) == ["loss.csv", "model_1.npz", "model_settings.json"]
    assert pt.model_name == "LargeUNet" and pt.run_dir.rstrip("/").endswith("LargeUNet/run-002")


def test_loss_csv_equals_jax(runs):
    def rows(d):
        with open(os.path.join(d, "loss.csv"), newline="") as f:
            return list(csv.reader(f))

    ref, got = rows(runs["jax"].run_dir), rows(runs["port"].run_dir)
    assert got[0] == ref[0] and len(got) == len(ref) == 2 and got[1][0] == ref[1][0] == "0"
    ref_v, got_v = np.array(ref[1][1:], float), np.array(got[1][1:], float)
    np.testing.assert_allclose(got_v[:2], ref_v[:2], **LOSS_TOL)  # train and validation loss
    np.testing.assert_allclose(got_v[2:], ref_v[2:], **METRIC_TOL)  # accuracy, dice, IoU


def test_model_settings_equal_jax(runs):
    def load(d):
        with open(os.path.join(d, "model_settings.json")) as f:
            return json.load(f)

    ref, got = load(runs["jax"].run_dir), load(runs["port"].run_dir)
    assert got == ref
    assert got["num_params"] == runs["port"].num_params and len(got["layers"]) > 30


def test_jax_checkpoint_restores_exactly(runs):
    ref = jax_ckpt.load_checkpoint_flat(runs["jax_file"])
    got = runs["restored"]
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert int(ref["step"]) == 2 and runs["resumed"].step == 4  # 2 restored + 2 taken


def test_steps_after_restore_match_jax(runs):
    np.testing.assert_allclose(runs["port_losses"], runs["jax_losses"], **LOSS_TOL)


def test_port_checkpoint_loads_in_jax(runs):
    """The port's file restores with JAX's ``restore_into`` (strict: every
    key of the JAX state, its shape), holds no other key, and its values
    are the JAX Trainer's after the same epoch."""
    template = runs["template"]
    restored = jax_ckpt.restore_into(template, runs["port_file"])
    port = jax_ckpt.load_checkpoint_flat(runs["port_file"])
    flat_restored = jax_ckpt._flatten(restored)
    assert sorted(flat_restored) == sorted(port)
    for k, v in flat_restored.items():
        np.testing.assert_array_equal(v, port[k].astype(v.dtype), err_msg=k)
    ref = jax_ckpt._flatten(template)
    for k, v in ref.items():
        assert port[k].shape == v.shape and port[k].dtype == v.dtype, k
        if k.endswith(("count",)) or k == "step":
            assert int(port[k]) == int(v) == 2, k
        elif "/nu/" not in k:  # nu is ~g^2 (1e-10 here): no useful relative check
            np.testing.assert_allclose(port[k], v, **STATE_TOL, err_msg=k)


def test_frozen_model_key_set_equals_jax(tmp_path):
    """clip_unet (the frozen CLIP tower: JAX's multi_transform nesting) with
    the small tower, init only: the same keys, shapes and dtypes."""
    args = dict(jax_config.preset("clip_unet").model_args, clip_kwargs=SMALL_TOWER)
    jt = JaxTrainer(_cfg(jax_config, str(tmp_path), "clip_unet", args), make_artifacts=False)
    ref = jax_ckpt._flatten(jax.device_get(jt.state))
    pt = Trainer(_cfg(port_config, str(tmp_path), "clip_unet", args), device="cpu",
                 make_artifacts=False)
    assert pt.frozen and pt.num_params == jt.num_params
    got = _flat(pt.state_tree())
    assert sorted(got) == sorted(ref)
    assert any(k.startswith("opt_state/inner_states/train/inner_state/1/mu/") for k in got)
    assert not any("clip_tower" in k for k in got if k.startswith("opt_state"))
    for k, v in ref.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    # and a fresh Trainer restores the port's file of it
    path = str(tmp_path / "clip_unet.npz")
    pt.save(path)
    Trainer(_cfg(port_config, str(tmp_path), "clip_unet", args), device="cpu",
            make_artifacts=False).restore(path)


@pytest.mark.parametrize("at", ["epoch_end", "mid_epoch"])
def test_training_goes_on_after_restore_as_if_it_had_not_stopped(tmp_path, at):
    """train(2) against train(1) (and, mid-epoch, the next epoch's first 2
    steps, as train() takes them), a checkpoint, and a fresh Trainer that
    restores it and trains one more epoch: the same state bit for bit, the
    same last train loss at an epoch's end, and the checkpoint numbered on
    (augmented, 4 steps an epoch, so the shuffle and the draws count)."""
    cfg = _cfg(port_config, str(tmp_path), aug=1)
    whole = Trainer(cfg, device="cpu")
    hist = whole.train(2)["history"]
    part = Trainer(cfg, device="cpu")
    part.train(1)
    path = os.path.join(part.run_dir, "model_1.npz")
    if at == "mid_epoch":
        for n, (images, masks) in zip(range(2), part._pipelines()[0].epoch(1)):
            part.train_step(images, masks, 100003 + n)
        path = str(tmp_path / "mid.npz")
        part.save(path)
    resumed = Trainer(cfg, device="cpu")
    resumed.restore(path)
    assert (resumed.epoch, resumed.batch) == ((1, 2) if at == "mid_epoch" else (1, 0))
    got = resumed.train(1)["history"]
    assert [r["epoch"] for r in hist] == [0, 1] and [r["epoch"] for r in got] == [1]
    assert resumed.step == whole.step == 8 and (resumed.epoch, resumed.batch) == (2, 0)
    ref = _flat(whole.state_tree())
    state = _flat(resumed.state_tree())
    assert sorted(state) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(state[k], ref[k], err_msg=k)
    if at == "epoch_end":
        assert got[0]["train_loss"] == hist[1]["train_loss"]
        assert {k: v for k, v in got[0].items() if k.startswith("val_")} == {
            k: v for k, v in hist[1].items() if k.startswith("val_")}
    assert sorted(os.listdir(resumed.run_dir)) == ["loss.csv", "model_2.npz",
                                                   "model_settings.json"]


def _count_args(name):
    if name.startswith("clip"):
        return dict(clip_kwargs=SMALL_TOWER)
    return {"unet": dict(stem_features=8, encoder_features=(16, 32)),
            "large_unet": SMALL}.get(name, {})


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_num_params_counts_the_jax_tree(name):
    """``jax_param_count`` (the Trainer's ``num_params``, written to
    ``model_settings.json``) counts the leaves of the JAX tree that
    ``jax_from_state_dict`` gives, for every registry model."""
    model = build_model(name, device="cpu", dtype=torch.float32, **_count_args(name))
    params = jax_from_state_dict(model.state_dict())[0]
    assert jax_param_count(model) == sum(int(np.prod(v.shape)) for _, v in leaves(params))


def test_restore_is_strict_and_latest_checkpoint(runs, tmp_path):
    flat = jax_ckpt.load_checkpoint_flat(runs["port_file"])
    missing = dict(flat)
    missing.pop("params/out/kernel")
    np.savez(tmp_path / "missing.npz", **missing)
    t = Trainer(_cfg(port_config, str(tmp_path)), device="cpu", make_artifacts=False)
    with pytest.raises(KeyError, match="params/out/kernel"):
        t.restore(str(tmp_path / "missing.npz"))
    wrong = dict(flat)
    wrong["params/out/bias"] = np.zeros(7, np.float32)
    np.savez(tmp_path / "wrong.npz", **wrong)
    with pytest.raises(ValueError, match="shape mismatch"):
        t.restore(str(tmp_path / "wrong.npz"))
    for e in (1, 10, 2):
        ckpt.save_checkpoint(str(tmp_path / "run" / f"model_{e}.npz"), {"step": np.int32(e)})
    assert ckpt.latest_checkpoint(str(tmp_path / "run")).endswith("model_10.npz")
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None


def _cli(module, *args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-m", f"image_segmentation_tpu_torch.cli.{module}",
                          *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_clis_end_to_end_on_the_cpu(tmp_path):
    """train -> evaluate (both batteries and the plot) -> plot_results, each
    with ``--device cpu`` on the ``smoke`` preset."""
    out = _cli("train", "--preset", "smoke", "--save-dir", "runs", "--seed", "3",
               "--device", "cpu", cwd=tmp_path)
    assert "done:" in out and "val_iou=" in out
    run_dir = tmp_path / "runs" / "UNet" / "run-001"
    assert sorted(os.listdir(run_dir)) == ["loss.csv", "model_1.npz", "model_settings.json"]
    ckpt_path = str(run_dir / "model_1.npz")
    out = _cli("train", "--preset", "smoke", "--save-dir", "runs", "--seed", "3",
               "--resume", ckpt_path, "--device", "cpu", cwd=tmp_path)
    resumed = tmp_path / "runs" / "UNet" / "run-002"
    assert sorted(os.listdir(resumed)) == ["loss.csv", "model_2.npz", "model_settings.json"]
    assert (resumed / "loss.csv").read_text().splitlines()[1].startswith("1,")
    out = _cli("evaluate", "--preset", "smoke", "--ckpt", ckpt_path, "--robustness-int",
               "--robustness", "--plot", "--out-dir", "ev", "--device", "cpu", cwd=tmp_path)
    assert "clean:" in out
    rows = (tmp_path / "ev" / "results" / "robustness_scores.csv").read_text().splitlines()
    assert rows[0] == "perturbation_type,param_value,mean_dice" and len(rows) == 81
    assert len(os.listdir(tmp_path / "ev" / "augmentation-results")) == 8
    assert (tmp_path / "ev" / "results" / "predictions.png").stat().st_size > 0
    out = _cli("plot_results", "loss", str(run_dir / "loss.csv"), "--out", "pl/loss.png",
               cwd=tmp_path)
    out += _cli("plot_results", "robustness", "ev/results/robustness_scores.csv", "--out-dir",
                "pl", cwd=tmp_path)
    out += _cli("plot_results", "perturbations", "--name", "occlusion", "--param", "15",
                "--out", "pl/p.png", "--device", "cpu", cwd=tmp_path)
    assert len(out.split()) == 10 and all((tmp_path / p).exists() for p in out.split())


def test_plot_robustness_scores_writes_jax_file_names(tmp_path):
    path = tmp_path / "scores.csv"
    rows = ["perturbation_type,param_value,mean_dice"] + [
        f"{n},{p},0.5000" for n in ("gaussian_noise", "occlusion") for p in (0, 5)]
    path.write_text("\n".join(rows) + "\n")
    got = plotting.plot_robustness_scores(str(path), str(tmp_path / "port"))
    ref = jax_plotting.plot_robustness_scores(str(path), str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref]
    assert all(os.path.getsize(p) > 0 for p in got)


def test_plot_without_matplotlib_raises_a_clear_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="needs matplotlib"):
        plotting.require_matplotlib()
