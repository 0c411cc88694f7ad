"""Whole runs of each cell on the CPU at small size: the result line's
schema, discovery by name, the reference against the program, and the
faults and the control that ``correct`` has to catch."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from benchmark import harness as H
from benchmark import plain as P
from benchmark.tests.small import small_cell

CELLS = tuple(w["name"] for w in json.loads((H.ROOT / "BENCHMARK.json").read_text())[
    "workloads"])
SEED = 2 ** 31 + 97


def run(cell, trace: bool = False, seconds: float = 0.3) -> dict:
    return H.run_cell(cell, SEED, seconds, trace, "cpu", t_start=0.0, log=lambda m: None)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_result_line(name, trace):
    cell = small_cell(name)
    line = run(cell, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["checks"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    wanted = {m["name"]: m["unit"] for m in cell.metrics(trace)}
    assert set(line["metrics"]) <= set(wanted)
    for k, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == wanted[k]
        assert isinstance(m["value"], float)
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev) and dev["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    json.dumps(line)


def test_parts_are_found_by_name(tmp_path):
    """A new traffic mix, a new metric and a moved configuration file are
    picked up from the files and entries alone."""
    shutil.copytree(H.BENCH / "configs", tmp_path / "benchmark" / "configs")
    shutil.copytree(H.BENCH / "traffic", tmp_path / "benchmark" / "traffic")
    shutil.copytree(H.BENCH / "metrics", tmp_path / "benchmark" / "metrics")
    shutil.copytree(H.BENCH / "limits", tmp_path / "benchmark" / "limits")
    spec = json.loads((H.ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "benchmark" / "configs" / "moved.json").write_text(
        (H.BENCH / "configs" / "large_unet.json").read_text())
    spec["configs"][0]["file"] = "benchmark/configs/moved.json"
    traffic = json.loads((H.BENCH / "traffic" / "train.json").read_text())
    (tmp_path / "benchmark" / "traffic" / "train_one.json").write_text(
        json.dumps(dict(traffic, trace_steps=1)))
    (tmp_path / "benchmark" / "metrics" / "steps_seen.py").write_text(
        "def read(run):\n    return None if run.trace is None else float(run.trace.steps)\n")
    shutil.copy(H.BENCH / "limits" / "large_unet.train.json",
                tmp_path / "benchmark" / "limits" / "large_unet.train_one.json")
    spec["workloads"].append({"name": "large_unet.train_one", "config": "large_unet",
                              "traffic": "train_one", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "step",
                              "moves": "train_img_s", "workloads": ["large_unet.train_one"]})
    for m in spec["end_to_end"]:
        if m["name"] == "train_img_s":
            m["workloads"].append("large_unet.train_one")
    cell = H.Cell.find("large_unet.train_one", spec, root=tmp_path)
    assert cell.config["name"] == "large_unet" and cell.traffic["trace_steps"] == 1
    line = run(small_cell("", cell=cell), trace=True)
    assert line["metrics"]["steps_seen"]["value"] == 2.0    # small_cell traces 2 steps
    assert line["correct"] is True
    with pytest.raises(KeyError):
        H.Cell.find("no.such_cell", spec, root=tmp_path)


def test_reference_follows_the_program():
    """In float32 the program's three steps are the reference's to
    rounding: same weights, batches, draws, losses, gradients, inputs."""
    from benchmark.drivers import train

    cell = small_cell("large_unet.train")
    drv = train.Driver(H.Run(cell, SEED, torch.device("cpu")), H.reference_module(
        cell.workload["config"]), log=lambda m: None)
    drv.setup()
    drv.release()
    n = drv.check()
    assert n["loss_gap"] < 1e-3 and n["grad_gap"] < 5e-3 and n["input_gap"] < 1e-6, n
    assert n["grad_gap_kernels"] < 5e-3, n


def test_reference_augmentation_is_the_programs():
    """The reference's augmentation of the same draws equals the program's
    ``DataAugmentor.apply_u8``."""
    from image_segmentation_tpu_torch.ops.augment import AugmentParams, DataAugmentor

    from benchmark.data import make_pool

    (images, masks), = make_pool(1, 10, 32, SEED, "cpu")
    draws = P.sample_augment(10, P.step_generator(SEED, 5))
    params = AugmentParams(draws["flip"], draws["angles"], draws["jitter"], draws["blur"])
    prog_gen = DataAugmentor(4).sample(10, P.step_generator(SEED, 5))
    for a, b in zip((prog_gen.flip, prog_gen.angles, prog_gen.jitter, prog_gen.blur),
                    (params.flip, params.angles, params.jitter, params.blur)):
        assert torch.equal(a, b)
    pi, pm = DataAugmentor(4).apply_u8(params, images, masks)
    ri, rm = P.augment(images, masks, draws, 5)
    assert torch.equal(pm, rm) and (pi - ri).abs().max() < 1e-6


# ---------------------------------------------------------------- faults

def _unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from image_segmentation_tpu_torch.engine.train import Trainer

    step = Trainer.train_step

    def half(self, images, masks, step_key=0):
        n = images.shape[0] // 2
        return step(self, images[:n], masks[:n], step_key)

    monkeypatch.setattr(Trainer, "train_step", half)


def _wgrad_doubled(monkeypatch):
    """The hand-written wgrad's weight gradient doubled: only the kernels'
    weights see it (``grad_gap_kernels``)."""
    from image_segmentation_tpu_torch.ops import fused_conv

    wgrad = fused_conv.conv3x3_wgrad

    def doubled(*args, **kwargs):
        dw, db = wgrad(*args, **kwargs)
        return 2 * dw, db

    monkeypatch.setattr(fused_conv, "conv3x3_wgrad", doubled)


def _eval_forward(monkeypatch, change):
    from image_segmentation_tpu_torch.models.unet import UNet

    forward = UNet.forward

    def broken(self, x, *, train=False):
        return change(forward(self, x, train=train))

    monkeypatch.setattr(UNet, "forward", broken)


def _answer_altered(monkeypatch):
    def change(logits):
        logits = logits.clone()
        logits[0] = logits[0].roll(1, dims=-1)
        return logits

    _eval_forward(monkeypatch, change)


def _eval_half_batch(monkeypatch):
    def change(logits):
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0
        return logits

    _eval_forward(monkeypatch, change)


@pytest.mark.parametrize("name, fault", [
    ("large_unet.train", _unchanged), ("large_unet.train", _half_batch),
    ("large_unet.train", _wgrad_doubled),
    ("large_unet.eval", _answer_altered), ("large_unet.eval", _eval_half_batch),
])
def test_a_broken_path_is_not_correct(monkeypatch, name, fault):
    cell = small_cell(name)
    fault(monkeypatch)
    line = run(cell)
    assert line["correct"] is False, line["checks"]
    if fault is _wgrad_doubled:
        for number in ("grad_gap_kernels", "grad_gap_kernels_median"):
            check = line["checks"][number]
            assert check["value"] > check["limit"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference in float8 put in the program's place fails the cell's
    limits."""
    from benchmark import control
    from benchmark.drivers import base

    cell = small_cell(name)
    out = control.control_numbers(cell, SEED, "cpu")
    checks, ok = base.judge(out["control"], cell.limits())
    assert not ok, checks
