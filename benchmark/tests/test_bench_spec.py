"""``BENCHMARK.json`` against the benchmark's contract, and each
configuration file against the program's preset and model."""

from __future__ import annotations

import dataclasses
import json
import re

import pytest

from benchmark import harness as H
from benchmark import plain as P
from benchmark.harness import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")


def test_the_check_fits_its_time():
    """A full check of 24 cells: 2 + 14 * 24 runs of run_seconds + 60, two
    compiles of 90 s a cell, 1200 s spare, within 43200 s."""
    cells = 24
    total = (2 + 14 * cells) * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_part_is_found_by_name(workload):
    cell = H.Cell.find(workload)
    assert (BENCH / "drivers" / f"{cell.traffic['mode']}.py").is_file()
    assert H.reference_module(cell.workload["config"]).spec
    assert cell.limits(), "no correctness limits"
    e2e = [m["name"] for m in cell.metrics(False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = cell.metrics(True)
    assert per_layer
    for m in cell.metrics(False) + per_layer:
        assert H.metric_file(BENCH, m["name"]).is_file()
    for m in per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, not reported in {workload}"


@pytest.mark.parametrize("config", sorted(p.stem for p in (BENCH / "configs").glob("*.json")))
def test_config_is_the_preset(config):
    """The file holds the program's preset as it is run: model, model args,
    loss, batch, image size, augmentation, prompt sigma, precision and
    optimizer; and the reference's parameters are the model's, leaf for
    leaf."""
    from image_segmentation_tpu_torch.config import preset
    from image_segmentation_tpu_torch.models.registry import build_model

    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    entry = {c["name"]: c for c in SPEC["configs"]}.get(config, cfg)
    assert cfg["name"] == config and cfg["reduced"] == entry["reduced"] == []
    p = preset(cfg["preset"])
    assert (cfg["model"], cfg["model_args"], cfg["loss"], cfg["batch_size"], cfg["bf16"]) == (
        p.model, p.model_args, p.loss, p.batch_size, p.bf16)
    assert (cfg["image_size"], cfg["augmentations_per_datapoint"],
            cfg["prompt_gaussian_sigma"]) == (p.data.image_size,
                                              p.data.augmentations_per_datapoint,
                                              p.data.prompt_gaussian_sigma)
    assert cfg["optimizer"] == dataclasses.asdict(p.optimizer)
    model = build_model(cfg["model"], device="meta", **cfg["model_args"])
    ours = {n: tuple(s) for n, s, *_ in H.reference_module(config).spec(cfg["architecture"])}
    theirs = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours == theirs
    trainable = {n for n, t in model.named_parameters() if t.requires_grad}
    assert set(P.trainable_names(H.reference_module(config).spec(cfg["architecture"]))) \
        == trainable
