"""What the drivers share: the program's configuration from the cell's
file, the comparisons that decide ``correct``, and the judgement against
the cell's limits."""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding (a conv bias before BatchNorm): Adam moves it by
# round-off alone, so it is left out of the gradient and change comparisons
NOUGHT_SHARE = 1e-3


def train_config(cfg: dict, seed: int, batch: int):
    """The program's TrainConfig of a configuration file: its model, model
    args, loss, precision, optimizer and augmentation, with the synthetic
    dataset (two images: the Trainer builds its datasets, the benchmark
    feeds its own batches)."""
    from image_segmentation_tpu_torch.config import DataConfig, OptimizerConfig, TrainConfig

    return TrainConfig(
        model=cfg["model"], model_args=dict(cfg["model_args"]), loss=cfg["loss"],
        batch_size=batch, seed=seed, bf16=cfg["bf16"],
        optimizer=OptimizerConfig(**cfg["optimizer"]),
        data=DataConfig(dataset="synthetic", synthetic_length=2, image_size=cfg["image_size"],
                        augmentations_per_datapoint=cfg["augmentations_per_datapoint"],
                        prompt_gaussian_sigma=cfg["prompt_gaussian_sigma"]))


def checked_traffic(traffic: dict) -> dict:
    """The mix, refused where it asks for what the drivers do not do: they
    run one client in a closed loop."""
    if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
        raise ValueError(f"the drivers run one closed-loop client, not {traffic}")
    return traffic


def kernel_levels(cfg: dict) -> set:
    """The U-Net levels whose 3x3 convs the model args put on the
    program's hand-written kernels: level 0 with ``w2d_level0``, level 1
    too with ``w2d_level1_fold2``, under ``w2d_impl="pallas_fused"``, at an
    image width that is a multiple of 8."""
    a = cfg["model_args"]
    if a.get("w2d_impl") != "pallas_fused" or not a.get("w2d_level0") \
            or cfg["image_size"] % 8:
        return set()
    return {0, 1} if a.get("w2d_level1_fold2") else {0}


def relative_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(prog: torch.Tensor, ref: torch.Tensor, keep: torch.Tensor,
              among: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Of the kept leaves (and of those only that are ``among``), the gap
    between the program's norm and the reference's, against the
    reference's norm of that leaf or of the median kept leaf, whichever is
    larger."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    med = ref[keep].median()
    return ((prog - ref).abs() / torch.maximum(ref, med))[keep if among is None else keep & among]


def worst_leaf_gap(prog, ref, keep, among=None) -> float:
    return float(leaf_gaps(prog, ref, keep, among).max())


def median_leaf_gap(prog, ref, keep, among=None) -> float:
    return float(leaf_gaps(prog, ref, keep, among).median())


def worst_leaves(prog, ref, keep, names, n: int = 4, among=None) -> str:
    """The n kept leaves (``among`` those) with the largest gaps, for the
    log."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    med = ref[keep].median()
    shown = keep if among is None else keep & among
    gaps = ((prog - ref).abs() / torch.maximum(ref, med)).masked_fill(~shown, -1)
    order = gaps.argsort(descending=True)[:n].tolist()
    return "; ".join(f"{names[i]} {float(prog[i])!r} vs {float(ref[i])!r} gap "
                     f"{float(gaps[i])!r}" for i in order) + f" (median leaf {float(med)!r})"


def kept_leaves(ref_grads: torch.Tensor) -> torch.Tensor:
    ref_grads = ref_grads.double().cpu()
    return ref_grads >= NOUGHT_SHARE * ref_grads.median()


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> Tuple[Dict[str, dict], bool]:
    """Each limited number beside its limit; correct when every one is
    present, finite and within its limit (and there is a limit at all)."""
    checks, ok = {}, bool(limits)
    for name, lim in limits.items():
        value = numbers.get(name, math.nan)
        checks[name] = {"value": value, "limit": lim["limit"]}
        ok = ok and math.isfinite(value) and value <= lim["limit"]
    return checks, ok

