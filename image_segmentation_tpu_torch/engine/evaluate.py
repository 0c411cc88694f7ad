"""Evaluation and the robustness sweeps; counterpart of
``image_segmentation_tpu/engine/evaluate.py`` (Evaluator :48).

The reference's ``TestWrapper`` (model_wrappers.py:251-792) and
``scripts/robustness_evaluation.py``:

- :meth:`Evaluator.test`              ~ model_wrappers.py:341-404
- :meth:`Evaluator.test_augmentation` ~ model_wrappers.py:408-478
- :meth:`Evaluator.test_robustness`   ~ model_wrappers.py:524-764: the 8
  float-space sweeps, each to ``augmentation-results/<name>.csv``.  (The
  reference logs the brightness-decrease sweep under the increase file
  name, model_wrappers.py:758; neither package repeats that.)
- :meth:`Evaluator.robustness_evaluation` ~ robustness_evaluation.py:27-133:
  the integer-space 8x10 grid to ``results/robustness_scores.csv`` (mean
  Dice per cell, batch 8).

Batching and draws as in JAX (:142-162, :203-260): batches in dataset
order with ``drop_last=False``; the remainder batch counts as one batch in
the mean of per-batch means; the draws of batch ``i`` come from a host
``torch.Generator`` keyed on ``(seed, i)``, the same for every point of a
family, as ``fold_in(key, i)`` is in JAX, so the CPU and the card draw
alike (the Trainer does the same, ``engine/train.py``).  torch's draws are
not JAX's; ``draws`` replaces the sampler, so the tests can feed JAX's.

One path, ``_run_sweep_family``, streams the split once per family:
batches outside, points inside, so each batch is copied to the device, and
its draws made, once for all the points (occlusion, whose draws depend on
the point, draws per point); each point's sums stay on the device in batch
order and are read back once per family.  A single point
(``_run_sweep_point``, ``test``, ``test_augmentation``) is a family of one.
JAX keeps a second, per-point path because its family path stages the
split for a ``lax.map``; here both would be the same loop.

The path never stages the whole split on the device: a batch at a time is
there, with one batch of look-ahead (``data.pipeline.BatchPipeline``).
That meets the JAX Evaluator's open fault (``_staged_split``,
evaluate.py:165, puts the whole split in device memory with no bound) by
construction.

Several ranks (``parallel.mesh``; JAX :20-22): each rank takes its rows of
every batch, the draws are made for the global batch's shape and sliced
to them, and each batch's metrics are the global batch's, their sums
taken over ranks before the ratios (``ops/losses``), not a mean of the
ranks' ratios.  A remainder batch that the ranks do not divide is whole on
every rank and its metrics are taken there alone (``mesh.local``), so
every number equals the one-process run's.  The family path stays in use
at every world size (JAX falls back to one point at a time there,
:214-218).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data import perturbations as pert
from ..data.datasets import ArrayDataset
from ..data.pipeline import BatchPipeline
from ..ops import losses as L
from ..ops.augment import normalize_image
from ..parallel import mesh
from ..utils import io as io_lib
from .export import check_servable

# (kind, name, batch_index, param, shape) -> draws
DrawsFn = Callable[[str, Optional[str], int, object, Tuple[int, ...]], pert.Draws]


def _on_device(model: nn.Module, device: torch.device) -> bool:
    return all(p.device.type == device.type
               and (device.index is None or p.device.index == device.index)
               for p in model.parameters())


class Evaluator:
    """Run a trained model over a test split, clean or perturbed.

    ``model``: a port model that carries its weights (``load_model``, or
    ``Trainer.model``), its parameters on ``device`` (the card unless the
    caller asks for the CPU); it is not moved.  ``binary``: the binary
    metrics (a one-logit model, ``loss="hybrid_binary"``)."""

    def __init__(
        self,
        model: nn.Module,
        test_data: ArrayDataset,
        *,
        batch_size: int = 8,
        binary: bool = False,
        seed: int = 42,
        device="cuda",
        draws: Optional[DrawsFn] = None,
    ):
        check_servable(model)
        self.device = torch.device(device)
        if not _on_device(model, self.device):
            where = sorted({str(p.device) for p in model.parameters()})
            raise ValueError(f"the model's parameters are on {where}, not on {self.device}")
        self.model = model
        self.test_data = test_data
        self.batch_size = batch_size
        self.binary = binary
        self.seed = seed
        self.draws = draws
        # wall seconds of the last run of each family: (kind, name) -> s
        self.family_seconds: Dict[Tuple[str, Optional[str]], float] = {}

    # ------------------------------------------------------------------
    def _pipeline(self) -> BatchPipeline:
        return BatchPipeline(self.test_data, self.batch_size, device=self.device,
                             shuffle=False, drop_last=False)

    def batch_draws(self, kind: str, name: Optional[str], batch_index: int, param,
                    shape: Sequence[int]) -> pert.Draws:
        """The draws of one point on batch ``batch_index``, on the device
        (None for a deterministic family): ``draws`` if given, else the
        family's sampler on a host generator seeded by ``(seed,
        batch_index)``."""
        if kind == "clean" or not pert.SWEEPS[kind][name]["random"]:
            return None
        shape = tuple(shape)
        if self.draws is not None:
            out = self.draws(kind, name, batch_index, param, shape)
        else:
            state = np.random.SeedSequence([self.seed, batch_index]).generate_state(1)[0]
            out = pert.sample(kind, name, shape, param, torch.Generator().manual_seed(int(state)))
        pin = self.device.type == "cuda"
        return tuple((d.pin_memory() if pin else d).to(self.device, non_blocking=pin)
                     for d in out)

    def perturb(self, kind: str, name: Optional[str], images_u8: torch.Tensor, param,
                draws: pert.Draws) -> torch.Tensor:
        """A uint8 batch at one point: uint8 for the integer battery (before
        normalisation), the [0, 1] float input for the float battery and
        the clean split."""
        if kind == "int":
            return pert.apply("int", name, images_u8, param, draws)
        images = normalize_image(images_u8)
        return images if kind == "clean" else pert.apply("float", name, images, param, draws)

    @torch.no_grad()
    def _batch_metrics(self, kind: str, name: Optional[str], images_u8: torch.Tensor,
                       masks_u8: torch.Tensor, param, draws: pert.Draws) -> torch.Tensor:
        """(iou, pixel accuracy, dice) of one batch at one point, fp32 on
        the device."""
        x = self.perturb(kind, name, images_u8, param, draws)
        if kind == "int":
            x = normalize_image(x)
        logits = self.model(x, train=False)
        masks = masks_u8.long()
        if self.binary:
            metrics = (L.iou_binary, L.pixel_accuracy_binary, L.dice_score_binary)
        else:
            metrics = (L.iou, L.pixel_accuracy, L.dice_score)
        return torch.stack([f(logits, masks).float() for f in metrics])

    def _run_sweep_family(self, kind: str, name: Optional[str],
                          params: Sequence) -> List[Tuple[float, ...]]:
        """Every point of a family with the split streamed once: each batch
        copied, and its draws made, once for all the points (per point
        where they depend on it); the points' sums stay on the device in
        batch order and are read back once."""
        t0 = time.perf_counter()
        per_point = kind != "clean" and pert.SWEEPS[kind][name]["per_point"]
        sums: List[Optional[torch.Tensor]] = [None] * len(params)
        n = 0
        pipe = self._pipeline()
        for i, (images, masks) in enumerate(pipe.epoch(0)):
            shape, rows = (pipe.global_rows(i),) + tuple(images.shape[1:]), pipe.rows(i)

            def draws_of(p):
                d = self.batch_draws(kind, name, i, p, shape)
                return None if d is None else tuple(t[rows] for t in d)

            shared = None if per_point else draws_of(params[0])
            with mesh.local() if pipe.replicated(i) else contextlib.nullcontext():
                for j, p in enumerate(params):
                    draws = draws_of(p) if per_point else shared
                    out = self._batch_metrics(kind, name, images, masks, p, draws)
                    sums[j] = out if sums[j] is None else sums[j] + out
            n += 1
        rows = (torch.stack(sums) / n).tolist()
        self.family_seconds[(kind, name)] = time.perf_counter() - t0
        return [tuple(r) for r in rows]

    def _run_sweep_point(self, kind: str, name: Optional[str], param) -> Tuple[float, ...]:
        """Mean over the split's batches of the per-batch (iou, pa, dice)
        at one point: a family of one."""
        return self._run_sweep_family(kind, name, [param])[0]

    # ----------------------------------------------------------------- API
    def test(self) -> Dict[str, float]:
        """Clean-split IoU / PixelAcc / Dice (model_wrappers.py:341-404)."""
        iou_v, pa, dice = self._run_sweep_point("clean", None, None)
        return {"iou": iou_v, "pixel_accuracy": pa, "dice": dice}

    def test_augmentation(self, name: str, param) -> Dict[str, float]:
        """One float-space corruption point (model_wrappers.py:408-478)."""
        iou_v, pa, dice = self._run_sweep_point("float", name, param)
        return {"iou": iou_v, "pixel_accuracy": pa, "dice": dice}

    def test_robustness(self, out_dir: str = "augmentation-results") -> Dict:
        """All 8 float-space sweeps -> ``<out_dir>/<name>.csv``."""
        results = {}
        for name, info in pert.FLOAT_SWEEPS.items():
            pts = self._run_sweep_family("float", name, info["params"])
            rows = [[param, iou_v, pa, dice]
                    for param, (iou_v, pa, dice) in zip(info["params"], pts)]
            io_lib.write_rows_csv(os.path.join(out_dir, f"{name}.csv"),
                                  io_lib.AUGMENTATION_CSV_HEADER, rows)
            results[name] = rows
        return results

    def robustness_evaluation(self, results_file: str = "results/robustness_scores.csv") -> Dict:
        """Integer-space 8x10 grid -> robustness_scores.csv
        (robustness_evaluation.py:96-127 schema: name, param, mean_dice)."""
        rows, results = [], {}
        for name, info in pert.INT_SWEEPS.items():
            pts = self._run_sweep_family("int", name, info["params"])
            results[name] = [(param, dice) for param, (_, _, dice) in zip(info["params"], pts)]
            rows += [[name, param, f"{dice:.4f}"] for param, dice in results[name]]
        io_lib.write_rows_csv(results_file, io_lib.ROBUSTNESS_CSV_HEADER, rows)
        return results
