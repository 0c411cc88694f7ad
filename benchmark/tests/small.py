"""Cells cut to a size the CPU runs in seconds: narrow U-Net widths, 32x32
images, batch 5 (serving 4), two traced steps.  ``fp32`` runs the program
in float32, in which it agrees with the reference to rounding; the limits
of the cell's file still apply."""

from __future__ import annotations

import copy

from benchmark import harness as H


def small_cell(name: str, fp32: bool = True, cell=None) -> H.Cell:
    c = copy.deepcopy(cell or H.Cell.find(name))
    cfg = c.config
    cfg["model_args"].update(stem_features=8, encoder_features=[8, 16, 16, 16])
    cfg["architecture"].update(stem=8, encoders=[8, 16, 16, 16])
    cfg["batch_size"] = 5
    cfg["image_size"] = 32
    if fp32:
        cfg["bf16"] = False
    c.traffic = dict(c.traffic, trace_steps=2)
    if c.traffic.get("batch"):
        c.traffic["batch"] = 4
    return c
