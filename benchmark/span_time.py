"""The device time of the program's own profiler spans in a reduced trace,
for the readers of the per-layer metrics that put a step's time down to a
layer.

The program names every span ``"imgseg: " + name``
(``image_segmentation_tpu_torch/utils/spans.py``): a step's phases
(``prepare``, ``loss``, ``optimizer``, ``metrics``), the augmentor's
stages (``augment.geometry``, ``augment.colour``) and one per model block
(``model.enc3``), a block's backward as ``<name>.bwd``.  The trace keeps
each span's device extent (:class:`benchmark.trace.Trace` ``ranges``,
below).  A reader counts each device operation that starts
inside the union of the extents of the spans it names, once, whichever of
them hold it, and gives device milliseconds a step; where none of those
spans ran (a program without them, or a run on the CPU) it gives None.

The profiler gives a device operation to the innermost range open on the
thread that launched it, and to that range alone: a range's device
extent runs from the first to the last operation launched while it was
innermost, and a range that launches nothing itself has none.  So a
phase is the union of its own span, the spans inside it and two ranges
that others open inside the program's spans: torch's
``Optimizer.step#...`` inside ``optimizer``, and the training cell's
``bench: augment`` (``benchmark/drivers/train.py``) around the Trainer's
batch preparation inside ``prepare`` (``PHASES``).
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Tuple

from benchmark.drivers import base
from benchmark.trace import RANGE_PREFIX

PREFIX = "imgseg: "
BACKWARD = ".bwd"
MODEL = "model."
# each step phase that is not a model block: (the program's spans it is
# made of, the prefixes of the ranges that others open inside it)
PHASES = {
    "prepare": (("prepare", "augment.geometry", "augment.colour"), (RANGE_PREFIX + "augment",)),
    "loss": (("loss", "loss" + BACKWARD), ()),
    "optimizer": (("optimizer",), ("Optimizer.step#",)),
    "metrics": (("metrics",), ()),
}

Spans = List[Tuple[float, float]]


def _merge(spans: Iterable[Tuple[float, float]]) -> Spans:
    merged: List[List[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def extents(trace, names: Iterable[str]) -> Spans:
    """The union of the device extents of the program's spans ``names``
    (each without the prefix)."""
    return _merge(s for n in names for s in trace.ranges.get(PREFIX + n, []))


def ran(trace) -> bool:
    """Whether any of the program's spans ran in the trace."""
    return any(k.startswith(PREFIX) for k in trace.ranges)


def phase(trace, name: str) -> Spans:
    """The union of step phase ``name``'s spans and of the ranges that
    others open inside it (``PHASES``); empty where the program's spans
    never ran."""
    if not ran(trace):
        return []
    own, others = PHASES[name]
    return _merge(extents(trace, own) + [s for k, v in trace.ranges.items()
                                         if k.startswith(others) for s in v])


def device_s(trace, spans: Spans, inside: bool = True) -> float:
    """Device seconds of the operations that start inside ``spans`` (a
    merged union), or with ``inside=False`` outside them."""
    starts = [a for a, _ in spans]
    total = 0.0
    for _, start, dur in trace.ops:
        i = bisect.bisect_right(starts, start) - 1
        if (i >= 0 and start < spans[i][1]) == inside:
            total += dur
    return total


def per_step_ms(trace, spans: Spans, inside: bool = True) -> Optional[float]:
    """Device ms a step of the operations inside (or outside) ``spans``;
    None where no span ran."""
    if not spans:
        return None
    return 1e3 * device_s(trace, spans, inside) / trace.steps


def model_blocks(trace) -> List[str]:
    """Every model block span that ran, forward and backward."""
    return sorted({k[len(PREFIX):] for k in trace.ranges if k.startswith(PREFIX + MODEL)})


def kernel_blocks(cfg: dict) -> List[str]:
    """The blocks of the levels that the configuration's model args put on
    the program's hand-written kernels (``base.kernel_levels``), forward
    and backward: level L is ``enc<L+1>`` and ``dec<n+1-L>`` of the n
    encoders, and level 0 also the 1x1 stem ``input`` and output ``out``."""
    levels = base.kernel_levels(cfg)
    n = len(cfg["architecture"]["encoders"])
    names = [b for lvl in sorted(levels) for b in (f"enc{lvl + 1}", f"dec{n + 1 - lvl}")]
    if 0 in levels:
        names += ["input", "out"]
    return [MODEL + b + bwd for b in names for bwd in ("", BACKWARD)]


def deep_blocks(trace, cfg: dict) -> List[str]:
    """Every other model block that ran, forward and backward."""
    kernels = set(kernel_blocks(cfg))
    return [b for b in model_blocks(trace) if b not in kernels]


def spanned(trace) -> Spans:
    """The union of every model block and every step phase; empty where
    none ran."""
    return _merge(extents(trace, model_blocks(trace)) + [s for p in PHASES
                                                         for s in phase(trace, p)])
