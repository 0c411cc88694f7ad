"""The readings that a cell's correctness limits are set from, on the card
at the cell's own size.

    python3 -m benchmark.control --workload NAME --seeds S1,S2,... \
        --control-seeds C1,C2,C3 [--seconds 2]

For every seed of ``--seeds``: the program as a run drives it (set-up, the
first steps; for validation a window of ``--seconds`` at the cell's load),
then the check's numbers against the float32 reference.  Their largest is each
number's lower reading.

For every seed of ``--control-seeds``: the control, the reference computed
in float8 (``plain.Precision("fp8")``) put in the program's place, against
the float32 reference; for training also the fault "half of the batch left
out, the mean taken over the rest", planted in the reference put in the
program's place, and the program with its hand-written wgrad's weight
gradient doubled (:func:`wgrad_doubled`).  A state left unchanged reads 1
on ``change_gap`` by its measure and needs no run.  The smallest of these
readings is the upper one.

Prints one JSON line per seed and a summary line with both readings of
every number.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
import json
import sys
import time

import torch

from . import harness as H
from . import plain as P


def _driver(cell, seed, device):
    run = H.Run(cell, seed, torch.device(device))
    mod = importlib.import_module(f"benchmark.drivers.{cell.traffic['mode']}")
    drv = mod.Driver(run, H.reference_module(cell.workload["config"]),
                     log=lambda m: print(m, file=sys.stderr, flush=True))
    run.driver = drv
    return drv


@contextlib.contextmanager
def wgrad_doubled():
    """A fault in the program: its 3x3 conv wgrad returns twice the weight
    gradient (the bias gradient as it is)."""
    from image_segmentation_tpu_torch.ops import fused_conv

    wgrad = fused_conv.conv3x3_wgrad

    @functools.wraps(wgrad)
    def doubled(*args, **kwargs):
        dw, db = wgrad(*args, **kwargs)
        return 2 * dw, db

    fused_conv.conv3x3_wgrad = doubled
    try:
        yield
    finally:
        fused_conv.conv3x3_wgrad = wgrad


def program_numbers(cell, seed: int, device, seconds: float) -> dict:
    drv = _driver(cell, seed, device)
    drv.setup()
    if cell.traffic["mode"] == "eval":
        drv.window(seconds)
    drv.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return drv.check()


def control_numbers(cell, seed: int, device, seconds: float = 0.0) -> dict:
    """{"control": numbers, and for training "half_batch" and
    "wgrad_doubled": numbers}."""
    drv = _driver(cell, seed, device)
    drv.make_pool()
    fp8 = P.Precision("fp8")
    if cell.traffic["mode"] == "eval":
        refs = drv.reference_all()
        answers = [(i, r.argmax(-1).to(torch.uint8)) for i, r in enumerate(drv.reference_all(fp8))]
        return {"control": drv.compare(refs, answers)}
    ref = drv.reference()
    out = {"control": drv.compare(ref, drv.reference(fp8))}
    half = drv.reference(rows=drv.batch // 2)
    out["half_batch"] = drv.compare(ref, half)
    del drv, ref, half
    with wgrad_doubled():
        out["wgrad_doubled"] = program_numbers(cell, seed, device, seconds)
    return out


def summary(programs: list, controls: list) -> dict:
    names = sorted(programs[0])
    out = {}
    for n in names:
        lower = max(p[n] for p in programs)
        ups = {kind: min(c[kind][n] for c in controls) for kind in controls[0]}
        out[n] = {"lower": lower, **{f"upper_{k}": v for k, v in ups.items()}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = H.Cell.find(args.workload)
    programs, controls = [], []
    for s in [int(x) for x in args.seeds.split(",")]:
        t = time.perf_counter()
        numbers = program_numbers(cell, s, args.device, args.seconds)
        programs.append(numbers)
        print(json.dumps({"seed": s, "program": numbers,
                          "seconds": time.perf_counter() - t}), flush=True)
    for s in [int(x) for x in args.control_seeds.split(",")]:
        t = time.perf_counter()
        c = control_numbers(cell, s, args.device, args.seconds)
        controls.append(c)
        print(json.dumps({"seed": s, **c, "seconds": time.perf_counter() - t}), flush=True)
    print(json.dumps({"workload": cell.name, "summary": summary(programs, controls)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
