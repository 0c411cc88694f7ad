#!/usr/bin/env python3
"""Where a benchmark cell's step goes, span by span, on one NVIDIA GPU.

    python3 tools/span_table.py --workload large_unet.train --seed N [--out FILE.json]

Sets the cell up as ``benchmark/run.py`` does, runs its traced window
(``--trace 1``: the untraced steps, then the steps under the profiler),
and gives each device operation to the innermost of the program's spans
(``image_segmentation_tpu_torch/utils/spans.py``) whose device extent
holds its start: every model block's forward and ``.bwd``, each step
phase, each augmentor stage; torch's ``Optimizer.step#...`` range counts
as ``optimizer`` and the training cell's ``bench: augment`` as
``prepare``, the phases they run inside.  Operations in no span are the
row ``(none)``.  Prints, and writes to ``--out``, one JSON object: the
card, the steps, the traced window's and the untraced steps' seconds a
step, the busy ms a step, each row's device ms a step by kernel group
(``benchmark.trace.group``), and every per-layer metric of the cell as
its reader gives it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def rows(trace) -> dict:
    """{row: {group: device ms a step}} of the innermost span of each
    operation."""
    from benchmark import span_time as S
    from benchmark import trace as T

    spans = []
    for key, extents in trace.ranges.items():
        label = key[len(S.PREFIX):] if key.startswith(S.PREFIX) else next(
            (p for p, (_, others) in S.PHASES.items() if key.startswith(others)), None)
        spans += [(a, b, label) for a, b in extents if label is not None]
    out = defaultdict(lambda: defaultdict(float))
    for name, start, dur in trace.ops:
        inside = [(b - a, label) for a, b, label in spans if a <= start < b]
        label = min(inside)[1] if inside else "(none)"
        out[label][T.group(name)] += 1e3 * dur / trace.steps
    return {k: dict(sorted(v.items(), key=lambda kv: -kv[1])) for k, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from benchmark import harness as H

    if not torch.cuda.is_available():
        print("span_table: no CUDA device", file=sys.stderr)
        return 1
    cell = H.Cell.find(args.workload)
    run = H.Run(cell, args.seed, torch.device("cuda"))
    driver_mod = importlib.import_module(f"benchmark.drivers.{cell.traffic['mode']}")
    driver = driver_mod.Driver(run, H.reference_module(cell.workload["config"]),
                               log=lambda m: print(m, file=sys.stderr, flush=True))
    run.driver = driver
    driver.setup()
    t = run.trace = driver.traced(int(cell.traffic["trace_steps"]))
    metrics = {}
    for m in cell.metrics(True):
        reader = H.load_module(H.metric_file(cell.bench, m["name"]),
                               "metric_" + m["name"].replace(".", "_"))
        metrics[m["name"]] = reader.read(run)
    table = rows(t)
    result = {"card": H.card_line(), "workload": args.workload, "seed": args.seed,
              "steps": t.steps, "window_s_per_step": t.window_s / t.steps,
              "plain_s_per_step": t.plain_window_s / t.steps,
              "busy_ms_per_step": 1e3 * t.busy_s / t.steps,
              "ops_ms_per_step": 1e3 * sum(d for _, _, d in t.ops) / t.steps,
              "metrics": metrics,
              "rows": dict(sorted(table.items(), key=lambda kv: -sum(kv[1].values())))}
    text = json.dumps(result, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
