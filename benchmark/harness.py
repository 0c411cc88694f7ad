"""One run of one cell: find its parts by name, set up, measure, check,
and print the result line.

Everything a cell needs is found from the names in ``BENCHMARK.json``:

- the configuration: the ``file`` of its ``configs`` entry
  (``benchmark/configs/<config>.json``);
- the traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``mode``
  names the driver ``benchmark/drivers/<mode>.py``;
- the plain reference: ``benchmark/reference/<config>.py``;
- each metric: ``benchmark/metrics/<metric>.py``, or where there is none
  the reader of its base name (``mfu.py`` for ``mfu.train`` and
  ``mfu.eval``), a ``read(run)`` that returns a number or None (then the
  metric is left out of the line);
- the correctness limits: ``benchmark/limits/<workload>.json``.

A later cell, mix, configuration or metric is added as files and entries,
with no edit here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "image_segmentation_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module (its name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_file(bench: Path, name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, else that of
    its base name, the part before the first dot."""
    own = bench / "metrics" / f"{name}.py"
    return own if own.is_file() else bench / "metrics" / f"{name.split('.')[0]}.py"


def reference_module(config_name: str):
    return importlib.import_module(f"benchmark.reference.{config_name}")


def forbidden_modules(names=None) -> List[str]:
    """Of ``names`` (default: the loaded modules), those whose top-level
    name is JAX's or the JAX package's, compared whole: the port's name
    begins with the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Cell:
    """A workload with its parts, found by name."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    spec: dict
    bench: Path = BENCH

    @classmethod
    def find(cls, name: str, spec: Optional[dict] = None, root: Path = ROOT) -> "Cell":
        """The cell ``name`` of ``spec`` (default ``root``'s
        ``BENCHMARK.json``), its files read under ``root``."""
        spec = spec if spec is not None else load_json(root / "BENCHMARK.json")
        bench = root / BENCH.name
        work = {w["name"]: w for w in spec["workloads"]}
        if name not in work:
            raise KeyError(f"unknown workload {name!r}; known: {sorted(work)}")
        w = work[name]
        cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
        return cls(name, w, load_json(root / cfg_entry["file"]),
                   load_json(bench / "traffic" / f"{w['traffic']}.json"), spec, bench)

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics this cell reports: its end-to-end ones, or with a
        trace its per-layer ones."""
        entries = self.spec["per_layer"] if trace else self.spec["end_to_end"]
        return [m for m in entries if "workloads" not in m or self.name in m["workloads"]]

    def limits(self) -> Dict[str, dict]:
        path = self.bench / "limits" / f"{self.name}.json"
        return load_json(path) if path.is_file() else {}


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: Cell
    seed: int
    device: Any
    setup_s: float = math.nan
    window: Optional[dict] = None     # {"seconds", "images", "attempted", "failed"}
    trace: Any = None                 # trace.Trace of the traced window
    driver: Any = None                # the driver: layers, flops per step


def card_line() -> str:
    """The card's name, count and power limit (``nvidia-smi``)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, *,
             t_start: float, log=print) -> dict:
    """Set up, measure, check; returns the result line as a dict."""
    import torch

    from .drivers import base

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    log(f"imports and device {time.perf_counter() - t_start!r} s")
    driver_mod = importlib.import_module(f"benchmark.drivers.{cell.traffic['mode']}")
    run = Run(cell, seed, torch.device(device))
    driver = driver_mod.Driver(run, reference_module(cell.workload["config"]), log=log)
    run.driver = driver
    driver.setup()
    run.setup_s = time.perf_counter() - t_start
    log(f"setup {run.setup_s!r} s; {driver.describe()}")
    if trace:
        run.trace = driver.traced(int(cell.traffic["trace_steps"]))
        attempted, failed = run.trace.steps, driver.failed
        log(f"traced {run.trace.steps} steps in {run.trace.window_s!r} s, "
            f"device busy {run.trace.busy_s!r} s")
    else:
        run.window = driver.window(seconds)
        attempted, failed = run.window["attempted"], run.window["failed"]
        log(f"window {run.window['seconds']!r} s, {attempted} attempted, {failed} failed")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"memory peak {peak} bytes "
        f"({torch.cuda.get_device_name() if on_card else 'cpu'})")
    metrics = {}
    for m in cell.metrics(trace):
        reader = load_module(metric_file(cell.bench, m["name"]),
                             "benchmark_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    driver.release()
    if on_card:
        torch.cuda.empty_cache()
    numbers = driver.check()
    log(f"compared numbers {numbers}")
    checks, correct = base.judge(numbers, cell.limits())
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    line = {"correct": correct, "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": dev}
    if trace:
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = checks
    return line


def main(argv=None, *, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    cell = Cell.find(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card_line()}; devices {torch.cuda.device_count()}; torch {torch.__version__}")
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                    t_start=t_start, log=log)
    found = forbidden_modules()
    if found:
        log(f"loaded JAX or the JAX package: {found}")
        return 3
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0
