#!/usr/bin/env python3
"""Time some kernels of this checkout beside the same kernels of another
checkout (an earlier commit), on one NVIDIA GPU, in turns.

    git archive <commit> | tar -x -C build/parent      # build/ is ignored by git
    python3 scripts/compare_kernels.py --other build/parent \\
        --entries cross_attention conv1x1_bwd
    python3 scripts/compare_kernels.py --other build/parent \\
        --entries conv3x3 conv3x3_dgrad --labels "clip_res out."

Each checkout runs in its own process, which imports that checkout's
``chip_smoke.py`` and ``image_segmentation_tpu_torch`` and builds its
kernels into its own ``build/kernels``.  The processes run in turns:
other, this, this, other.  Each times, with CUDA events over ``--iters``
launches after a warm-up, every case of ``chip_smoke.kernel_cases`` of the
named KERNEL_INFO entries (at the main paths' shapes, ``path_shapes()``,
and the edge cases the smoke run only checks; with ``--labels``, only the
cases whose label starts with one of them), and the library call
beside it, and the host time of one wrapper call (a host clock over
HOST_CALLS calls with no synchronise).  The result: per
case the mean ms of both checkouts and the library's, and per entry the sum
over its "sum" cases (the smoke run's JSON line), as JSON lines on stdout.
With ``--steps`` it times, in the same turns, the large_unet train step
(batch 16, 512x512) of each checkout with ``fused_deep`` off and on
(``--iters`` steps after one) instead of kernels.
With ``--profile`` each case also gets its device time per CUDA kernel
(``torch.profiler``, a mean over ``--iters`` launches), to split a
wrapper's time between its kernel and its second pass of the sums.  Each
case also reports the device-memory rate it reached (its inputs read once
and its outputs written once, over its ms) beside that of a plain copy of
its inputs (``Tensor.copy_``: each input read once and written once), the
rate a streaming pass reaches on this card, and its bound (``bound_ms``,
as ``chip_smoke.py`` computes it: the larger of those bytes at the card's
memory rate and its operations at the peak rate for their type).  With ``--host-ops`` each case
also gets the host time of one wrapper call by PyTorch operator
(``torch.profiler``'s self CPU time over HOST_CALLS calls) beside the
wall time of those calls under the profiler: what is left of the wall
time is Python and the C library's own host work.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# calls of a wrapper timed on the host clock, with no synchronise: the host
# work of one call (checks, allocations, the launch itself)
HOST_CALLS = 100


def device_us():
    """This checkout's ``chip_smoke.device_us`` (the other checkout's
    ``chip_smoke`` may predate it)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.device_us


def host_ops_us(torch, fn) -> dict:
    """Host microseconds per call of ``fn`` by PyTorch operator (self CPU
    time), and under ``"wall"`` the wall time per call, all over HOST_CALLS
    calls under ``torch.profiler`` after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    out = {e.key: e.self_cpu_time_total / HOST_CALLS for e in prof.key_averages()
           if e.self_cpu_time_total > 0}
    return {"wall": wall / HOST_CALLS * 1e6, **out}


def child(root: Path, entries: list, labels: list, iters: int, with_profile: bool,
          with_host_ops: bool = False) -> None:
    """Time the cases in this process, from ``root``'s modules."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as smoke
    from image_segmentation_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    _build.library()
    mods = smoke.kernel_modules()
    device_times = device_us() if with_profile else None
    for entry, label, timed, make in smoke.kernel_cases(torch, mods, smoke.path_shapes()):
        if entry not in entries or (labels and not label.startswith(tuple(labels))):
            continue
        case = make()
        got = case.kern()
        last_path = getattr(mods[0], "last_path", None)  # the conv kernels' path, where known
        path = (last_path(getattr(mods[0], smoke.KERNEL_INFO[entry][0]))
                if last_path is not None and entry.startswith("conv3x3") else None)
        smoke.compare(torch, f"{entry} {label}", got, case.plain(), case.tol)
        ms = smoke.cuda_ms(torch, case.kern, iters)
        lib = None if case.library is None else smoke.cuda_ms(torch, case.library, iters)
        inputs = [t for t in case.inputs if isinstance(t, torch.Tensor)]
        twins = [torch.empty_like(t) for t in inputs]
        copy_ms = smoke.cuda_ms(torch, lambda: [b.copy_(t) for b, t in zip(twins, inputs)], iters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            case.kern()
        host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
        row = {"entry": entry, "label": label, "timed": timed, "ms": ms, "library_ms": lib,
               "host_us": host_us, "path": path,
               "TBps": smoke._nbytes([*case.inputs, got]) / ms / 1e9,
               "bound_ms": max(smoke._nbytes([*case.inputs, got]) / smoke.HBM_BYTES_PER_S * 1e3,
                               case.ops / case.flop_per_s * 1e3),
               "copy_TBps": 2 * smoke._nbytes(inputs) / copy_ms / 1e9}
        del got, twins
        if with_profile:
            row["device_us"] = device_times(torch, case.kern, iters)
        if with_host_ops:
            row["host_ops_us"] = host_ops_us(torch, case.kern)
        print("CASE " + json.dumps(row), flush=True)
        del case
        torch.cuda.empty_cache()


def child_steps(root: Path, steps: int) -> None:
    """Time the large_unet train step (batch 16, 512x512) with ``fused_deep``
    off and on in this process, from ``root``'s modules: the mean ms of
    ``steps`` steps after one, on one fixed batch."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as smoke
    from image_segmentation_tpu_torch.engine.train import Trainer

    images, masks = smoke._u8_batch(torch, smoke.SEED + 37, smoke.SIZE)
    for fused_deep in (False, True):
        extra = {"fused_deep": True} if fused_deep else {}
        trainer = Trainer(smoke.train_config("large_unet", smoke.SIZE, **extra), device="cuda",
                          make_artifacts=False)
        ms = smoke._step_ms(torch, trainer, images, masks, steps)
        print("STEP " + json.dumps({"fused_deep": fused_deep, "ms": ms}), flush=True)
        del trainer
        torch.cuda.empty_cache()


def run(root: Path, entries: list, labels: list, iters: int, with_profile: bool,
        steps: bool = False, with_host_ops: bool = False) -> list:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child", str(root),
           "--iters", str(iters), "--labels", *labels]
    cmd += ["--entries", *entries] if entries else []
    cmd += ["--profile"] if with_profile else []
    cmd += ["--steps"] if steps else []
    cmd += ["--host-ops"] if with_host_ops else []
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=1200)
    if res.returncode != 0:
        raise RuntimeError(f"{root}: exit {res.returncode}\n{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    tag = "STEP " if steps else "CASE "
    return [json.loads(line[5:]) for line in res.stdout.splitlines() if line.startswith(tag)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="the checkout to compare with")
    ap.add_argument("--entries", nargs="+", default=[], help="KERNEL_INFO entries")
    ap.add_argument("--labels", nargs="*", default=[], help="case label prefixes (default: all)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--profile", action="store_true", help="device time per CUDA kernel")
    ap.add_argument("--host-ops", action="store_true",
                    help="host time of a wrapper call per PyTorch operator")
    ap.add_argument("--steps", action="store_true",
                    help="the large_unet train step with fused_deep off and on, not kernels")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        if args.steps:
            child_steps(args.child.resolve(), args.iters)
        else:
            child(args.child.resolve(), args.entries, args.labels, args.iters, args.profile,
                  args.host_ops)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    order = [("other", args.other.resolve()), ("this", ROOT), ("this", ROOT),
             ("other", args.other.resolve())]
    if args.steps:
        steps = {}  # fused_deep -> {"this": [ms], "other": [ms]}
        for who, root in order:
            for r in run(root, [], [], args.iters, False, steps=True):
                steps.setdefault(r["fused_deep"], {"this": [], "other": []})[who].append(r["ms"])
        for fused_deep, t in steps.items():
            print(json.dumps({"step": "large_unet", "fused_deep": fused_deep, "this_ms": t["this"],
                              "other_ms": t["other"], "card": card}), flush=True)
        return 0
    if not args.entries:
        ap.error("--entries is required without --steps")
    # (entry, label, n) -> {"timed", "other": [ms], "this": [ms], "library": [ms]}: the n-th
    # case of that entry and label in a checkout's list (two paths may share a label)
    times = {}
    for who, root in order:
        seen = {}
        for r in run(root, args.entries, args.labels, args.iters, args.profile,
                     with_host_ops=args.host_ops):
            n = seen[r["entry"], r["label"]] = seen.get((r["entry"], r["label"]), -1) + 1
            t = times.setdefault((r["entry"], r["label"], n),
                                 {"timed": r["timed"], "other": [], "this": [], "library": [],
                                  "TBps": [], "copy_TBps": [], "other_host_us": [],
                                  "this_host_us": [], "path": None})
            t["copy_TBps"].append(r["copy_TBps"])
            t[who + "_host_us"].append(r["host_us"])
            if who == "this":
                t["TBps"].append(r["TBps"])
                t["path"] = r.get("path")
                t["bound_ms"] = r.get("bound_ms")
            if "device_us" in r:
                t.setdefault(who + "_device_us", r["device_us"])
            if "host_ops_us" in r:
                t.setdefault(who + "_host_ops_us", r["host_ops_us"])
            t[who].append(r["ms"])
            if r["library_ms"] is not None:
                t["library"].append(r["library_ms"])

    def mean(xs):
        return sum(xs) / len(xs) if xs else None

    sums = {}
    for (entry, label, n), t in times.items():
        row = {"entry": entry, "label": label if n == 0 else f"{label} #{n + 1}",
               "this_ms": mean(t["this"]),
               "other_ms": mean(t["other"]), "library_ms": mean(t["library"]),
               "this_TBps": mean(t["TBps"]), "copy_TBps": mean(t["copy_TBps"]),
               "this_host_us": mean(t["this_host_us"]), "other_host_us": mean(t["other_host_us"]),
               "this_path": t["path"], "bound_ms": t.get("bound_ms"), "card": card,
               **{k: v for k, v in t.items() if k.endswith(("_device_us", "_host_ops_us"))}}
        print(json.dumps(row), flush=True)
        if t["timed"] == "sum" and t["this"] and t["other"]:
            s = sums.setdefault(entry, {"this_ms": 0.0, "other_ms": 0.0, "library_ms": 0.0,
                                        "bound_ms": 0.0})
            for k in ("this_ms", "other_ms", "library_ms", "bound_ms"):
                s[k] += row[k] or 0.0
    for entry, s in sums.items():
        print(json.dumps({"entry": entry, "summed": True, **s, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
