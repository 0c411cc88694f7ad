#!/usr/bin/env python3
"""K3 (the BN-ReLU backward reduction) with each of two stagings, timed in
turns on one NVIDIA GPU: 16-byte loads straight into registers (the
library's kernel, ``csrc/bn_relu_bwd.cu``) and bulk copies into a ring of
shared memory (``tools/exp_k3_bulk.cu``, built here with nvcc into
``build/exp/``).

    python3 tools/exp_k3_staging.py [--iters 20] [--labels PREFIX ...]

Each case of ``chip_smoke.kernel_cases`` for the entry
``bn_relu_bwd_reduce`` (every path's shapes; with ``--labels`` those whose
label starts with one of them) runs through both libraries' C entry point,
is held to the plain version (``chip_smoke.compare``), and is timed with
CUDA events over ``--iters`` launches in turns (loads, bulk, bulk, loads),
beside a plain copy of its inputs (``Tensor.copy_``).  One JSON line a
case: the mean ms of each staging and the rate each reaches (its inputs
read once, its sums written once), the copy's rate (its inputs read once
and written once), and the card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
ENTRY, QUERY = "imgseg_bn_relu_bwd_reduce", "imgseg_bn_relu_bwd_reduce_floats"


def ptxas_lines(log: str, kernel: str) -> list:
    lines = log.splitlines()
    return [" ".join(x.strip() for x in lines[i:i + 4])
            for i, line in enumerate(lines) if "entry function" in line and kernel in line]


def load_library():
    """The kernel library's K3 entry point and sums-buffer query, and its
    ptxas lines for ``bnred_kernel`` (empty if it was built before)."""
    from image_segmentation_tpu_torch.ops import _build

    lib = _build.library()
    return (getattr(lib, ENTRY), getattr(lib, QUERY),
            ptxas_lines(_build.build().log, "bnred_kernel"))


def load_bulk():
    """``tools/exp_k3_bulk.cu`` built with the library's nvcc flags: its
    entry point and query, and its ptxas lines."""
    from image_segmentation_tpu_torch.ops import _build

    out = ROOT / "build" / "exp" / "libexp_k3_bulk.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", f"-I{_build.CSRC}", "-o", str(out),
           str(ROOT / "tools" / "exp_k3_bulk.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}")
    lib = ctypes.CDLL(str(out))
    run, floats = lib.exp_k3_bulk, lib.exp_k3_bulk_floats
    run.argtypes, run.restype = _build.SIGNATURES[ENTRY], ctypes.c_int
    floats.argtypes, floats.restype = _build.SCRATCH_QUERIES[QUERY], ctypes.c_longlong
    return run, floats, ptxas_lines(res.stderr, "bnred_bulk_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--labels", nargs="*", default=[], help="case label prefixes (default: all)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("exp_k3_staging: no CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    card = smoke.card_line()
    libs = {"loads": load_library(), "bulk": load_bulk()}
    for which, (_, _, ptxas) in libs.items():
        print(f"ptxas {which}: {ptxas}", flush=True)
    for entry, label, _, make in smoke.kernel_cases(torch, smoke.kernel_modules(),
                                                   smoke.path_shapes()):
        if entry != "bn_relu_bwd_reduce" or (args.labels and not label.startswith(tuple(args.labels))):
            continue
        case = make()
        g, y, a, b = case.inputs
        bsz, h, w, c = y.shape
        ref = case.plain()
        calls, ms = {}, {}
        for which, (run, floats, _) in libs.items():
            sums = torch.empty(int(floats(c)), dtype=torch.float32, device=y.device)

            def launch(run=run, sums=sums):
                stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
                err = run(g.data_ptr(), y.data_ptr(), a.data_ptr(), b.data_ptr(), sums.data_ptr(),
                          bsz, h, w, c, stream)
                if err:
                    raise RuntimeError(f"{which}: CUDA error {err}")
            launch()
            torch.cuda.synchronize()
            smoke.compare(torch, f"{which} {label}", (sums[:c], sums[c:2 * c]), ref)
            calls[which], ms[which] = launch, []
        for which in ("loads", "bulk", "bulk", "loads"):
            ms[which].append(smoke.cuda_ms(torch, calls[which], args.iters))
        twins = [torch.empty_like(t) for t in case.inputs]
        copy_ms = smoke.cuda_ms(torch, lambda: [u.copy_(t) for u, t in zip(twins, case.inputs)],
                                args.iters)
        nbytes = smoke._nbytes([*case.inputs, ref])
        row = {"label": label, "shape": list(y.shape), "card": card,
               "copy_TBps": 2 * smoke._nbytes(case.inputs) / copy_ms / 1e9}
        for which, times in ms.items():
            mean = sum(times) / len(times)
            row[f"{which}_ms"], row[f"{which}_TBps"] = mean, nbytes / mean / 1e9
        print(json.dumps(row), flush=True)
        del case, twins, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
