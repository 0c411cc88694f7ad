#!/usr/bin/env python3
"""The pool backward's vector path at other depths and cache hints, timed
in turns beside the library's kernel on one NVIDIA GPU.

    python3 tools/exp_pool_bwd.py [--iters 20] [--labels PREFIX ...]

``tools/exp_pool_bwd.cu`` (built here with nvcc into ``build/exp/``) holds
``csrc/pool.cu``'s ``pool_bwd_kernel`` as a template over N (windows a
thread keeps in flight), the fewest blocks an SM (``__launch_bounds__``)
and evict-first against plain loads and stores; its variant 2 ("N2 MINB2
plain") is the library's kernel.  Each case of ``chip_smoke.kernel_cases`` for the entry
``maxpool2x2_affine_relu_bwd`` with C a multiple of 8 (with ``--labels``,
those whose label starts with one of them) runs through the library and
every variant, each held to the plain version (dz bit for bit, the sums
by ``chip_smoke.compare``), then each is timed with CUDA events over
``--iters`` launches, in the order library, variants, variants reversed,
library, beside a plain copy of the inputs.  One JSON line a case: the
mean µs of each and its rate (inputs read once, outputs written once),
the copy's rate, the card.
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
VARIANTS = ("N1 MINB3 cs", "N2 MINB2 cs", "N2 MINB2 plain", "N2 MINB1 cs", "N3 MINB1 cs",
            "N4 MINB1 cs")


def load_variants():
    from image_segmentation_tpu_torch.ops import _build

    out = ROOT / "build" / "exp" / "libexp_pool_bwd.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", f"-I{_build.CSRC}", "-o", str(out),
           str(ROOT / "tools" / "exp_pool_bwd.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}")
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.exp_pool_bwd.argtypes, lib.exp_pool_bwd.restype = (I,) + (P,) * 6 + (I,) * 4 + (P,), I
    lib.exp_pool_bwd_floats.argtypes, lib.exp_pool_bwd_floats.restype = (I, I), ctypes.c_longlong
    lib.exp_pool_bwd_variants.restype = I
    assert lib.exp_pool_bwd_variants() == len(VARIANTS)
    lines = res.stderr.splitlines()
    for i, line in enumerate(lines):
        if "entry function" in line and "pool_bwd_var" in line:
            print("ptxas", " ".join(x.strip() for x in lines[i:i + 4])[-160:], flush=True)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--labels", nargs="*", default=[], help="case label prefixes (default: all)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("exp_pool_bwd: no CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    card = smoke.card_line()
    lib = load_variants()
    for entry, label, _, make in smoke.kernel_cases(torch, smoke.kernel_modules(),
                                                   smoke.path_shapes()):
        if entry != "maxpool2x2_affine_relu_bwd" or (
                args.labels and not label.startswith(tuple(args.labels))):
            continue
        case = make()
        z, a, b, dp = case.inputs
        bsz, h, w, c = z.shape
        if c % 8:
            continue
        ref = case.plain()
        calls = {"library": case.kern}
        for v, name in enumerate(VARIANTS):
            dz = torch.empty_like(z)
            sums = torch.empty(int(lib.exp_pool_bwd_floats(v, c)), dtype=torch.float32,
                               device=z.device)

            def launch(v=v, dz=dz, sums=sums):
                stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
                err = lib.exp_pool_bwd(v, z.data_ptr(), a.data_ptr(), b.data_ptr(), dp.data_ptr(),
                                       dz.data_ptr(), sums.data_ptr(), bsz, h, w, c, stream)
                if err:
                    raise RuntimeError(f"variant {v}: CUDA error {err}")
                return dz, sums[:c], sums[c:2 * c]
            got = launch()
            torch.cuda.synchronize()
            if not torch.equal(got[0], ref[0]):
                raise AssertionError(f"{name} {label}: dz differs from the plain version")
            smoke.compare(torch, f"{name} {label}", got, ref)
            calls[name] = launch
        order = ["library", *VARIANTS, *reversed(VARIANTS), "library"]
        ms = {k: [] for k in calls}
        for k in order:
            ms[k].append(smoke.cuda_ms(torch, calls[k], args.iters))
        twins = [torch.empty_like(t) for t in case.inputs]
        copy_ms = smoke.cuda_ms(torch, lambda: [u.copy_(t) for u, t in zip(twins, case.inputs)],
                                args.iters)
        nbytes = smoke._nbytes([*case.inputs, ref])
        row = {"label": label, "shape": list(z.shape), "card": card,
               "copy_TBps": 2 * smoke._nbytes(case.inputs) / copy_ms / 1e9}
        for k, times in ms.items():
            mean = sum(times) / len(times)
            row[k] = {"us": mean * 1e3, "TBps": nbytes / mean / 1e9}
        print(json.dumps(row), flush=True)
        del case, twins, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
