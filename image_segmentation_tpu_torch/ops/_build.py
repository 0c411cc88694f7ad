"""Build ``csrc/*.cu`` into one shared library with ``nvcc`` and load it
with ``ctypes``.

The kernels have a plain C interface (no PyTorch headers), so the build
takes seconds.  It happens at first use, into ``build/kernels/`` at the
root of the checkout, under a name keyed by the hash of the sources and
flags: a changed source rebuilds, an unchanged one is loaded as it is.
Nothing here runs at import time, and nothing here needs a card until a
kernel is launched.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argtypes.  Every entry returns cudaError_t as int.
SIGNATURES = {
    # x, x_b, w, bias, ab, out, B, H, W, Ca, Cb, Co, stream
    "imgseg_conv3x3": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # z, ab, p, B, H, W, C, stream
    "imgseg_maxpool2x2_affine_relu": (_P, _P, _P, _I, _I, _I, _I, _P),
    # x, w, bias, y, B, Hin, Win, Cin, Co, stream
    "imgseg_convtranspose2x2": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str        # nvcc's stderr (ptxas register/spill report); "" if cached


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels are built on the machine with the card"
        )
    return found


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Compile the kernels unless a library for these exact sources exists."""
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libimgseg_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, out)
    return Build(out, seconds, res.stderr)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.imgseg_error_string.argtypes = (ctypes.c_int,)
    lib.imgseg_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().imgseg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
