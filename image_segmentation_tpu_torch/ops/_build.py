"""Build ``csrc/*.cu`` into one shared library with ``nvcc`` and load it
with ``ctypes``.

The kernels have a plain C interface (no PyTorch headers), so the build
takes seconds: one ``nvcc -c`` per source, all started together, then one
link.  It happens at first use, into ``build/kernels/`` at the root of the
checkout, under a name keyed by the hash of the sources, headers and
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
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points: name -> argtypes.  Every entry returns cudaError_t as int,
# but the two path queries.
SIGNATURES = {
    # x, x_b, w, bias, ab, out, stats, scratch, B, H, W, Ca, Cb, Co, path, stream
    "imgseg_conv3x3": (_P,) * 8 + (_I,) * 7 + (_P,),
    # g, y, gf, w, x_post, ab_post, out, out_b, sums, scratch, B, H, W, Cg, Co, Na, affine, path,
    # stream
    "imgseg_conv3x3_dgrad": (_P,) * 10 + (_I,) * 8 + (_P,),
    # g, y, gf, x, x_b, ab, dw, db, scratch, B, H, W, Ca, Cb, Co, affine, path, stream
    "imgseg_conv3x3_wgrad": (_P,) * 9 + (_I,) * 8 + (_P,),
    # g, y, a, b, sums, B, H, W, C, stream
    "imgseg_bn_relu_bwd_reduce": (_P,) * 5 + (_I,) * 4 + (_P,),
    # z, ab, p, B, H, W, C, stream
    "imgseg_maxpool2x2_affine_relu": (_P, _P, _P, _I, _I, _I, _I, _P),
    # z, a, b, dp, dz, sums, B, H, W, C, stream
    "imgseg_maxpool2x2_affine_relu_bwd": (_P,) * 6 + (_I,) * 4 + (_P,),
    # x, w, bias, y, B, Hin, Win, Cin, Co, stream
    "imgseg_convtranspose2x2": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, wt, g, dx, dw, db, scratch, B, Hin, Win, Cin, Co, stream
    "imgseg_convtranspose2x2_bwd": (_P,) * 7 + (_I,) * 5 + (_P,),
    # x, g, w, dx, dwb, scratch, npix, Ci, Co, stream
    "imgseg_conv1x1_bwd": (_P,) * 6 + (_L, _I, _I, _P),
    # x, shifts, out, N, H, W, axis, stream
    "imgseg_shift": (_P, _P, _P, _I, _I, _I, _I, _P),
    # img, jitter, blur, out, scratch, N, H, W, bf16_out, stream
    "imgseg_preprocess": (_P,) * 5 + (_I,) * 4 + (_P,),
    # q, k, v, out, B, L, S, D, heads, scale, stream
    "imgseg_cross_attention": (_P,) * 4 + (_I,) * 5 + (_F, _P),
    # the path of the latest conv launch: 0 vector, 1 narrow, 2 deep (no error code)
    "imgseg_conv3x3_path": (),
    "imgseg_conv3x3_wgrad_path": (),
}
# Scratch sizes (fp32 elements) of the kernels with a second summing pass,
# and the sums buffers (the sums, then a row of partials per block) of the
# two that sum in one launch: name -> argtypes; each returns long long (-1:
# the kernel takes no such shape).
SCRATCH_QUERIES = {
    "imgseg_conv3x3_scratch": (_I, _I, _I, _I),                  # B, H, W, Co
    "imgseg_conv3x3_wgrad_scratch": (_I,) * 6,                   # B, H, W, Cin, Co, deep
    "imgseg_bn_relu_bwd_reduce_floats": (_I,),                   # C
    "imgseg_maxpool2x2_affine_relu_bwd_floats": (_I, _I, _L),    # W, C, B*H/2
    "imgseg_convtranspose2x2_bwd_scratch": (_I, _I, _I, _I, _I),  # B, Hin, Win, Cin, Co
    "imgseg_preprocess_scratch": (_I, _I, _I),                   # N, H, W
    "imgseg_conv1x1_bwd_scratch": (_L, _I, _I),                  # pixels, Ci, Co
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
    for s in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libimgseg_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    compiles = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(srcs, objs))
    ]
    steps = []  # (command, return code, stderr)
    for cmd, proc in compiles:
        _, err = proc.communicate()
        steps.append((cmd, proc.returncode, err))
    if all(rc == 0 for _, rc, _ in steps):
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        steps.append((cmd, res.returncode, res.stderr))
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(cmd, rc, err) for cmd, rc, err in steps if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, rc, err = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{err}")
    os.replace(tmp, out)
    return Build(out, seconds, "".join(err for _, _, err in steps))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build().path))
    for table, restype in ((SIGNATURES, ctypes.c_int), (SCRATCH_QUERIES, ctypes.c_longlong)):
        for name, argtypes in table.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
    lib.imgseg_error_string.argtypes = (ctypes.c_int,)
    lib.imgseg_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().imgseg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# ---- shared by the kernel wrappers (ops/fused_conv.py, conv1x1.py, roll.py, ...)

def on_cpu(x) -> bool:
    """True for a CPU tensor (the wrapper takes its plain version), False
    for a CUDA tensor (it launches the kernel); any other device raises."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}: expected cpu or cuda")
    return False


def ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch(wrapper, entry: str, *args) -> None:
    """Call C entry point ``entry`` on PyTorch's current stream, raise on a
    CUDA error, and count one launch of ``wrapper``."""
    # the current stream's handle; torch.cuda.current_stream() would build a
    # Python Stream object on every call, more host time than the launch
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    check(getattr(library(), entry)(*args, stream), wrapper.__name__)
    wrapper.launches += 1


def scratch(query: str, like, *dims: int):
    """fp32 scratch for a kernel's per-block partial sums, sized by the C
    library's ``query``."""
    n = getattr(library(), query)(*dims)
    return torch.empty(max(int(n), 1), dtype=torch.float32, device=like.device)
