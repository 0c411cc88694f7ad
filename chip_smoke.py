#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``image_segmentation_tpu_torch`` (no jax, no module of the JAX
package) through the entry points
a user calls, on one card, at the full width of the ``large_unet`` preset:

1. prints the card (``nvidia-smi``) and builds the CUDA kernels from
   ``image_segmentation_tpu_torch/csrc`` (nvcc, into ``build/kernels``);
2. kernel phase: every kernel of the path against its plain PyTorch version
   at each shape the main path gives it (batch 16 at 512x512), in bf16, with
   both times from CUDA events;
3. slice phase: a LargeUNet with random weights from a seeded generator is
   written with ``export_model``, read back with ``load_model`` on the card,
   answers ``predict`` requests and runs batch-16 and batch-1 forwards at
   512x512.  Every kernel's launch count over that run is checked, and the
   batch-16 logits are held against the same model run through the plain
   versions;
4. prints one JSON line of per-kernel results, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Any failure raises, so the exit code is not 0 and no result line is
printed.  Without a CUDA device the script exits at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
SEED = 0
BATCH = 16
SIZE = 512
# kernel vs plain, per launch: max|kernel - plain| <= KERNEL_RTOL * max|plain|
# (bf16 output rounding of two fp32 sums taken in different orders).
KERNEL_RTOL = 2e-2
# served logits, kernel path vs plain path on the same weights and input
LOGITS_RTOL = 5e-2
ARGMAX_AGREEMENT = 0.995
NUM_CLASSES = 3
# The ``large_unet`` preset's model args (image_segmentation_tpu/config.py:
# 95-99; tests/test_torch_port_slice.py holds the two equal): levels 0 and 1
# through the hand-written kernels.
MODEL_ARGS = {"w2d_level0": True, "w2d_impl": "pallas_fused", "w2d_level1_fold2": True}

KERNEL_INFO = {  # wrapper name -> (source, the TPU kernel it replaces)
    "conv3x3": ("image_segmentation_tpu_torch/csrc/conv3x3.cu",
                "image_segmentation_tpu/ops/pallas_conv.py:568"),
    "maxpool2x2_affine_relu": ("image_segmentation_tpu_torch/csrc/pool.cu",
                               "image_segmentation_tpu/ops/pallas_conv.py:1629"),
    "convtranspose2x2": ("image_segmentation_tpu_torch/csrc/convtranspose.cu",
                         "image_segmentation_tpu/ops/pallas_conv.py:1852"),
}


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean ms per call of ``fn`` from CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main_path_shapes(model_args: dict) -> dict:
    """Each kernel's launches in one batch-16 forward at 512x512: name ->
    list of (label, kwargs-of-shapes), from the preset's widths."""
    from image_segmentation_tpu_torch.models.unet import LargeUNet

    stem = model_args.get("stem_features", 32)
    e1, e2 = (model_args.get("encoder_features") or LargeUNet.default_encoder_features)[:2]
    b, s0, s1 = BATCH, SIZE, SIZE // 2
    conv = [  # label, (B, H, W, Ca), Cb, Co, pre-affine
        ("enc1.conv1", (b, s0, s0, stem), 0, e1, False),
        ("enc1.conv2", (b, s0, s0, e1), 0, e1, True),
        ("enc2.conv1", (b, s1, s1, e1), 0, e2, False),
        ("enc2.conv2", (b, s1, s1, e2), 0, e2, True),
        ("dec4.conv1", (b, s1, s1, e1), e1, e1, False),
        ("dec4.conv2", (b, s1, s1, e1), 0, e1, True),
        ("dec5.conv1", (b, s0, s0, stem), stem, stem, False),
        ("dec5.conv2", (b, s0, s0, stem), 0, stem, True),
    ]
    pool = [("enc1.pool", (b, s0, s0, e1)), ("enc2.pool", (b, s1, s1, e2))]
    ct = [  # label, (B, Hin, Win, Cin), Co
        ("dec4.up", (b, s1 // 2, s1 // 2, e2), e1),
        ("dec5.up", (b, s0 // 2, s0 // 2, e1), stem),
    ]
    return {"conv3x3": conv, "maxpool2x2_affine_relu": pool, "convtranspose2x2": ct}


def kernel_phase(torch, fc, shapes: dict) -> dict:
    """Each kernel vs its plain version at every main-path shape."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=DEVICE) * scale).to(bf16)

    def rand(n, lo, hi):
        return torch.rand(n, generator=g, device=DEVICE) * (hi - lo) + lo

    cases = []  # (wrapper name, label, kernel fn, plain fn)
    for label, shp, cb, co, pre in shapes["conv3x3"]:
        ca = shp[-1]
        x = randn(*shp)
        xb = randn(*shp[:3], cb) if cb else None
        w = torch.randn((co, ca + cb, 3, 3), generator=g, device=DEVICE) / (9 * (ca + cb)) ** 0.5
        bias = torch.randn(co, generator=g, device=DEVICE) * 0.1
        ab = dict(a=rand(ca, 0.5, 1.5), b=rand(ca, -0.5, 0.5)) if pre else {}
        cases.append(("conv3x3", label,
                      lambda x=x, w=w, bias=bias, xb=xb, ab=ab: fc.conv3x3(x, w, bias, x_b=xb, **ab),
                      lambda x=x, w=w, bias=bias, xb=xb, ab=ab: fc.conv3x3_plain(x, w, bias, x_b=xb, **ab)))
    for label, shp in shapes["maxpool2x2_affine_relu"]:
        z = randn(*shp)
        a, b = rand(shp[-1], 0.5, 1.5), rand(shp[-1], -0.5, 0.5)
        cases.append(("maxpool2x2_affine_relu", label,
                      lambda z=z, a=a, b=b: fc.maxpool2x2_affine_relu(z, a, b),
                      lambda z=z, a=a, b=b: fc.maxpool2x2_affine_relu_plain(z, a, b)))
    for label, shp, co in shapes["convtranspose2x2"]:
        x = randn(*shp)
        w = torch.randn((shp[-1], co, 2, 2), generator=g, device=DEVICE) / (4 * shp[-1]) ** 0.5
        bias = torch.randn(co, generator=g, device=DEVICE) * 0.1
        cases.append(("convtranspose2x2", label,
                      lambda x=x, w=w, bias=bias: fc.convtranspose2x2(x, w, bias),
                      lambda x=x, w=w, bias=bias: fc.convtranspose2x2_plain(x, w, bias)))

    results = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for name in shapes}
    for name, label, kern, plain in cases:
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{label}: kernel {got.shape}/{got.dtype} vs plain {ref.shape}/{ref.dtype}")
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = KERNEL_RTOL * scale
        ok = err <= tol and bool(torch.isfinite(got).all())
        # in turns: plain, kernel, kernel, plain
        iters = 3 if name == "conv3x3" else 10
        p1 = cuda_ms(torch, plain, iters)
        k1 = cuda_ms(torch, kern, iters)
        k2 = cuda_ms(torch, kern, iters)
        p2 = cuda_ms(torch, plain, iters)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"kernel {name} {label}: max_abs_err={err!r} tol={tol!r} "
              f"(rtol {KERNEL_RTOL} x max|plain| {scale!r}) ms={k_ms!r} plain_ms={p_ms!r} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} {label}: kernel disagrees with its plain version")
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += k_ms
        r["plain_ms"] += p_ms
        del got, ref
    return results


def randomize_(torch, model, seed: int) -> None:
    """Seeded random weights with lecun-normal scale and BatchNorm stats
    away from the identity."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    nn = torch.nn

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=g, device=t.device) * std)

    def uniform(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=g, device=t.device) * (hi - lo) + lo)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                cin = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
                normal(w, (cin * w.shape[2] * w.shape[3]) ** -0.5)
                normal(m.bias, 0.1)
            elif isinstance(m, nn.BatchNorm2d):
                uniform(m.weight, 0.5, 1.5)
                normal(m.bias, 0.1)
                normal(m.running_mean, 0.1)
                uniform(m.running_var, 0.5, 1.5)


def slice_phase(torch, fc, card: str) -> dict:
    """The serving path end to end; returns the launch counts of its run."""
    import numpy as np

    from image_segmentation_tpu_torch.engine.export import export_model, load_model, predict
    from image_segmentation_tpu_torch.models.registry import build_model
    from image_segmentation_tpu_torch.ops.augment import normalize_image

    model = build_model("large_unet", device=DEVICE, **MODEL_ARGS)
    randomize_(torch, model, SEED)
    with tempfile.TemporaryDirectory() as art:
        export_model(model, "large_unet", MODEL_ARGS, out_dir=art)
        served = load_model(art, device=DEVICE)
    del model

    rng = np.random.default_rng(SEED)
    requests = {
        "u8 256x256": rng.integers(0, 256, (256, 256, 3), dtype=np.uint8),
        "u8 500x375": rng.integers(0, 256, (375, 500, 3), dtype=np.uint8),
        "f32 256x256": rng.uniform(0, 1, (256, 256, 3)).astype(np.float32),
    }
    u8 = torch.from_numpy(rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)).to(DEVICE)
    x16 = normalize_image(u8)
    per_forward = {"conv3x3": 8, "maxpool2x2_affine_relu": 2, "convtranspose2x2": 2}

    def counts():
        return {w.__name__: w.launches for w in fc.WRAPPERS}

    def checked(what, fn):
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in counts().items()}
        if delta != per_forward:
            raise AssertionError(f"{what}: launches {delta}, expected {per_forward}")
        return out

    # ---- the main path: counts from 0, read right after
    for w in fc.WRAPPERS:
        w.launches = 0
    for what, image in requests.items():
        mask = checked(f"predict {what}", lambda: predict(served, image))
        if mask.shape != (256, 256) or mask.min() < 0 or mask.max() >= NUM_CLASSES:
            raise AssertionError(f"predict {what}: mask {mask.shape} in [{mask.min()}, {mask.max()}]")
        print(f"predict {what}: mask {mask.shape}, class counts "
              f"{np.bincount(mask.ravel(), minlength=NUM_CLASSES).tolist()}", flush=True)
    with torch.inference_mode():
        logits = checked("forward b16", lambda: served(x16))
        logits1 = checked("forward b1", lambda: served(x16[:1]))
    launches = counts()
    n_forwards = len(requests) + 2
    if launches != {k: v * n_forwards for k, v in per_forward.items()}:
        raise AssertionError(f"main-path launches {launches} over {n_forwards} forwards")
    print(f"main path: {n_forwards} forwards, launches {launches}", flush=True)

    # ---- outputs: finite, shaped, and the kernel path agrees with the plain path
    for name, t, shape in (("b16", logits, (BATCH, SIZE, SIZE, NUM_CLASSES)),
                           ("b1", logits1, (1, SIZE, SIZE, NUM_CLASSES))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not torch.isfinite(t).all():
            raise AssertionError(f"logits {name}: {tuple(t.shape)} {t.dtype}, finite={bool(torch.isfinite(t).all())}")
    with ExitStack() as stack, torch.inference_mode():
        for w in fc.WRAPPERS:
            stack.enter_context(mock.patch.object(fc, w.__name__, getattr(fc, w.__name__ + "_plain")))
        plain_logits = served(x16)
    diff = (logits - plain_logits).abs().max().item()
    scale = plain_logits.abs().max().item()
    agree = (logits.argmax(-1) == plain_logits.argmax(-1)).float().mean().item()
    print(f"logits b16 kernel vs plain path: max_abs_diff={diff!r} (limit {LOGITS_RTOL} x "
          f"{scale!r} = {LOGITS_RTOL * scale!r}), argmax agreement={agree!r} "
          f"(limit {ARGMAX_AGREEMENT})", flush=True)
    if diff > LOGITS_RTOL * scale or agree < ARGMAX_AGREEMENT:
        raise AssertionError("kernel-path logits disagree with the plain path")
    del plain_logits

    with torch.inference_mode():
        b16 = cuda_ms(torch, lambda: served(x16), iters=3)
        b1 = cuda_ms(torch, lambda: served(x16[:1]), iters=20, warmup=3)
    print(f"serving LargeUNet@{SIZE} bf16: batch {BATCH} {BATCH * 1000.0 / b16!r} img/s "
          f"({b16!r} ms), batch 1 {b1!r} ms on {card}", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from image_segmentation_tpu_torch.ops import _build
    from image_segmentation_tpu_torch.ops import fused_conv as fc

    # fp32 references in full fp32 (cuDNN's TF32 default would not be)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)
    t0 = time.perf_counter()
    build = _build.build()
    _build.library()
    print(f"build: {build.path.name} in {build.seconds!r} s (nvcc; 0.0 = already built), "
          f"load {time.perf_counter() - t0!r} s", flush=True)
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    results = kernel_phase(torch, fc, main_path_shapes(MODEL_ARGS))
    launches = slice_phase(torch, fc, card)

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
        })
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
