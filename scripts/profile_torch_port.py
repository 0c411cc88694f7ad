#!/usr/bin/env python3
"""Where the device time of the PyTorch port's serving forward goes, on one
NVIDIA GPU, and how exact its conv kernel is.

    python3 scripts/profile_torch_port.py

Uses ``chip_smoke.py``'s model (the ``large_unet`` preset at full width,
seeded random weights) and its main-path shapes; imports no jax.

1. For the kernel path and the all-stock path of the same weights, at batch
   16 and batch 1 (512x512, bf16): CUDA-event ms per forward without the
   profiler, then in a ``torch.profiler`` trace the CUDA-event ms of the
   traced window and the device-busy ms (the sum of the kernels' device
   time), idle share = 1 - busy / traced window, and the device time by
   group: each hand-written kernel, cuDNN convs and GEMMs, elementwise and
   copies, the rest by name.
2. cuDNN bf16 ms of each conv3x3 main-path launch (no pre-affine), for
   scale against the hand-written kernel.
3. Exactness at enc1.conv2: the kernel, its plain version and the fp64 conv
   of the same bf16 operands rounded to bf16 — in how many outputs each
   pair differs, and how far the plain fp32 sum lies from fp64.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from image_segmentation_tpu_torch.models.registry import build_model  # noqa: E402
from image_segmentation_tpu_torch.ops import fused_conv as fc  # noqa: E402

DEVICE = smoke.DEVICE
FORWARDS = 5
OWN_KERNELS = ("conv3x3_kernel", "pool_kernel", "convtranspose2x2_kernel")


def group(name: str) -> str:
    for k in OWN_KERNELS:
        if k in name:
            return k
    if any(s in name for s in ("xmma", "cudnn", "gemm", "cutlass", "conv2d")):
        return "cudnn conv/gemm"
    if any(s in name for s in ("elementwise", "copy", "Copy")):
        return "elementwise/copy"
    return "other: " + name[:60]


def profile(model, x, label: str) -> None:
    from torch.profiler import ProfilerActivity, profile as trace

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        event_ms = smoke.cuda_ms(torch, lambda: model(x), FORWARDS, warmup=2)
        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(FORWARDS):
                model(x)
            end.record()
            end.synchronize()
    window_ms = start.elapsed_time(end) / FORWARDS
    groups = defaultdict(float)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            groups[group(e.key)] += (e.self_cuda_time_total if us is None else us) / 1e3 / FORWARDS
    busy = sum(groups.values())
    print(f"== {label}: {event_ms!r} ms/forward untraced; traced window {window_ms!r} ms/forward, "
          f"device busy {busy!r} ms/forward, idle share {1 - busy / window_ms!r}", flush=True)
    if busy == 0:
        print("   the trace holds no device time", flush=True)
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"   {name}: {ms!r} ms ({ms / busy:.3f})", flush=True)


def cudnn_conv_ms() -> None:
    g = torch.Generator(device=DEVICE).manual_seed(smoke.SEED)
    total = 0.0
    for label, shp, cb, co, _ in smoke.main_path_shapes(smoke.MODEL_ARGS)["conv3x3"]:
        cin = shp[-1] + cb
        x = torch.randn((*shp[:3], cin), generator=g, device=DEVICE).to(torch.bfloat16)
        w = torch.randn((co, cin, 3, 3), generator=g, device=DEVICE).to(torch.bfloat16)
        bias = torch.zeros(co, device=DEVICE, dtype=torch.bfloat16)
        xc = x.permute(0, 3, 1, 2)  # channels-last view, as the model runs it
        ms = smoke.cuda_ms(torch, lambda: F.conv2d(xc, w, bias, padding=1), 3)
        total += ms
        print(f"cudnn bf16 conv {label}: {ms!r} ms", flush=True)
    print(f"cudnn bf16 conv, the 8 launches of one forward: {total!r} ms", flush=True)


def exactness() -> None:
    label, shp, _, co, _ = smoke.main_path_shapes(smoke.MODEL_ARGS)["conv3x3"][1]
    g = torch.Generator(device=DEVICE).manual_seed(smoke.SEED)
    ci = shp[-1]
    x = torch.randn(shp, generator=g, device=DEVICE).to(torch.bfloat16)
    w = torch.randn((co, ci, 3, 3), generator=g, device=DEVICE) / (9 * ci) ** 0.5
    bias = torch.randn(co, generator=g, device=DEVICE) * 0.1
    a = torch.rand(ci, generator=g, device=DEVICE) + 0.5
    b = torch.rand(ci, generator=g, device=DEVICE) - 0.5
    with torch.inference_mode():
        k = fc.conv3x3(x, w, bias, a=a, b=b)
        p = fc.conv3x3_plain(x, w, bias, a=a, b=b)
        bf = torch.bfloat16
        act = F.relu(x.float() * a.to(bf).float() + b.to(bf).float()).to(bf).double()
        y64 = F.conv2d(act.permute(0, 3, 1, 2), w.to(bf).double(), bias.double(), padding=1)
        y64 = y64.permute(0, 2, 3, 1)
        w32 = w.to(bf).float()
        y32 = F.conv2d(act.float().permute(0, 3, 1, 2), w32, bias.float(), padding=1)
        f64 = y64.to(bf)
        print(f"exactness {label} {tuple(shp)} -> {co}: outputs {k.numel()}, "
              f"kernel != plain {int((k != p).sum())}, kernel != fp64 {int((k != f64).sum())}, "
              f"plain != fp64 {int((p != f64).sum())}, "
              f"max|plain fp32 sum - fp64| {(y32.permute(0, 2, 3, 1).double() - y64).abs().max().item()!r}",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {smoke.card_line()}", flush=True)
    model = build_model("large_unet", device=DEVICE, **smoke.MODEL_ARGS)
    smoke.randomize_(torch, model, smoke.SEED)
    model.eval().requires_grad_(False)
    stock = build_model("large_unet", device=DEVICE).eval().requires_grad_(False)
    stock.load_state_dict(model.state_dict(), strict=True)
    x = torch.rand((smoke.BATCH, smoke.SIZE, smoke.SIZE, 3), device=DEVICE)
    for label, m in (("kernels", model), ("stock", stock)):
        for batch in (1, smoke.BATCH):
            profile(m, x[:batch], f"{label} b{batch}")
    cudnn_conv_ms()
    exactness()
    return 0


if __name__ == "__main__":
    sys.exit(main())
