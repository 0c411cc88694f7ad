#!/usr/bin/env python3
"""Where the device time of the PyTorch port's serving forward and train
step goes, on one NVIDIA GPU, and how exact its conv kernel is.

    python3 scripts/profile_torch_port.py [--mode serve|train|prompt|autoencoder|clip_res|both]

Uses ``chip_smoke.py``'s configuration (the ``large_unet`` preset at full
width, batch 16 at 512x512, bf16, seeded random weights) and its main-path
shapes; imports no jax.

``serve``:
1. For the kernel path and the all-stock path of the same weights, at batch
   16 and batch 1: CUDA-event ms per forward without the profiler, then in
   a ``torch.profiler`` trace the CUDA-event ms of the traced window and
   the device-busy ms (the sum of the kernels' device time), idle share =
   1 - busy / traced window, and the device time by group
   (``benchmark.trace.group``, the benchmark's grouping): each
   hand-written kernel, cuDNN convs and GEMMs, elementwise and copies, the
   rest by name; the idle time by the group of the kernel that ends it,
   and the host's time in each launch call (``[idle before]``, ``[host]``;
   every mode prints them).
2. cuDNN bf16 ms of each conv3x3 main-path launch (no pre-affine), for
   scale against the hand-written kernel.
3. Exactness at enc1.conv2: the kernel, its plain version and the fp64 conv
   of the same bf16 operands rounded to bf16 — in how many outputs each
   pair differs, and how far the plain fp32 sum lies from fp64.

``train``: the same trace of the large_unet ``Trainer.train_step`` on one
fixed batch (augmentation on: ``augmentations_per_datapoint=4``, one fixed
draw; forward, backward, Adam), for the kernel path and the plain path
(every wrapper replaced by its plain version) from the same weights, with
the peak device memory of each, and the kernel-path step without
augmentation.  Every mode prints the device time under each of the
program's profiler spans (``image_segmentation_tpu_torch/utils/spans.py``,
``[range] imgseg: ...`` rows, with torch's ``Optimizer.`` ranges): in the
train step ``prepare``, ``augment.geometry`` (flip, quarter turn, shifts),
``augment.colour``, every model block's forward and ``.bwd``, ``loss``,
``loss.bwd`` and ``optimizer`` (the ranges are not added to the busy
time).  Then each augmentor stage alone, traced the same way: the flip
and quarter-turn copies, the three shifts, the colour stage of either
backend, and ``apply_u8`` whole.

``prompt``: the same trace of the ``prompt`` preset's train step
(``chip_smoke.clip_config``: ClipUnetPrompt with the ViT-B/32 tower, batch
32 at 256x256, augmentation 4, one fixed batch of palette masks and one
fixed draw), kernel path and plain path, with the spans ``prepare`` (the
prompt points and maps, the augmentor), ``augment.geometry`` (the packed
geometry), ``augment.colour`` (jitter and blur), ``model.clip_tower``
(the frozen tower) and the prompt encoder's blocks
(``model.prompt_encoder.enc1`` ... ``.conv``).

``autoencoder``: the same trace of the ``autoencoder`` preset's train step
(``chip_smoke.ae_config``: batch 32 at 256x256, no augmentation, one fixed
batch; MSE reconstruction) on the kernel path and the plain path from the
same weights, and of the same step with ``w2d_impl="pallas"`` (the conv
kernels in their unfused forms, BatchNorm, pools and up-convs in PyTorch).

``clip_res``: the same trace of the ``clip_res`` preset's train step
(``chip_smoke.clip_config``: the ViT-B/32 tower and ResNet-34, batch 32 at
256x256, augmentation 4, one fixed batch and draw) on the kernel path and
the plain path, of the ``segment_classifier`` step (batch 16,
augmentation 2, palette masks) on the kernel path, and of the clip_res
eval forward at batch 32 and 1 (kernel path), with the spans
``model.clip_tower`` and ``model.resnet34`` of the frozen parts: the
backbone's share of each.

``both`` is ``serve`` and ``train``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import sys
from collections import defaultdict
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from benchmark.trace import group  # noqa: E402
from image_segmentation_tpu_torch.models.registry import build_model  # noqa: E402
from image_segmentation_tpu_torch.ops import augment as A  # noqa: E402
from image_segmentation_tpu_torch.ops import fused_conv as fc  # noqa: E402
from image_segmentation_tpu_torch.ops import roll  # noqa: E402
from image_segmentation_tpu_torch.utils import spans  # noqa: E402

MODEL_ARGS = smoke.train_config().model_args

DEVICE = smoke.DEVICE
FORWARDS = 5
TRAIN_STEPS = 3
# the program's spans and torch's optimizer ranges: annotations over
# kernels that the groups already count
RANGES = (spans.PREFIX, "Optimizer.")


def profile(fn, label: str, calls: int = FORWARDS, no_grad: bool = True) -> None:
    """Untraced CUDA-event ms per call of ``fn``, then the traced window,
    device busy time, idle share and device time by group, the idle time
    by the group of the kernel it precedes (the six largest), and the host
    time of each launch call."""
    from torch.profiler import ProfilerActivity, profile as trace

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode() if no_grad else contextlib.nullcontext():
        event_ms = smoke.cuda_ms(torch, fn, calls, warmup=2)
        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
    window_ms = start.elapsed_time(end) / calls
    groups, ranges = defaultdict(float), {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            ms = (e.self_cuda_time_total if us is None else us) / 1e3 / calls
            if e.key.startswith(RANGES):
                ranges[e.key] = ms
            else:
                groups[group(e.key)] += ms
    busy = sum(groups.values())
    print(f"== {label}: {event_ms!r} ms/call untraced; traced window {window_ms!r} ms/call, "
          f"device busy {busy!r} ms/call, idle share {1 - busy / window_ms!r}", flush=True)
    if busy == 0:
        print("   the trace holds no device time", flush=True)
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"   {name}: {ms!r} ms ({ms / busy:.3f})", flush=True)
    for name, ms in ranges.items():
        print(f"   [range] {name}: {ms!r} ms", flush=True)
    # where the idle time sits: the device's gap before each kernel (since
    # the latest end of any earlier one), summed by the kernel's group; and
    # the host's time in each launch call
    spans = sorted((e.time_range.start, e.time_range.end, group(e.name)) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(RANGES))
    idle, last = defaultdict(float), None
    for begin, finish, name in spans:
        if last is not None and begin > last:
            idle[name] += (begin - last) / 1e3 / calls
        last = finish if last is None else max(last, finish)
    for name, ms in sorted(idle.items(), key=lambda kv: -kv[1])[:6]:
        print(f"   [idle before] {name}: {ms!r} ms", flush=True)
    for e in prof.key_averages():
        if e.key in ("cudaLaunchKernel", "cudaLaunchCooperativeKernel"):
            print(f"   [host] {e.key}: {e.count / calls!r} a call, {e.cpu_time!r} us each",
                  flush=True)


def cudnn_conv_ms() -> None:
    g = torch.Generator(device=DEVICE).manual_seed(smoke.SEED)
    total = 0.0
    for label, shp, cb, co, *_ in smoke.main_path_shapes(MODEL_ARGS)["conv"]:
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
    label, shp, _, co, *_ = smoke.main_path_shapes(MODEL_ARGS)["conv"][1]
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


def serve() -> None:
    model = build_model("large_unet", device=DEVICE, **MODEL_ARGS)
    smoke.randomize_(torch, model, smoke.SEED)
    model.eval().requires_grad_(False)
    stock = build_model("large_unet", device=DEVICE).eval().requires_grad_(False)
    stock.load_state_dict(model.state_dict(), strict=True)
    x = torch.rand((smoke.BATCH, smoke.SIZE, smoke.SIZE, 3), device=DEVICE)
    for label, m in (("kernels", model), ("stock", stock)):
        for batch in (1, smoke.BATCH):
            profile(lambda m=m, x=x[:batch]: m(x), f"serve {label} b{batch}")
    del model, stock
    torch.cuda.empty_cache()
    cudnn_conv_ms()
    exactness()


def augment_stages(images, masks) -> None:
    """Each stage of the augmentor alone, batch 16 at 512x512."""
    xla, fused = A.DataAugmentor(4), A.DataAugmentor(4, backend="pallas")
    p = xla.sample(images.shape[0], torch.Generator().manual_seed(smoke.SEED)).to(DEVICE)
    n, h, w, _ = images.shape
    stacked = torch.cat([images, masks[..., None]], dim=-1)
    quarter, sx, sy = A._shear3_shifts(p.angles, n, h, w)
    rgb = stacked[..., :3]
    stages = {
        "flip + quarter-turn copies": lambda: A._quarter_turn(
            torch.where(p.flip.view(-1, 1, 1, 1), stacked.flip(2), stacked), quarter),
        "3 shifts (pack and unpack are views)": lambda: roll.unpack_u8x4(
            roll.row_shift(roll.col_shift(roll.row_shift(roll.pack_u8x4(stacked), sx), sy), sx)),
        "colour stage, backend=xla": lambda: xla._colour_stage(p, rgb, from_u8=True, dtype=torch.float32),
        "colour stage, backend=pallas (K9)": lambda: fused._colour_stage(
            p, rgb, from_u8=True, dtype=torch.float32),
        "apply_u8, backend=xla": lambda: xla.apply_u8(p, images, masks),
        "apply_u8, backend=pallas": lambda: fused.apply_u8(p, images, masks),
    }
    for label, fn in stages.items():
        profile(fn, f"augmentor stage: {label}", calls=10)


def train() -> None:
    import numpy as np

    from image_segmentation_tpu_torch.engine.train import Trainer

    cfg = smoke.train_config()
    mods = smoke.kernel_modules()
    rng = np.random.default_rng(smoke.SEED)
    shape = (cfg.batch_size, smoke.SIZE, smoke.SIZE)
    images = torch.from_numpy(rng.integers(0, 256, shape + (3,), dtype=np.uint8)).to(DEVICE)
    masks = torch.from_numpy(rng.integers(0, 3, shape, dtype=np.uint8)).to(DEVICE)
    state = None
    for label in ("kernels", "plain"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = Trainer(cfg, device=DEVICE, make_artifacts=False)
        if state is None:
            state = {k: v.clone() for k, v in t.model.state_dict().items()}
        t.model.load_state_dict(state)
        step = functools.partial(t.train_step, images, masks, smoke.STEP_KEY)
        with smoke.plain_path(mods) if label == "plain" else contextlib.nullcontext():
            profile(step, f"train step {label} b{cfg.batch_size}, augmented",
                    calls=TRAIN_STEPS, no_grad=False)
        print(f"   peak device memory {torch.cuda.max_memory_allocated()!r} B", flush=True)
        if label == "kernels":
            torch.cuda.reset_peak_memory_stats()
            t.augmentor = None
            profile(step, f"train step {label} b{cfg.batch_size}, no augmentation",
                    calls=TRAIN_STEPS, no_grad=False)
            print(f"   peak device memory {torch.cuda.max_memory_allocated()!r} B", flush=True)
        del t, step
    torch.cuda.empty_cache()
    augment_stages(images, masks)


def prompt() -> None:
    from image_segmentation_tpu_torch.engine.train import Trainer

    cfg = smoke.clip_config("prompt")
    mods = smoke.kernel_modules()
    images, raw = smoke._clip_batch(torch, smoke.SEED + 17, palette=True)
    state = None
    for label in ("kernels", "plain"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = Trainer(cfg, device=DEVICE, make_artifacts=False)
        if state is None:
            state = {k: v.clone() for k, v in t.model.state_dict().items()}
        t.model.load_state_dict(state)
        step = functools.partial(t.train_step, images, raw, smoke.STEP_KEY)
        with smoke.plain_path(mods) if label == "plain" else contextlib.nullcontext():
            profile(step, f"prompt train step {label} b{cfg.batch_size}, augmented",
                    calls=TRAIN_STEPS, no_grad=False)
        print(f"   peak device memory {torch.cuda.max_memory_allocated()!r} B", flush=True)
        del t, step


def autoencoder() -> None:
    import numpy as np

    from image_segmentation_tpu_torch.engine.train import Trainer

    mods = smoke.kernel_modules()
    rng = np.random.default_rng(smoke.SEED)
    shape = (smoke.AE_BATCH, smoke.AE_SIZE, smoke.AE_SIZE)
    images = torch.from_numpy(rng.integers(0, 256, shape + (3,), dtype=np.uint8)).to(DEVICE)
    masks = torch.zeros(shape, dtype=torch.uint8, device=DEVICE)
    state = None
    for label, impl, plain in (("kernels", None, False), ("plain", None, True),
                               ('kernels, w2d_impl="pallas"', "pallas", False)):
        cfg = smoke.ae_config(impl)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = Trainer(cfg, device=DEVICE, make_artifacts=False)
        if state is None:
            state = {k: v.clone() for k, v in t.model.state_dict().items()}
        t.model.load_state_dict(state)
        step = functools.partial(t.train_step, images, masks, smoke.STEP_KEY)
        with smoke.plain_path(mods) if plain else contextlib.nullcontext():
            profile(step, f"autoencoder train step {label} b{cfg.batch_size}",
                    calls=TRAIN_STEPS, no_grad=False)
        print(f"   peak device memory {torch.cuda.max_memory_allocated()!r} B", flush=True)
        del t, step


def clip_res() -> None:
    from image_segmentation_tpu_torch.engine.train import Trainer

    mods = smoke.kernel_modules()
    for name, batch, length in (("clip_res", smoke.PROMPT_BATCH, smoke.CLIP_RES_LENGTH),
                                ("segment_classifier", smoke.CLASS_BATCH, smoke.CLASS_LENGTH)):
        cfg = smoke.clip_config(name, batch, length)
        images, masks = smoke._clip_batch(torch, smoke.SEED + 29, palette=name != "clip_res",
                                          batch=batch)
        state = None
        for label in ("kernels", "plain") if name == "clip_res" else ("kernels",):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t = Trainer(cfg, device=DEVICE, make_artifacts=False)
            if state is None:
                state = {k: v.clone() for k, v in t.model.state_dict().items()}
            t.model.load_state_dict(state)
            step = functools.partial(t.train_step, images, masks, smoke.STEP_KEY)
            with smoke.plain_path(mods) if label == "plain" else contextlib.nullcontext():
                profile(step, f"{name} train step {label} b{batch}, augmented",
                        calls=TRAIN_STEPS, no_grad=False)
            print(f"   peak device memory {torch.cuda.max_memory_allocated()!r} B", flush=True)
            if name == "clip_res" and label == "kernels":
                model = t.model.eval()
                x = A.normalize_image(images)
                for b in (batch, 1):
                    profile(lambda b=b: model(x[:b]), f"clip_res eval forward kernels b{b}")
            del t, step


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", choices=("serve", "train", "prompt", "autoencoder", "clip_res",
                                           "both"),
                        default="both")
    mode = parser.parse_args().mode
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {smoke.card_line()}", flush=True)
    if mode in ("serve", "both"):
        serve()
    if mode in ("train", "both"):
        train()
    if mode == "prompt":
        prompt()
    if mode == "autoencoder":
        autoencoder()
    if mode == "clip_res":
        clip_res()
    return 0


if __name__ == "__main__":
    sys.exit(main())
