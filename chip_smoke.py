#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``image_segmentation_tpu_torch`` (no jax, no module of the JAX
package) through the entry points a user calls, on one card, at the full
width of the port's ``large_unet`` preset (``config.preset``):

1. prints the card (``nvidia-smi``) and builds the CUDA kernels from
   ``image_segmentation_tpu_torch/csrc`` (nvcc, one process per source,
   into ``build/kernels``);
2. kernel phase: every kernel against its plain PyTorch version at each
   shape the serving forward and the train step give it (batch 16 at
   512x512, bf16), with both times from CUDA events;
3. serving phase: a LargeUNet with random weights from a seeded generator
   is written with ``export_model``, read back with ``load_model`` on the
   card, answers ``predict`` requests and runs batch-16 and batch-1
   forwards at 512x512.  Launch counts are set to 0 before and read after,
   and the batch-16 logits are held against the same model on the plain
   versions;
4. training phase: ``Trainer(train_config(), device="cuda")`` trains one
   epoch of 3 batches and evaluates 3 (``augmentations_per_datapoint=0``).
   Launch counts are set to 0 before and read after, exact per train step
   and per eval batch; then, on one fixed batch, 3 steps of the kernel path
   against 3 steps from the same weights on the plain versions (per-step
   losses, every step-0 gradient), 5 steps that must lower the loss, and
   the train-step time, rate and peak memory of both paths;
5. prints one JSON line of per-kernel results (``launches`` counts the
   serving and the training runs), the card's name and power limit, and
   last ``{"ok": true, "device": {...}}``.

Any failure raises, so the exit code is not 0 and no result line is
printed.  Without a CUDA device the script exits at once.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack, contextmanager
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
SEED = 0
BATCH = 16
SIZE = 512
TRAIN_BATCHES = 3
# kernel vs plain, per launch: max|kernel - plain| <= KERNEL_RTOL * max|plain|
# for bf16 outputs (their rounding of two fp32 sums taken in different
# orders), SUM_RTOL * max|plain| for fp32 sums over up to 16*512*512
# pixels, taken in another order than the plain version's.
KERNEL_RTOL = 2e-2
SUM_RTOL = 1e-3
# served logits, kernel path vs plain path on the same weights and input
LOGITS_RTOL = 5e-2
ARGMAX_AGREEMENT = 0.995
# training, kernel path vs plain path from the same weights on one batch:
# |loss_k - loss_p| <= LOSS_RTOL * loss_p per step, and per step-0 gradient
# ||g_k - g_p|| <= GRAD_RL2 * ||g_p|| (bf16 roundings in other places and
# sums in other orders, compounded through the network).  The biases of
# the 3x3 convs have an exact gradient of 0 (the training-mode BatchNorm
# after each takes the mean out); what the card computes for them is bf16
# rounding, so their difference is held to GRAD_RL2 * the gradient norm of
# the same conv's weight instead.
LOSS_RTOL = 2e-2
GRAD_RL2 = 5e-2
PRE_BN_BIASES = (".conv.0.bias", ".conv.3.bias")
NUM_CLASSES = 3

KERNEL_INFO = {  # wrapper name -> (source, the TPU kernel it replaces)
    "conv3x3": ("image_segmentation_tpu_torch/csrc/conv3x3.cu",
                "image_segmentation_tpu/ops/pallas_conv.py:568"),
    "conv3x3_dgrad": ("image_segmentation_tpu_torch/csrc/conv3x3.cu",
                      "image_segmentation_tpu/ops/pallas_conv.py:1139"),
    "conv3x3_wgrad": ("image_segmentation_tpu_torch/csrc/conv3x3_bwd.cu",
                      "image_segmentation_tpu/ops/pallas_conv.py:1139"),
    "bn_relu_bwd_reduce": ("image_segmentation_tpu_torch/csrc/bn_relu_bwd.cu",
                           "image_segmentation_tpu/ops/pallas_conv.py:1462"),
    "maxpool2x2_affine_relu": ("image_segmentation_tpu_torch/csrc/pool.cu",
                               "image_segmentation_tpu/ops/pallas_conv.py:1629"),
    "maxpool2x2_affine_relu_bwd": ("image_segmentation_tpu_torch/csrc/pool.cu",
                                   "image_segmentation_tpu/ops/pallas_conv.py:1665"),
    "convtranspose2x2": ("image_segmentation_tpu_torch/csrc/convtranspose.cu",
                         "image_segmentation_tpu/ops/pallas_conv.py:1852"),
    "convtranspose2x2_bwd": ("image_segmentation_tpu_torch/csrc/convtranspose.cu",
                             "image_segmentation_tpu/ops/pallas_conv.py:1888"),
}
# launches of one serving forward, one train step and one eval batch
PER_FORWARD = {"conv3x3": 8, "maxpool2x2_affine_relu": 2, "convtranspose2x2": 2}
PER_STEP = {"conv3x3": 8, "conv3x3_dgrad": 8, "conv3x3_wgrad": 8, "bn_relu_bwd_reduce": 2,
            "maxpool2x2_affine_relu": 2, "maxpool2x2_affine_relu_bwd": 2,
            "convtranspose2x2": 2, "convtranspose2x2_bwd": 2}


def train_config():
    """The port's ``large_unet`` preset, cut to a smoke run: batch 16,
    synthetic 512x512 data of TRAIN_BATCHES batches per split, one epoch,
    no augmentation (its kernel is not ported yet)."""
    from image_segmentation_tpu_torch.config import preset

    cfg = preset("large_unet")
    data = dataclasses.replace(cfg.data, dataset="synthetic", image_size=SIZE,
                               synthetic_length=TRAIN_BATCHES * BATCH,
                               augmentations_per_datapoint=0)
    return dataclasses.replace(cfg, batch_size=BATCH, num_epochs=1, seed=SEED, data=data)


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


def counts(fc) -> dict:
    return {w.__name__: w.launches for w in fc.WRAPPERS}


def reset_counts(fc) -> None:
    for w in fc.WRAPPERS:
        w.launches = 0


def expected(per: dict, times: int = 1) -> dict:
    return {name: per.get(name, 0) * times for name in KERNEL_INFO}


@contextmanager
def plain_path(fc):
    """Every wrapper replaced by its plain version."""
    with ExitStack() as stack:
        for w in fc.WRAPPERS:
            stack.enter_context(mock.patch.object(fc, w.__name__, getattr(fc, w.__name__ + "_plain")))
        yield


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------

def main_path_shapes(model_args: dict) -> dict:
    """The level 0-1 blocks of a batch-16 512x512 LargeUNet: conv launches
    (label, (B, H, W, Ca), Cb, Co, pre-affine, decoder), pools (label,
    (B, H, W, C)) and ConvTransposes (label, (B, Hin, Win, Cin), Co)."""
    from image_segmentation_tpu_torch.models.unet import LargeUNet

    stem = model_args.get("stem_features", 32)
    e1, e2 = (model_args.get("encoder_features") or LargeUNet.default_encoder_features)[:2]
    b, s0, s1 = BATCH, SIZE, SIZE // 2
    conv = [
        ("enc1.conv1", (b, s0, s0, stem), 0, e1, False, False),
        ("enc1.conv2", (b, s0, s0, e1), 0, e1, True, False),
        ("enc2.conv1", (b, s1, s1, e1), 0, e2, False, False),
        ("enc2.conv2", (b, s1, s1, e2), 0, e2, True, False),
        ("dec4.conv1", (b, s1, s1, e1), e1, e1, False, True),
        ("dec4.conv2", (b, s1, s1, e1), 0, e1, True, True),
        ("dec5.conv1", (b, s0, s0, stem), stem, stem, False, True),
        ("dec5.conv2", (b, s0, s0, stem), 0, stem, True, True),
    ]
    pool = [("enc1.pool", (b, s0, s0, e1)), ("enc2.pool", (b, s1, s1, e2))]
    ct = [("dec4.up", (b, s1 // 2, s1 // 2, e2), e1), ("dec5.up", (b, s0 // 2, s0 // 2, e1), stem)]
    return {"conv": conv, "pool": pool, "ct": ct}


def kernel_cases(torch, fc, shapes: dict) -> list:
    """(wrapper name, label, make) for every launch of the serving forward
    and the train step; ``make()`` draws the inputs and returns the kernel
    call and the plain call, so only one case's tensors live at a time."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=DEVICE) * scale).to(bf16)

    def vec(n, lo, hi):
        return torch.rand(n, generator=g, device=DEVICE) * (hi - lo) + lo

    def small(n):
        return torch.randn(n, generator=g, device=DEVICE) * 1e-3

    cases = []
    for label, shp, cb, co, pre, dec in shapes["conv"]:
        ca = shp[-1]
        cin = ca + cb

        def conv_fwd(shp=shp, ca=ca, cb=cb, co=co, pre=pre, stats=False):
            x = randn(*shp)
            xb = randn(*shp[:3], cb) if cb else None
            w = torch.randn((co, ca + cb, 3, 3), generator=g, device=DEVICE) / (9 * (ca + cb)) ** 0.5
            bias = torch.randn(co, generator=g, device=DEVICE) * 0.1
            ab = dict(a=vec(ca, 0.5, 1.5), b=vec(ca, -0.5, 0.5)) if pre else {}
            kw = dict(x_b=xb, stats=stats, **ab)
            return (lambda: fc.conv3x3(x, w, bias, **kw)), (lambda: fc.conv3x3_plain(x, w, bias, **kw))

        def bwd_operands(shp=shp, co=co, cin=cin, affine=pre and dec):
            # the decoders' conv2 cotangent goes through bn2's affine + ReLU
            gt, y = randn(*shp[:3], co), randn(*shp[:3], co)
            w = torch.randn((co, cin, 3, 3), generator=g, device=DEVICE) / (9 * cin) ** 0.5
            aff = dict(a=vec(co, 0.5, 1.5), b=vec(co, -0.5, 0.5)) if affine else {}
            return gt, y, w, small(co), small(co), aff

        def dgrad(shp=shp, ca=ca, cb=cb, pre=pre, operands=bwd_operands):
            gt, y, w, c1, c2, aff = operands()
            kw = dict(aff)
            if pre:  # conv2: bn1's ReLU adjoint on the raw conv1 output
                kw.update(x_post=randn(*shp), a_post=vec(ca, 0.5, 1.5), b_post=vec(ca, -0.5, 0.5))
            elif cb:  # decoder conv1: dx split into [up | skip]
                kw.update(split=ca)
            return ((lambda: fc.conv3x3_dgrad(gt, y, w, c1, c2, **kw)),
                    (lambda: fc.conv3x3_dgrad_plain(gt, y, w, c1, c2, **kw)))

        def wgrad(shp=shp, ca=ca, cb=cb, pre=pre, operands=bwd_operands):
            gt, y, w, c1, c2, aff = operands()
            kw = dict(aff, x_b=randn(*shp[:3], cb) if cb else None)
            if pre:
                kw.update(a_pre=vec(ca, 0.5, 1.5), b_pre=vec(ca, -0.5, 0.5))
            x = randn(*shp)
            return ((lambda: fc.conv3x3_wgrad(gt, y, x, c1, c2, **kw)),
                    (lambda: fc.conv3x3_wgrad_plain(gt, y, x, c1, c2, **kw)))

        cases.append(("conv3x3", label, conv_fwd))
        cases.append(("conv3x3", label + " stats", lambda f=conv_fwd: f(stats=True)))
        cases.append(("conv3x3_dgrad", label, dgrad))
        cases.append(("conv3x3_wgrad", label, wgrad))
        if pre and dec:  # the decoders' bn2 reduction, at conv2's output shape
            def bnred(shp=shp, co=co):
                gt, y, a, b = randn(*shp[:3], co), randn(*shp[:3], co), vec(co, 0.5, 1.5), vec(co, -0.5, 0.5)
                return ((lambda: fc.bn_relu_bwd_reduce(gt, y, a, b)),
                        (lambda: fc.bn_relu_bwd_reduce_plain(gt, y, a, b)))
            cases.append(("bn_relu_bwd_reduce", label.split(".")[0] + ".bn2", bnred))
    for label, shp in shapes["pool"]:
        def pool(shp=shp, bwd=False):
            # few distinct values, so windows hold ties
            z = (torch.randint(-6, 7, shp, generator=g, device=DEVICE) * 0.25).to(bf16)
            a, b = vec(shp[-1], 0.5, 1.5), vec(shp[-1], -0.5, 0.5)
            if not bwd:
                return ((lambda: fc.maxpool2x2_affine_relu(z, a, b)),
                        (lambda: fc.maxpool2x2_affine_relu_plain(z, a, b)))
            dp = randn(shp[0], shp[1] // 2, shp[2] // 2, shp[3])
            return ((lambda: fc.maxpool2x2_affine_relu_bwd(z, a, b, dp)),
                    (lambda: fc.maxpool2x2_affine_relu_bwd_plain(z, a, b, dp)))
        cases.append(("maxpool2x2_affine_relu", label, pool))
        cases.append(("maxpool2x2_affine_relu_bwd", label, lambda f=pool: f(bwd=True)))
    for label, shp, co in shapes["ct"]:
        def ct(shp=shp, co=co, bwd=False):
            x = randn(*shp)
            w = torch.randn((shp[-1], co, 2, 2), generator=g, device=DEVICE) / (4 * shp[-1]) ** 0.5
            if not bwd:
                bias = torch.randn(co, generator=g, device=DEVICE) * 0.1
                return ((lambda: fc.convtranspose2x2(x, w, bias)),
                        (lambda: fc.convtranspose2x2_plain(x, w, bias)))
            gt = randn(shp[0], 2 * shp[1], 2 * shp[2], co)
            return ((lambda: fc.convtranspose2x2_bwd(x, w, gt)),
                    (lambda: fc.convtranspose2x2_bwd_plain(x, w, gt)))
        cases.append(("convtranspose2x2", label, ct))
        cases.append(("convtranspose2x2_bwd", label, lambda f=ct: f(bwd=True)))
    return cases


def compare(torch, label: str, got, ref) -> float:
    """Max abs error of a kernel's outputs against its plain version's;
    raises past the stated limits."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, ref, strict=True)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{label}[{i}]: kernel {tuple(a.shape)}/{a.dtype} vs plain "
                                 f"{tuple(b.shape)}/{b.dtype}")
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        rtol = KERNEL_RTOL if a.dtype == torch.bfloat16 else SUM_RTOL
        finite = bool(torch.isfinite(a).all())
        print(f"  {label}[{i}] {tuple(a.shape)} {str(a.dtype)[6:]}: max_abs_err={err!r} "
              f"limit {rtol} x max|plain| {scale!r}{'' if finite else ' NOT FINITE'}", flush=True)
        if not (err <= rtol * scale and finite):
            raise AssertionError(f"{label}[{i}]: kernel disagrees with its plain version")
        worst = max(worst, err)
    return worst


def kernel_phase(torch, fc, shapes: dict) -> dict:
    """Each kernel vs its plain version at every main-path shape; the ms of
    both summed per wrapper over its launches of one serving forward plus
    one train step."""
    results = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for name in KERNEL_INFO}
    for name, label, make in kernel_cases(torch, fc, shapes):
        kern, plain = make()
        err = compare(torch, f"{name} {label}", kern(), plain())
        # in turns: plain, kernel, kernel, plain
        iters = 3 if name.startswith("conv3x3") else 10
        p1 = cuda_ms(torch, plain, iters)
        k1 = cuda_ms(torch, kern, iters)
        k2 = cuda_ms(torch, kern, iters)
        p2 = cuda_ms(torch, plain, iters)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"kernel {name} {label}: ms={k_ms!r} plain_ms={p_ms!r} ok", flush=True)
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += k_ms
        r["plain_ms"] += p_ms
        del kern, plain
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------------------
# serving phase
# --------------------------------------------------------------------------

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


def serving_phase(torch, fc, card: str) -> dict:
    """The serving path end to end; returns the launch counts of its run."""
    import numpy as np

    from image_segmentation_tpu_torch.engine.export import export_model, load_model, predict
    from image_segmentation_tpu_torch.models.registry import build_model
    from image_segmentation_tpu_torch.ops.augment import normalize_image

    model_args = train_config().model_args
    model = build_model("large_unet", device=DEVICE, **model_args)
    randomize_(torch, model, SEED)
    with tempfile.TemporaryDirectory() as art:
        export_model(model, "large_unet", model_args, out_dir=art)
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
    per_forward = expected(PER_FORWARD)

    def checked(what, fn):
        before = counts(fc)
        out = fn()
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in counts(fc).items()}
        if delta != per_forward:
            raise AssertionError(f"{what}: launches {delta}, expected {per_forward}")
        return out

    # ---- the main path: counts from 0, read right after
    reset_counts(fc)
    for what, image in requests.items():
        mask = checked(f"predict {what}", lambda: predict(served, image))
        if mask.shape != (256, 256) or mask.min() < 0 or mask.max() >= NUM_CLASSES:
            raise AssertionError(f"predict {what}: mask {mask.shape} in [{mask.min()}, {mask.max()}]")
        print(f"predict {what}: mask {mask.shape}, class counts "
              f"{np.bincount(mask.ravel(), minlength=NUM_CLASSES).tolist()}", flush=True)
    with torch.inference_mode():
        logits = checked("forward b16", lambda: served(x16))
        logits1 = checked("forward b1", lambda: served(x16[:1]))
    launches = counts(fc)
    n_forwards = len(requests) + 2
    if launches != expected(PER_FORWARD, n_forwards):
        raise AssertionError(f"serving launches {launches} over {n_forwards} forwards")
    print(f"serving path: {n_forwards} forwards, launches {launches}", flush=True)

    # ---- outputs: finite, shaped, and the kernel path agrees with the plain path
    for name, t, shape in (("b16", logits, (BATCH, SIZE, SIZE, NUM_CLASSES)),
                           ("b1", logits1, (1, SIZE, SIZE, NUM_CLASSES))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not torch.isfinite(t).all():
            raise AssertionError(f"logits {name}: {tuple(t.shape)} {t.dtype}, finite={bool(torch.isfinite(t).all())}")
    with plain_path(fc), torch.inference_mode():
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
    del served
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# training phase
# --------------------------------------------------------------------------

def _grads(model) -> dict:
    return {k: p.grad.detach().float().clone() for k, p in model.named_parameters()}


def _check_gradients(torch, gk: dict, gp: dict):
    """Step-0 gradients, kernel path vs plain path; returns the largest
    relative L2 error and its parameter (see GRAD_RL2)."""
    worst = (0.0, "")
    for name, ref in gp.items():
        got = gk[name]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"gradient {name} is not finite on the kernel path")
        scale = gp[name[: -len("bias")] + "weight"] if name.endswith(PRE_BN_BIASES) else ref
        rel = (got - ref).norm().item() / max(scale.norm().item(), 1e-30)
        worst = max(worst, (rel, name))
        if rel > GRAD_RL2:
            raise AssertionError(f"gradient {name}: relative L2 {rel!r} > {GRAD_RL2}")
    return worst


def _step_ms(torch, trainer, images, masks, steps: int = 3) -> float:
    return cuda_ms(torch, lambda: trainer.train_step(images, masks), steps, warmup=1)


def training_phase(torch, fc, card: str) -> dict:
    """The train step end to end; returns the launch counts of its run."""
    from image_segmentation_tpu_torch.engine.train import Trainer

    cfg = train_config()
    trainer = Trainer(cfg, device=DEVICE, make_artifacts=False)
    print(f"trainer: large_unet preset, {trainer.num_params} params, batch {cfg.batch_size}, "
          f"{cfg.data.image_size}x{cfg.data.image_size}, bf16={cfg.bf16}", flush=True)

    # ---- the main path: counts from 0, read right after
    reset_counts(fc)
    torch.cuda.reset_peak_memory_stats()
    hist = trainer.train(1)["history"]
    torch.cuda.synchronize()
    launches = counts(fc)
    n_val = math.ceil(len(trainer.val_data) / cfg.batch_size)
    want = {k: PER_STEP.get(k, 0) * TRAIN_BATCHES + PER_FORWARD.get(k, 0) * n_val for k in KERNEL_INFO}
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected {want}")
    row = hist[0]
    if not all(math.isfinite(v) for v in row.values()):
        raise AssertionError(f"train(1) + evaluate: not finite: {row}")
    print(f"training path: {TRAIN_BATCHES} train steps + {n_val} eval batches, launches {launches}; "
          f"history {row}; peak memory {torch.cuda.max_memory_allocated()!r} B", flush=True)

    # ---- exact launches of one train step
    import numpy as np

    rng = np.random.default_rng(SEED + 7)
    images = torch.from_numpy(rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)).to(DEVICE)
    masks = torch.from_numpy(rng.integers(0, NUM_CLASSES, (BATCH, SIZE, SIZE), dtype=np.uint8)).to(DEVICE)
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    before = counts(fc)
    trainer.train_step(images, masks)
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in counts(fc).items()}
    if delta != expected(PER_STEP):
        raise AssertionError(f"one train step: launches {delta}, expected {expected(PER_STEP)}")
    print(f"one train step: launches {delta}", flush=True)

    # ---- kernel path vs plain path: 3 steps from the same weights on one batch
    def run(steps: int):
        t = Trainer(cfg, device=DEVICE, make_artifacts=False)
        t.model.load_state_dict(state)
        losses, grads = [], None
        for _ in range(steps):
            losses.append(float(t.train_step(images, masks)))
            if grads is None:
                grads = _grads(t.model)
        return t, losses, grads

    del trainer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kt, k_losses, k_grads = run(3)
    more = [float(kt.train_step(images, masks)) for _ in range(5)]
    k_ms = _step_ms(torch, kt, images, masks)
    k_mem = torch.cuda.max_memory_allocated()
    del kt
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with plain_path(fc):
        pt, p_losses, p_grads = run(3)
        p_ms = _step_ms(torch, pt, images, masks)
    p_mem = torch.cuda.max_memory_allocated()
    del pt
    torch.cuda.empty_cache()
    for i, (a, b) in enumerate(zip(k_losses, p_losses)):
        print(f"step {i} loss: kernel path {a!r}, plain path {b!r} (limit {LOSS_RTOL} relative)",
              flush=True)
        if not (math.isfinite(a) and abs(a - b) <= LOSS_RTOL * abs(b)):
            raise AssertionError(f"step {i}: kernel-path loss {a!r} vs plain {b!r}")
    worst, where = _check_gradients(torch, k_grads, p_grads)
    print(f"step-0 gradients of {len(p_grads)} parameters: largest relative L2 error {worst!r} "
          f"({where}; limit {GRAD_RL2})", flush=True)
    print(f"5 more steps on the batch, kernel path: losses {more}", flush=True)
    if not more[-1] < more[0]:
        raise AssertionError("5 steps on one fixed batch did not lower its loss")
    for what, ms, mem in (("kernel", k_ms, k_mem), ("plain", p_ms, p_mem)):
        print(f"train step LargeUNet@{SIZE} bf16 batch {BATCH}, {what} path: {ms!r} ms "
              f"({BATCH * 1000.0 / ms!r} img/s), max_memory_allocated {mem!r} B on {card}",
              flush=True)
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

    results = kernel_phase(torch, fc, main_path_shapes(train_config().model_args))
    served = serving_phase(torch, fc, card)
    trained = training_phase(torch, fc, card)

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = results[name]
        n = served[name] + trained[name]
        if n == 0:
            raise AssertionError(f"{name} was never launched on the main paths")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
