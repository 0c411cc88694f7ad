#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, training, augmentation, prompt,
ClipUnet, fusion, autoencoder, ClipRes, segment-classifier, ClipAutoencoder,
robustness, data, distributed, export, profiler, converter and
tensor-parallel paths on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``image_segmentation_tpu_torch`` (no jax, no module of the JAX
package) through the entry points a user calls, on one card, at the full
width of the port's presets (``config.preset``), random weights from a seed:

1. prints the card (``nvidia-smi``) and builds the CUDA kernels from
   ``image_segmentation_tpu_torch/csrc`` (nvcc, one process per source,
   into ``build/kernels``);
2. kernel phase: every kernel against its plain PyTorch version at each
   shape the large_unet serving forward, train step and augmentor (batch 16
   at 512x512) and the prompt train step (batch 32 at 256x256, the
   1-channel heatmap included), the fold-1 blocks that ``fused_deep``
   adds to the large_unet step, and the autoencoder's train step (batch 32
   at 256x256: the fused blocks and, under ``w2d_impl="pallas"``, the conv
   kernels in their unfused forms) and the clip_res step (batch 32 at
   256x256: dec5 32 -> 16 and the output block [16 | 3] -> 3, on the
   kernels' element paths) give it, the ``Co/2`` slices that the
   tensor-parallel steps of 19 give the kernel blocks (batch 8: the level
   0-1 blocks of large_unet at 512x512 and of clip_unet at 256x256, the
   autoencoder's level 0-2 blocks at 256x256, ``Co`` 32 and dec3's 16, its
   ConvTransposes to 32 and 16, and the unet preset's fold-1
   ``fused_deep`` blocks at 256x256), the 1x1-conv backward (K11) at
   the stem and output conv of the large_unet and autoencoder steps, and
   the cross-attention kernel at the CLIP bottleneck of the prompt step's
   batch; with both times from CUDA events, the
   least time the card could take (``bound_ms``) and, where one PyTorch
   call computes the same function, that call's time (``library_ms``);
3. serving phase: a LargeUNet is written with ``export_model``, read back
   with ``load_model`` on the card, answers ``predict`` requests and runs
   batch-16 and batch-1 forwards at 512x512.  Launch counts are set to 0
   before and read after, and the batch-16 logits are held against the same
   model on the plain versions;
4. training phase: ``Trainer(train_config(), device="cuda")`` trains one
   epoch with the preset's augmentation (``augmentations_per_datapoint=4``:
   5 steps over 16 synthetic images) and evaluates.  Launch counts are set
   to 0 before and read after, exact per train step and per eval batch;
   then, on one fixed batch and one fixed augmentation draw, 3 steps of the
   kernel path against 3 steps from the same weights on the plain versions
   (per-step losses, every step-0 gradient), 5 steps that must lower the
   loss, and the train-step time, rate and peak memory of both paths, with
   and without augmentation on the kernel path;
5. augmentor phase: ``DataAugmentor(4, backend="pallas").apply_u8`` on a
   batch-16 512x512 batch launches the colour kernel once (counts from 0),
   and its output is held against ``backend="xla"`` on the same draws;
6. prompt phase: the ``prompt`` preset (ClipUnetPrompt with the ViT-B/32
   tower, point prompts from palette masks, the prompt augmentor) trains
   one epoch at batch 32, 256x256 and evaluates, with exact launch counts
   (the prompt encoder's enc1 runs its conv1 wgrad alone: one dgrad fewer
   than wgrads per step) and the kernel path held to the plain path as in
   4 (leaves that bf16 rounding dominates are held to the fp32 gradient),
   the frozen tower bit-identical after the steps;
7. ClipUnet phase: the ``clip_unet`` preset trains one epoch (exact counts)
   and its step is timed;
8. fusion phase: ``CrossAttentionFusion(512, 1)`` on the bottleneck map
   with an 8-token context launches the cross-attention kernel once and
   agrees with the plain path (no model passes it more than one token);
9. autoencoder phase: the ``autoencoder`` preset (MSE reconstruction, no
   augmentation) trains one epoch at batch 32, 256x256 and evaluates, with
   exact launch counts, 3 kernel-path steps held to the plain path as in 4,
   and its step time; then the same with ``w2d_impl="pallas"`` (each conv
   one kernel launch in its unfused form; BatchNorm, the pools and the
   up-convs in PyTorch);
10. ClipRes phase: the ``clip_res`` preset (frozen ViT-B/32 tower and
   ResNet-34, dec5 and the output block on the kernels) trains one epoch
   at batch 32, 256x256 and evaluates, with exact launch counts and 3
   kernel-path steps held to the plain path as in 4; the tower's and the
   backbone's parameters bit-identical after the steps, the backbone's
   running statistics moved; then the ``segment_classifier`` preset
   (ClipResSegmentationClassification, the class task: any-animal mask and
   cat/dog label from palette masks) at its batch 16 and augmentation 2,
   the same checks, the class head's gradient among those held; then the
   ``clip_autoencoder`` preset at batch 32 (no kernel on its model: the
   augmentor's shifts only), one epoch and its step time;
11. ClipRes serving phase: a ``clip_res`` model written with
   ``export_model``, read with ``load_model`` on the card, answers
   ``predict``; its batch-32 eval logits are held against the plain path;
   batch-32 and batch-1 forward times and the frozen backbone's share;
12. robustness and artifacts phase, the large_unet preset at 256x256
   through the CLIs: ``cli.train`` trains one epoch at batch 16 to a run
   folder (``loss.csv``, ``model_settings.json``, ``model_1.npz``; exact
   counts), the checkpoint restores bit for bit into a fresh Trainer (its
   next step's loss equal); ``cli.evaluate --robustness-int --robustness``
   evaluates it (81-line ``robustness_scores.csv``, 8 float CSVs, values in
   [0, 1], exact counts: (clean + 80 + 79 points) x batches x the forward's);
   through the ``Evaluator`` API: the identity points equal ``test()``, both
   batteries' CSVs byte-equal to the CLI's, the last point of each int
   family on the kernel path held to the plain path (the trained model's
   logits; the serving phase's randomized model's logits, argmax agreement
   and Dice); the battery times (the JAX bench's int grid at 512x512, the
   float battery, per family, the forward's share);
13. data phase: 64 ``synthetic_shapes_dataset`` images a split at 256x256
   written as ``<split>_arrays.npz`` (palette ``raw_masks``); ``cli.train
   --dataset oxford-pet --dataset-loc <dir> --native-loader`` trains the
   large_unet preset one epoch at batch 16 (exact counts) on the C++
   loader; its batches equal the Python pipeline's (unshuffled, one rank),
   and both loaders' rates to the card, in turns;
14. distributed phase: ``cli.train_distributed`` on NCCL at world size 1
   (train_config() at 512x512, exact counts, a checkpoint); then two gloo
   ranks on the card (``mesh.launch``), 8 rows each of a global batch of
   16 with augmentation, one step: the loss and the averaged gradients
   against the world-1 step on the whole batch (LOSS_RTOL, GRAD_RL2; the
   three leaves held directly nearest the limit printed with their bf16
   distance from the fp32 step), the ranks' parameters bit-identical after
   it, the gradient all-reduce's time;
15. export phase: the served LargeUNet at 512x512 written with
   ``export_model(exported_program=True)`` and read with ``load_program``:
   the ``imgseg::`` operators in its graph, its batch-16 and batch-1 logits
   (exact counts) against the eager forward, both timed;
16. profiler phase: ``cli.profiler --preset large_unet --steps 3`` (batch
   16, synthetic data) writes a trace (exact counts) and the memory report;
17. options phase, the options that are off in every preset: large_unet
   with ``fused_deep=True`` (the fold-1 kernel blocks at enc3, enc4, dec2
   and dec3) trains one epoch (exact counts), its step held to the plain
   path as in 4 and timed beside the ``fused_deep=False`` step in turns,
   and serves batch-16 and batch-1 forwards held to the plain path; the
   ``unet`` preset with ``fused_deep=True`` at 256x256 (the fused
   bottleneck, dec1 with its non-identity resize) the same way; ``remat``
   against no ``remat`` over 3 steps (parameters, Adam moments, running
   statistics bit for bit), step time and peak memory both ways; clip_unet
   at 256x256, batch 32 with ``freeze_clip=False`` against ``True`` over 3
   steps, bit for bit, the tower unchanged, step time both ways;
18. converter phase: ``cli.convert_pretrained`` on the ViT-B/32 tower of
   the clip_unet preset (saved in the transformers vision layout) and on a
   ResNet-34 (in torchvision's), random weights from SEED; each ``.npz``
   loaded back into fresh modules on the card and held bit for bit (the
   pooled embedding, batch 8 at 224x224; the feature map, batch 8 at
   256x256; the served clip_unet logits, batch 8 at 256x256, with the
   converted tower against the source tower, exact counts); then
   ``cli.check_prompt_data --device cuda`` (its 4 label checks, its
   heatmaps against the host's for the same draws);
19. tensor-parallel phase: two gloo ranks on the card at (data=1,
   model=2), one ``mesh.launch`` for all runs, each rank holding the whole
   global batch of 8 and half the output channels of every weight JAX's
   ``shard_params_tp`` shards: one step at full width of
   ``train_config()`` (512x512), of the ``clip_unet``, ``clip_res`` and
   ``segment_classifier`` presets and of ``clip_autoencoder`` (256x256,
   the frozen ViT-B/32 tower; in the ClipRes models the frozen ResNet-34
   sharded too), of the ``autoencoder`` preset (256x256, unaugmented as
   always) and of the ``unet`` preset with ``fused_deep`` and ``remat``
   together (256x256), each against the world-1 step on the same batch
   (LOSS_RTOL, GRAD_RL2, BF16_NOISE_FACTOR), the gathered parameters
   equal on both ranks, each rank's launches exactly one world-1 step's
   with every kernel block's weights on their ``Co/2`` slices (whole where
   the rule leaves them whole: ClipRes's dec5 and output block), the
   ResNet-34 unchanged by the step and its running statistics moved; each
   rank's peak memory in a second step (the checks' copies on the host)
   beside world 1's, the TP step time beside world 1 and the time of the
   model group's gathers, reduce-scatters and all-reduces in a step;
20. prints one JSON line of per-kernel results (``launches`` counts the
   main-path runs of 3-18; the wgrad kernel has a line for its launches
   beside a dgrad and one for its launches alone, and each conv kernel a
   line for its unfused form, which the ``"pallas"`` run launches), the
   card's name and power limit, and last ``{"ok": true, "device": {...}}``.

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
from typing import Callable, NamedTuple, Optional
from unittest import mock

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
SEED = 0
BATCH = 16
SIZE = 512
# 16 synthetic images, each seen aug + 1 = 5 times: 5 train steps an epoch
TRAIN_LENGTH = 16
# the augmentation draw of the fixed-batch steps (Trainer.train_step's step_key)
STEP_KEY = 1
# kernel vs plain, per launch: max|kernel - plain| <= KERNEL_RTOL * max|plain|
# for bf16 outputs (their rounding of two fp32 sums taken in different
# orders), SUM_RTOL * max|plain| for fp32 sums over up to 16*512*512
# pixels, taken in another order than the plain version's.  Integer outputs
# (the shifts move whole words) must be equal.  The colour stage: fp32
# within COLOUR_ATOL (its only sum, the per-image gray mean, is taken in
# another order; the rest is the same separately rounded fp32 ops), bf16
# within one bf16 step of the larger of the two values plus COLOUR_ATOL:
# the two fp32 values it rounds may differ by COLOUR_ATOL, which is many
# bf16 steps at the outputs near 0 (down to 1e-11) that the blur gives.
KERNEL_RTOL = 2e-2
SUM_RTOL = 1e-3
# launches per timing of a conv kernel and its library call (~1 ms each)
CONV_ITERS = 20
COLOUR_ATOL = 1e-5
# served logits, kernel path vs plain path on the same weights and input
LOGITS_RTOL = 5e-2
ARGMAX_AGREEMENT = 0.995
# training, kernel path vs plain path from the same weights on one batch:
# |loss_k - loss_p| <= LOSS_RTOL * loss_p per step, and per step-0 gradient
# ||g_k - g_p|| <= GRAD_RL2 * ||g_p|| (bf16 roundings in other places and
# sums in other orders, compounded through the network).  Some biases have
# a gradient that a training-mode BatchNorm cancels: the 3x3 convs' exactly
# (the BatchNorm after each takes the mean out), and the one-token CLIP
# fusion's nearly (it adds the same vector to every image's map, and
# dec1's BatchNorm takes the batch mean out, up to the ConvTranspose's
# phases and the resize).  What the card computes for them is mostly bf16
# rounding, so their difference is held to GRAD_RL2 * the gradient norm of
# the same layer's weight instead.
LOSS_RTOL = 2e-2
GRAD_RL2 = 5e-2
# Some bf16 gradients are dominated by rounding: the prompt model's prompt
# encoder and deep levels, where the plain path in bf16 is 20-60 % (relative
# L2) from the same step in fp32, and the deep levels of the U-Nets, once
# the conv kernels round their outputs where the plain path does not (a ReLU
# mask near 0 flips).  Two bf16 paths that round in other places cannot
# agree to GRAD_RL2 there.  Such a leaf, and only one whose plain bf16
# gradient is itself more than GRAD_RL2 from the fp32 step's, is held
# instead to the fp32 gradient: the kernel path no further from it than
# BF16_NOISE_FACTOR times the plain bf16 path.
BF16_NOISE_FACTOR = 1.5
CANCELLED_BIASES = (".conv.0.bias", ".conv.3.bias", ".cross_attn.in_proj_bias",
                    ".cross_attn.out_proj.bias")
NUM_CLASSES = 3
# The card's peaks for bound_ms (H100 SXM data sheet, dense): device memory
# bytes/s, bf16 tensor-core FLOP/s (the convs), fp32 FLOP/s outside the
# tensor cores (the elementwise kernels).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
# The entries whose kernels run on the tensor cores: their lines print the
# TFLOP/s and the share of the bound reached
TENSOR_CORE_ENTRIES = ("conv3x3", "convtranspose2x2", "cross_attention", "conv1x1_bwd")
# The entries whose kernel-phase lines also give the device time of each
# CUDA kernel of the call (torch.profiler) beside the event time of the
# wrapper's whole call
DEVICE_TIMED_ENTRIES = ("row_shift", "col_shift", "preprocess")
# fp32 operations of the colour stage per pixel: normalize 3, brightness 9,
# the gray mean 5, contrast 14, saturation 19, the HSV round trip ~70 (with
# its clips), the two blur passes 60
PREPROCESS_OPS_PER_PIXEL = 180

# One line of the kernels JSON per entry: entry -> (wrapper, source, the TPU
# kernel it replaces).  The wgrad kernel has two: launched beside a dgrad
# (the merged backward's wgrad half) and alone, for a block input that takes
# no gradient (the prompt heatmap; ``_folded_wgrad_pallas``).  Each conv
# kernel has one more ("... unfused"): its plain form, with no affine,
# statistics or cotangent transform, which a block of ``w2d_impl="pallas"``
# launches once per conv (``make_folded_conv3x3``).
KERNEL_INFO = {
    "conv3x3": ("conv3x3", "image_segmentation_tpu_torch/csrc/conv3x3.cu",
                "image_segmentation_tpu/ops/pallas_conv.py:568"),
    "conv3x3_dgrad": ("conv3x3_dgrad", "image_segmentation_tpu_torch/csrc/conv3x3.cu",
                      "image_segmentation_tpu/ops/pallas_conv.py:1139"),
    "conv3x3_wgrad": ("conv3x3_wgrad", "image_segmentation_tpu_torch/csrc/conv3x3_bwd.cu",
                      "image_segmentation_tpu/ops/pallas_conv.py:1139"),
    "conv3x3_wgrad alone": ("conv3x3_wgrad", "image_segmentation_tpu_torch/csrc/conv3x3_bwd.cu",
                            "image_segmentation_tpu/ops/pallas_conv.py:822"),
    "bn_relu_bwd_reduce": ("bn_relu_bwd_reduce", "image_segmentation_tpu_torch/csrc/bn_relu_bwd.cu",
                           "image_segmentation_tpu/ops/pallas_conv.py:1462"),
    "maxpool2x2_affine_relu": ("maxpool2x2_affine_relu", "image_segmentation_tpu_torch/csrc/pool.cu",
                               "image_segmentation_tpu/ops/pallas_conv.py:1629"),
    "maxpool2x2_affine_relu_bwd": ("maxpool2x2_affine_relu_bwd",
                                   "image_segmentation_tpu_torch/csrc/pool.cu",
                                   "image_segmentation_tpu/ops/pallas_conv.py:1665"),
    "convtranspose2x2": ("convtranspose2x2", "image_segmentation_tpu_torch/csrc/convtranspose.cu",
                         "image_segmentation_tpu/ops/pallas_conv.py:1852"),
    "convtranspose2x2_bwd": ("convtranspose2x2_bwd",
                             "image_segmentation_tpu_torch/csrc/convtranspose.cu",
                             "image_segmentation_tpu/ops/pallas_conv.py:1888"),
    "row_shift": ("row_shift", "image_segmentation_tpu_torch/csrc/shift.cu",
                  "image_segmentation_tpu/ops/pallas_roll.py:55"),
    "col_shift": ("col_shift", "image_segmentation_tpu_torch/csrc/shift.cu",
                  "image_segmentation_tpu/ops/pallas_roll.py:55"),
    "preprocess": ("preprocess", "image_segmentation_tpu_torch/csrc/preprocess.cu",
                   "image_segmentation_tpu/ops/pallas_preprocess.py:147"),
    "cross_attention": ("cross_attention", "image_segmentation_tpu_torch/csrc/cross_attention.cu",
                        "image_segmentation_tpu/ops/cross_attention.py:82"),
    "conv1x1_bwd": ("conv1x1_bwd", "image_segmentation_tpu_torch/csrc/conv1x1_bwd.cu",
                    "image_segmentation_tpu/ops/pallas_conv.py:1343"),
    "conv3x3 unfused": ("conv3x3", "image_segmentation_tpu_torch/csrc/conv3x3.cu",
                        "image_segmentation_tpu/ops/pallas_conv.py:1932"),
    "conv3x3_dgrad unfused": ("conv3x3_dgrad", "image_segmentation_tpu_torch/csrc/conv3x3.cu",
                              "image_segmentation_tpu/ops/pallas_conv.py:1932"),
    "conv3x3_wgrad unfused": ("conv3x3_wgrad", "image_segmentation_tpu_torch/csrc/conv3x3_bwd.cu",
                              "image_segmentation_tpu/ops/pallas_conv.py:1932"),
}
WRAPPER_NAMES = tuple(dict.fromkeys(w for w, _, _ in KERNEL_INFO.values()))
# launches of one serving forward, one train step, one eval batch and one
# augmentor call with backend="pallas" of the large_unet preset; the stem's
# and the output conv's backward are K11 (conv1x1_bwd) in every train step
PER_FORWARD = {"conv3x3": 8, "maxpool2x2_affine_relu": 2, "convtranspose2x2": 2}
PER_STEP = {"conv3x3": 8, "conv3x3_dgrad": 8, "conv3x3_wgrad": 8, "bn_relu_bwd_reduce": 2,
            "maxpool2x2_affine_relu": 2, "maxpool2x2_affine_relu_bwd": 2,
            "convtranspose2x2": 2, "convtranspose2x2_bwd": 2, "row_shift": 2, "col_shift": 1,
            "conv1x1_bwd": 2}
PER_AUGMENT = {"row_shift": 2, "col_shift": 1, "preprocess": 1}
# the prompt preset (batch 32 at 256x256): the trunk's enc1, enc2, dec3 and
# dec4 and the prompt encoder's enc1 and enc2 on the kernels; enc1 of the
# prompt encoder reads the heatmap with input_grad=False, so conv1 there
# runs its wgrad alone (one dgrad fewer than wgrads per step); the two
# shears of rows and one of columns run on the (2n, H, W) packed stack of
# image + mask words and heatmap bits
PROMPT_BATCH, PROMPT_SIZE = 32, 256
PROMPT_LENGTH = 32  # images per split: 5 augmented train steps and 1 eval batch an epoch
PER_PROMPT_FORWARD = {"conv3x3": 12, "maxpool2x2_affine_relu": 4, "convtranspose2x2": 2}
PER_PROMPT_STEP = {"conv3x3": 12, "conv3x3_dgrad": 11, "conv3x3_wgrad": 12,
                   "bn_relu_bwd_reduce": 2, "maxpool2x2_affine_relu": 4,
                   "maxpool2x2_affine_relu_bwd": 4, "convtranspose2x2": 2,
                   "convtranspose2x2_bwd": 2, "row_shift": 2, "col_shift": 1,
                   "conv1x1_bwd": 2}
# the cross-attention kernel on the CLIP bottleneck of a 256x256 batch of 32
# (a 32x32 map, 512 wide) with a multi-token context: no model of the repo
# passes one (every model fuses the pooled embedding, one token, which takes
# the exact one-key path), so the fusion phase drives it on its own at
# ClipUnet's one head with FUSION_TOKENS tokens
FUSION_TOKENS, FUSION_HEADS = 8, 1
# the autoencoder preset (batch 32 at 256x256, no augmentation, as
# bench_extra.py measures it on the JAX side): enc1, enc2, dec1, dec2 and
# dec3 on the kernel blocks (the ConvTranspose kernel at dec1 too, whose
# input is 32 wide: JAX gates its own kernel by width there, the port runs
# it at every width), enc3 and the bottleneck on cuDNN, K11 at the stem and
# the output; under w2d_impl="pallas" the same five blocks launch one
# unfused conv kernel per conv (and its dgrad and wgrad), with BatchNorm,
# the pools and the up-convs in PyTorch
AE_BATCH, AE_SIZE = 32, 256
AE_LENGTH = 64  # images per split: 2 train steps and 2 eval batches an epoch
PER_AE_FORWARD = {"conv3x3": 10, "maxpool2x2_affine_relu": 2, "convtranspose2x2": 3}
PER_AE_STEP = {"conv3x3": 10, "conv3x3_dgrad": 10, "conv3x3_wgrad": 10, "bn_relu_bwd_reduce": 3,
               "maxpool2x2_affine_relu": 2, "maxpool2x2_affine_relu_bwd": 2,
               "convtranspose2x2": 3, "convtranspose2x2_bwd": 3, "conv1x1_bwd": 2}
PER_AE_UNFUSED_FORWARD = {"conv3x3": 10}
PER_AE_UNFUSED_STEP = {"conv3x3": 10, "conv3x3_dgrad": 10, "conv3x3_wgrad": 10, "conv1x1_bwd": 2}
# the clip_res preset (batch 32 at 256x256, augmentation 4): dec5 (the
# ConvTranspose kernel 32 -> 16 from 128x128, then a fused 16 -> 16 block)
# and the output block, whose conv1 reads [dec5 | image] (16 | 3 -> 3) and
# whose conv2 is 3 -> 3, on the kernels; dec1-dec4 on cuDNN; no 1x1 kernel.
# segment_classifier (batch 16, augmentation 2): the same dec5, then a plain
# 1x1 mask head.  clip_autoencoder (batch 32, augmentation 4): no kernel
# block; the augmentor's shifts.
CLIP_RES_LENGTH = 32  # images per split: 5 augmented train steps and 1 eval batch an epoch
PER_CLIP_RES_FORWARD = {"conv3x3": 4, "convtranspose2x2": 1}
PER_CLIP_RES_STEP = {"conv3x3": 4, "conv3x3_dgrad": 4, "conv3x3_wgrad": 4, "bn_relu_bwd_reduce": 2,
                     "convtranspose2x2": 1, "convtranspose2x2_bwd": 1, "row_shift": 2,
                     "col_shift": 1}
CLASS_BATCH, CLASS_LENGTH = 16, 16  # the preset's batch; 3 augmented train steps, 1 eval batch
PER_CLASS_FORWARD = {"conv3x3": 2, "convtranspose2x2": 1}
PER_CLASS_STEP = {"conv3x3": 2, "conv3x3_dgrad": 2, "conv3x3_wgrad": 2, "bn_relu_bwd_reduce": 1,
                  "convtranspose2x2": 1, "convtranspose2x2_bwd": 1, "row_shift": 2,
                  "col_shift": 1}
PER_AUG_ONLY_STEP = {"row_shift": 2, "col_shift": 1}
# fused_deep=True, off in every preset: the deep blocks that JAX's gate
# (unet.py:161-178, 6 MiB of conv weight) puts on the fold-1 kernel blocks
# (models/fused.py); the bottleneck's and dec1's weights exceed the cap in
# large_unet.  Each adds its two convs to the 8 of levels 0-1, and a BN-ReLU
# reduction: a fold-1 block activates its own output.
FUSED_DEEP_BLOCKS = {"large_unet": ["enc3", "enc4", "dec2", "dec3"],
                     "unet": ["enc3", "bottleneck", "dec1", "dec2"]}
PER_FD_FORWARD = dict(PER_FORWARD, conv3x3=16)
PER_FD_STEP = dict(PER_STEP, conv3x3=16, conv3x3_dgrad=16, conv3x3_wgrad=16, bn_relu_bwd_reduce=6)
# the unet preset's fused_deep run (its only fused bottleneck, and dec1,
# whose resize is not the identity); batch 16
UNET_SIZE = 256
OPTION_STEPS = 3
# the robustness phase: the large_unet preset through the three CLIs, which
# take the preset's 256x256 images and 100 synthetic images a split
# (config.py); the train CLI at batch 16 (the preset's 150 is ~9.8 M pixels a
# step, twice the training phase's), the evaluate CLI at its default batch
ROBUST_BATCH, EVAL_BATCH = 16, 8
# the JAX bench's battery cell (bench_extra.py:267): the int 8x10 grid over
# synthetic_dataset(64, 512, 512, seed=7) at batch 8
BENCH_LENGTH, BENCH_SIZE, BENCH_SEED, BENCH_BATCH = 64, 512, 7, 8
# the Evaluator's two paths and the identity points agree to this
EVAL_ATOL = 1e-6


def train_config(name: str = "large_unet", size: Optional[int] = None, **model_args):
    """The port's ``large_unet`` preset (or the U-Net preset ``name``), cut
    to a smoke run: batch 16, synthetic ``size`` (SIZE) square data of
    TRAIN_LENGTH images per split, one epoch, the preset's augmentation
    (``augmentations_per_datapoint=4``); ``model_args`` added to the
    preset's."""
    from image_segmentation_tpu_torch.config import preset

    cfg = preset(name)
    data = dataclasses.replace(cfg.data, dataset="synthetic", image_size=size or SIZE,
                               synthetic_length=TRAIN_LENGTH)
    return dataclasses.replace(cfg, batch_size=BATCH, num_epochs=1, seed=SEED, data=data,
                               model_args=dict(cfg.model_args, **model_args))


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


def device_us(torch, fn, iters: int) -> dict:
    """Mean device microseconds per call of ``fn``, by CUDA kernel name,
    from ``torch.profiler`` after one warm-up call; raises if the trace
    holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        if total > 0:
            out[evt.key] = total / iters
    if not out:
        raise AssertionError("torch.profiler shows no device time for the call")
    return out


def kernel_modules():
    """The port's modules of kernel wrappers, each with ``WRAPPERS``."""
    from image_segmentation_tpu_torch.ops import (
        conv1x1, cross_attention, fused_conv, preprocess, roll)

    return (fused_conv, conv1x1, roll, preprocess, cross_attention)


def counts(mods) -> dict:
    return {w.__name__: w.launches for m in mods for w in m.WRAPPERS}


def reset_counts(mods) -> None:
    for m in mods:
        for w in m.WRAPPERS:
            w.launches = 0


def expected(per: dict, times: int = 1) -> dict:
    return {name: per.get(name, 0) * times for name in WRAPPER_NAMES}


def entry_launches(launches: dict, unfused: dict) -> dict:
    """Wrapper counts -> KERNEL_INFO entries.  ``unfused``: the counts of
    the ``w2d_impl="pallas"`` run, whose conv kernels all run in their
    unfused forms (and no other conv form runs there); ``launches``: those
    of the other runs, where every block backward pairs a wgrad with a dgrad
    except conv1's of an input_grad=False block, so the wgrads without a
    dgrad are the wgrad-alone launches."""
    out = {entry: launches[w] + unfused[w] for entry, (w, _, _) in KERNEL_INFO.items()}
    for w in ("conv3x3", "conv3x3_dgrad", "conv3x3_wgrad"):
        out[w], out[w + " unfused"] = launches[w], unfused[w]
    alone = launches["conv3x3_wgrad"] - launches["conv3x3_dgrad"]
    out["conv3x3_wgrad alone"] = alone
    out["conv3x3_wgrad"] -= alone
    return out


@contextmanager
def plain_path(mods):
    """Every wrapper of every kernel module replaced by its plain version."""
    with ExitStack() as stack:
        for m in mods:
            for w in m.WRAPPERS:
                stack.enter_context(mock.patch.object(m, w.__name__, getattr(m, w.__name__ + "_plain")))
        yield


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------

class Conv(NamedTuple):
    """One conv of a kernel block: its input (B, H, W, Ca), the skip's Cb,
    Co, whether bn1's affine + ReLU is applied on load (conv2), whether its
    block activates its own output (``dec``: the decoders, and the fold-1
    encoders of ``fused_deep``, whose pool is the standard one; its conv2's
    backward takes bn2's affine and a BN-ReLU reduction), whether its
    wgrad runs alone (input_grad=False), and
    whether it is a conv of the unfused family (``w2d_impl="pallas"``: no
    affine, statistics or cotangent transform)."""

    label: str
    shape: tuple
    cb: int
    co: int
    pre: bool
    dec: bool
    alone: bool = False
    unfused: bool = False


def level01_shapes(b: int, size: int, stem: int, e1: int, e2: int, decs=("dec4", "dec5"),
                   encs=("enc1", "enc2")) -> dict:
    """The level 0-1 kernel blocks of a U-Net trunk at batch b: convs, pools
    (label, (B, H, W, C)), ConvTransposes (label, (B, Hin, Win, Cin), Co)
    and the 1x1 convs of the stem and the output, K11 (label, (B, H, W, Ci),
    Co, whether dx is asked for)."""
    s0, s1 = size, size // 2
    (n1, n2), (d1, d0) = encs, decs
    conv = [
        Conv(f"{n1}.conv1", (b, s0, s0, stem), 0, e1, False, False),
        Conv(f"{n1}.conv2", (b, s0, s0, e1), 0, e1, True, False),
        Conv(f"{n2}.conv1", (b, s1, s1, e1), 0, e2, False, False),
        Conv(f"{n2}.conv2", (b, s1, s1, e2), 0, e2, True, False),
        Conv(f"{d1}.conv1", (b, s1, s1, e1), e1, e1, False, True),
        Conv(f"{d1}.conv2", (b, s1, s1, e1), 0, e1, True, True),
        Conv(f"{d0}.conv1", (b, s0, s0, stem), stem, stem, False, True),
        Conv(f"{d0}.conv2", (b, s0, s0, stem), 0, stem, True, True),
    ]
    pool = [(f"{n1}.pool", (b, s0, s0, e1)), (f"{n2}.pool", (b, s1, s1, e2))]
    ct = [(f"{d1}.up", (b, s1 // 2, s1 // 2, e2), e1), (f"{d0}.up", (b, s0 // 2, s0 // 2, e1), stem)]
    return {"conv": conv, "pool": pool, "ct": ct, "1x1": stem_out_shapes(b, size, stem)}


def stem_out_shapes(b: int, size: int, stem: int) -> list:
    """K11 at the stem (3 -> stem, the image takes no gradient) and the
    output conv (stem -> 3)."""
    return [("stem", (b, size, size, 3), stem, False), ("out", (b, size, size, stem), 3, True)]


def main_path_shapes(model_args: dict) -> dict:
    """The level 0-1 blocks of a batch-16 512x512 LargeUNet."""
    from image_segmentation_tpu_torch.models.unet import LargeUNet

    stem = model_args.get("stem_features", 32)
    e1, e2 = (model_args.get("encoder_features") or LargeUNet.default_encoder_features)[:2]
    return level01_shapes(BATCH, SIZE, stem, e1, e2)


def ae_path_shapes(unfused: bool = False, b: Optional[int] = None) -> dict:
    """The kernel blocks of the autoencoder preset at batch ``b`` (AE_BATCH,
    32), 256x256: enc1 (32 -> 64) and enc2 (64 -> 64) with their pools,
    dec1 (64 -> 64 at 64x64), dec2 (64 -> 64 at 128x128) and dec3 (32 -> 32
    at 256x256) after their ConvTransposes (64 -> 64, 64 -> 64, 64 -> 32),
    no skips; K11 at the stem and the output.  With ``unfused``, the same
    convs in the unfused forms of the ``w2d_impl="pallas"`` blocks, alone."""
    b, s = b or AE_BATCH, AE_SIZE
    blocks = [("enc1", s, 32, 64, False), ("enc2", s // 2, 64, 64, False),
              ("dec1", s // 4, 64, 64, True), ("dec2", s // 2, 64, 64, True),
              ("dec3", s, 32, 32, True)]
    conv = []
    for name, side, cin, co, dec in blocks:
        conv += [Conv(f"{name}.conv1", (b, side, side, cin), 0, co, False, dec, unfused=unfused),
                 Conv(f"{name}.conv2", (b, side, side, co), 0, co, not unfused, dec,
                      unfused=unfused)]
    if unfused:
        return {"conv": conv, "pool": [], "ct": [], "1x1": []}
    pool = [("enc1.pool", (b, s, s, 64)), ("enc2.pool", (b, s // 2, s // 2, 64))]
    ct = [(f"{name}.up", (b, side // 2, side // 2, 64), co)
          for name, side, _, co, dec in blocks if dec]
    return {"conv": conv, "pool": pool, "ct": ct, "1x1": stem_out_shapes(b, s, 32)}


def clip_res_path_shapes() -> dict:
    """The kernel blocks of the clip_res preset at batch 32, 256x256: dec5's
    ConvTranspose (32 -> 16 from 128x128) and block (16 -> 16), and the
    output block, conv1 on [dec5 | image] (16 | 3 -> 3) and conv2 3 -> 3;
    the BN-ReLU reductions at 16 and 3 channels come with the decoders'
    conv2.  No channel count here is a multiple of 8 but 16, so the conv
    kernels take their element paths."""
    b, s = PROMPT_BATCH, PROMPT_SIZE
    conv = [Conv("clip_res dec5.conv1", (b, s, s, 16), 0, 16, False, True),
            Conv("clip_res dec5.conv2", (b, s, s, 16), 0, 16, True, True),
            Conv("clip_res out.conv1", (b, s, s, 16), 3, 3, False, True),
            Conv("clip_res out.conv2", (b, s, s, 3), 0, 3, True, True)]
    return {"conv": conv, "pool": [], "ct": [("clip_res dec5.up", (b, s // 2, s // 2, 32), 16)],
            "1x1": []}


def deep_path_shapes(model: str = "large_unet", b: Optional[int] = None,
                     size: Optional[int] = None) -> dict:
    """The fold-1 blocks that ``fused_deep=True`` adds (``FUSED_DEEP_BLOCKS``)
    to a batch-``b`` (BATCH) ``size`` x ``size`` (SIZE) U-Net: in LargeUNet
    enc3 (128 -> 256 at 1/4 of the image side), enc4 (256 -> 512 at 1/8),
    dec2 ([256 | 256] -> 256 at 1/8) and dec3 ([128 | 128] -> 128 at 1/4);
    in UNet the same shapes as enc3, the bottleneck, dec1 and dec2.  Each
    activates its own output (the standard pool, the standard up-conv), so
    each conv2 takes bn2's affine in its backward and a BN-ReLU reduction."""
    b, size = b or BATCH, size or SIZE
    conv = []
    for name, (div, ca, cb, co) in zip(FUSED_DEEP_BLOCKS[model], (
            (4, 128, 0, 256), (8, 256, 0, 512), (8, 256, 256, 256), (4, 128, 128, 128))):
        side = size // div
        conv += [Conv(f"fused_deep {name}.conv1", (b, side, side, ca), cb, co, False, True),
                 Conv(f"fused_deep {name}.conv2", (b, side, side, co), 0, co, True, True)]
    return {"conv": conv, "pool": [], "ct": [], "1x1": []}


def tp_shapes(shapes: dict, label: str, m: int) -> dict:
    """``shapes`` as the model ranks of a tensor-parallel step launch them:
    each conv, pool and ConvTranspose on its ``Co/m`` output slice (its
    input whole); K11 (the stem and output convs, never sharded) left out."""
    conv = [c._replace(label=f"{label} {c.label}", co=c.co // m) for c in shapes["conv"]]
    pool = [(f"{label} {n}", (*shp[:3], shp[3] // m)) for n, shp in shapes["pool"]]
    ct = [(f"{label} {n}", shp, co // m) for n, shp, co in shapes["ct"]]
    return {"conv": conv, "pool": pool, "ct": ct, "1x1": []}


def tp_path_shapes() -> list:
    """The kernel blocks of the tensor-parallel phase's steps at M =
    TP_RANKS, batch TP_BATCH, every conv and ConvTranspose there sharded:
    the level 0-1 blocks of large_unet (512x512) and of clip_unet (256x256,
    the unet run's too), the autoencoder's level 0-2 blocks (``Co/2`` = 32,
    dec3 16; the ConvTransposes 64 -> 32 and 64 -> 16), and the fold-1
    blocks of the unet run's ``fused_deep`` (UNET_SIZE).  The ClipRes runs'
    dec5 and output block are whole: the clip_res rows."""
    b = TP_BATCH
    return [tp_shapes(level01_shapes(b, SIZE, 32, 64, 128), "tp large_unet", TP_RANKS),
            tp_shapes(level01_shapes(b, PROMPT_SIZE, 32, 64, 128, decs=("dec3", "dec4")),
                      "tp clip_unet", TP_RANKS),
            tp_shapes(ae_path_shapes(b=b), "tp autoencoder", TP_RANKS),
            tp_shapes(deep_path_shapes("unet", b, UNET_SIZE), "tp unet", TP_RANKS)]


def path_shapes() -> list:
    """(shapes, mode) of every main path, ``mode`` as in :func:`kernel_cases`:
    the large_unet step summed into the JSON line; the prompt step and the
    autoencoder's kernel blocks checked; the autoencoder's unfused convs
    summed into the "... unfused" lines; the clip_res level, the
    ``fused_deep`` blocks and the tensor-parallel slices timed on lines of
    their own."""
    return [(main_path_shapes(train_config().model_args), "sum"), (prompt_path_shapes(), None),
            (ae_path_shapes(), None), (ae_path_shapes(unfused=True), "sum"),
            (clip_res_path_shapes(), "line"), (deep_path_shapes(), "line"),
            *((shapes, "line") for shapes in tp_path_shapes())]


def prompt_path_shapes() -> dict:
    """The kernel blocks of the prompt preset's ClipUnetPrompt at batch 32,
    256x256: the trunk's (stem 32, enc1 64, enc2 128; dec3, dec4) and the
    prompt encoder's enc1 (the 1-channel heatmap, input_grad=False) and
    enc2."""
    b, s0, s1 = PROMPT_BATCH, PROMPT_SIZE, PROMPT_SIZE // 2
    shapes = level01_shapes(b, s0, 32, 64, 128, decs=("dec3", "dec4"))
    shapes["conv"] += [
        Conv("prompt enc1.conv1", (b, s0, s0, 1), 0, 32, False, False, alone=True),
        Conv("prompt enc1.conv2", (b, s0, s0, 32), 0, 32, True, False),
        Conv("prompt enc2.conv1", (b, s1, s1, 32), 0, 64, False, False),
        Conv("prompt enc2.conv2", (b, s1, s1, 64), 0, 64, True, False),
    ]
    shapes["pool"] += [("prompt enc1.pool", (b, s0, s0, 32)), ("prompt enc2.pool", (b, s1, s1, 64))]
    shapes["1x1"] = []  # K11's shapes here are the autoencoder's (stem 32 at batch 32, 256x256)
    return shapes


class Case(NamedTuple):
    """One kernel launch of a main path, beside its plain version.

    ``inputs``: the tensors the function reads (each counted once for the
    bound; the outputs are counted from the result); ``ops``: its
    arithmetic, at the peak ``flop_per_s``; ``library``: one PyTorch call
    that computes the same function, or None; ``tol``: "default" (the
    relative limits), "exact", "colour" (COLOUR_ATOL) or "bf16_step"."""

    kern: Callable
    plain: Callable
    inputs: list
    ops: float = 0.0
    flop_per_s: float = FP32_FLOP_PER_S
    library: Optional[Callable] = None
    tol: str = "default"


def kernel_cases(torch, mods, groups: list) -> list:
    """(KERNEL_INFO entry, label, timed, make) for every launch of the
    serving forward, the large_unet train step and the augmentor, of the
    prompt and autoencoder train steps (``groups``: (shapes, mode), see
    :func:`path_shapes`) and of the fusion phase, and for edge checks.
    ``timed``: "sum" (timed, and summed into the entry's line of the JSON:
    the large_unet step's launches, the wgrad alone of the prompt step, the
    unfused convs of the autoencoder step, the fusion phase's attention),
    "line" (timed and printed on its own line) or None (checked only).
    ``make()`` draws the inputs and returns a :class:`Case`, so only one
    case's tensors live at a time."""
    import torch.nn.functional as F

    from image_segmentation_tpu_torch.ops.augment import DataAugmentor, _shear3_shifts

    fc, c11, roll, pp, xattn = mods
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=DEVICE) * scale).to(bf16)

    def vec(n, lo, hi):
        return torch.rand(n, generator=g, device=DEVICE) * (hi - lo) + lo

    def small(n):
        return torch.randn(n, generator=g, device=DEVICE) * 1e-3

    def nchw(t):  # the channels-last view cuDNN takes
        return t.permute(0, 3, 1, 2)

    cases = []
    def of_paths(kind):
        return [(item, mode) for shapes, mode in groups for item in shapes[kind]]

    for (label, shp, cb, co, pre, dec, alone, unfused), mode in of_paths("conv"):
        ca = shp[-1]
        cin = ca + cb
        flops = 2.0 * shp[0] * shp[1] * shp[2] * cin * co * 9

        def conv_fwd(shp=shp, ca=ca, cb=cb, co=co, pre=pre, stats=False, flops=flops):
            x = randn(*shp)
            xb = randn(*shp[:3], cb) if cb else None
            w = torch.randn((co, ca + cb, 3, 3), generator=g, device=DEVICE) / (9 * (ca + cb)) ** 0.5
            bias = torch.randn(co, generator=g, device=DEVICE) * 0.1
            ab = dict(a=vec(ca, 0.5, 1.5), b=vec(ca, -0.5, 0.5)) if pre else {}
            kw = dict(x_b=xb, stats=stats, **ab)
            xl = nchw(x if xb is None else torch.cat([x, xb], -1))
            wl, bl = w.to(bf16).contiguous(memory_format=torch.channels_last), bias.to(bf16)
            return Case((lambda: fc.conv3x3(x, w, bias, **kw)),
                        (lambda: fc.conv3x3_plain(x, w, bias, **kw)),
                        [x, xb, w, bias, *ab.values()], flops, BF16_FLOP_PER_S,
                        lambda: F.conv2d(xl, wl, bl, padding=1))

        def bwd_operands(shp=shp, co=co, cin=cin, affine=pre and dec):
            # the decoders' conv2 cotangent goes through bn2's affine + ReLU
            gt, y = randn(*shp[:3], co), randn(*shp[:3], co)
            w = torch.randn((co, cin, 3, 3), generator=g, device=DEVICE) / (9 * cin) ** 0.5
            aff = dict(a=vec(co, 0.5, 1.5), b=vec(co, -0.5, 0.5)) if affine else {}
            return gt, y, w, small(co), small(co), aff

        def dgrad(shp=shp, ca=ca, cb=cb, cin=cin, pre=pre, operands=bwd_operands, flops=flops,
                  raw=unfused):
            gt, y, w, c1, c2, aff = operands()
            if raw:  # an unfused conv: the cotangent as it comes, y unread
                y = c1 = c2 = None
                aff = {}
            kw = dict(aff)
            if pre:  # conv2: bn1's ReLU adjoint on the raw conv1 output
                kw.update(x_post=randn(*shp), a_post=vec(ca, 0.5, 1.5), b_post=vec(ca, -0.5, 0.5))
            elif cb:  # decoder conv1: dx split into [up | skip]
                kw.update(split=ca)
            gl, wl = nchw(gt), w.to(bf16)
            size = (shp[0], cin, shp[1], shp[2])
            return Case((lambda: fc.conv3x3_dgrad(gt, y, w, c1, c2, **kw)),
                        (lambda: fc.conv3x3_dgrad_plain(gt, y, w, c1, c2, **kw)),
                        [gt, y, w, c1, c2, *(v for v in kw.values() if torch.is_tensor(v))],
                        flops, BF16_FLOP_PER_S,
                        lambda: torch.nn.grad.conv2d_input(size, wl, gl, padding=1))

        def wgrad(shp=shp, ca=ca, cb=cb, pre=pre, operands=bwd_operands, flops=flops,
                  raw=unfused):
            gt, y, w, c1, c2, aff = operands()
            if raw:
                y = c1 = c2 = None
                aff = {}
            kw = dict(aff, x_b=randn(*shp[:3], cb) if cb else None)
            if pre:
                kw.update(a_pre=vec(ca, 0.5, 1.5), b_pre=vec(ca, -0.5, 0.5))
            x = randn(*shp)
            xl = nchw(x if kw["x_b"] is None else torch.cat([x, kw["x_b"]], -1))
            gl = nchw(gt)
            return Case((lambda: fc.conv3x3_wgrad(gt, y, x, c1, c2, **kw)),
                        (lambda: fc.conv3x3_wgrad_plain(gt, y, x, c1, c2, **kw)),
                        [gt, y, x, c1, c2, *kw.values()], flops, BF16_FLOP_PER_S,
                        lambda: torch.nn.grad.conv2d_weight(xl, w.shape, gl, padding=1))

        if unfused:  # make_folded_conv3x3: forward, dx, dw and db (pre is False here)
            cases += [("conv3x3 unfused", label, mode, conv_fwd),
                      ("conv3x3_dgrad unfused", label, mode, dgrad),
                      ("conv3x3_wgrad unfused", label, mode, wgrad)]
            continue
        cases.append(("conv3x3", label, mode, conv_fwd))
        cases.append(("conv3x3", label + " stats", "line" if alone else mode,
                      lambda f=conv_fwd: f(stats=True)))
        if alone:  # input_grad=False: the wgrad kernel alone, no dgrad
            cases.append(("conv3x3_wgrad alone", label, "sum", wgrad))
        else:
            cases.append(("conv3x3_dgrad", label, mode, dgrad))
            cases.append(("conv3x3_wgrad", label, mode, wgrad))
        if pre and dec:  # the decoders' bn2 reduction, at conv2's output shape
            def bnred(shp=shp, co=co):
                gt, y, a, b = randn(*shp[:3], co), randn(*shp[:3], co), vec(co, 0.5, 1.5), vec(co, -0.5, 0.5)
                return Case((lambda: fc.bn_relu_bwd_reduce(gt, y, a, b)),
                            (lambda: fc.bn_relu_bwd_reduce_plain(gt, y, a, b)),
                            [gt, y, a, b], 6.0 * y.numel())  # mul, add, compare, select, mul, 2 adds
            cases.append(("bn_relu_bwd_reduce", label.split(".")[0] + ".bn2", mode, bnred))
    for (label, shp), mode in of_paths("pool"):
        def pool(shp=shp, bwd=False):
            # few distinct values, so windows hold ties
            z = (torch.randint(-6, 7, shp, generator=g, device=DEVICE) * 0.25).to(bf16)
            a, b = vec(shp[-1], 0.5, 1.5), vec(shp[-1], -0.5, 0.5)
            if not bwd:
                return Case((lambda: fc.maxpool2x2_affine_relu(z, a, b)),
                            (lambda: fc.maxpool2x2_affine_relu_plain(z, a, b)),
                            [z, a, b], 4.0 * z.numel())  # mul, add, relu, max
            dp = randn(shp[0], shp[1] // 2, shp[2] // 2, shp[3])
            return Case((lambda: fc.maxpool2x2_affine_relu_bwd(z, a, b, dp)),
                        (lambda: fc.maxpool2x2_affine_relu_bwd_plain(z, a, b, dp)),
                        [z, a, b, dp], 8.0 * z.numel())  # affine, relu, routing, P*a, 2 sums
        cases.append(("maxpool2x2_affine_relu", label, mode, pool))
        cases.append(("maxpool2x2_affine_relu_bwd", label, mode, lambda f=pool: f(bwd=True)))
    for (label, shp, co), mode in of_paths("ct"):
        def ct(shp=shp, co=co, bwd=False):
            x = randn(*shp)
            w = torch.randn((shp[-1], co, 2, 2), generator=g, device=DEVICE) / (4 * shp[-1]) ** 0.5
            flops = 2.0 * shp[0] * shp[1] * shp[2] * shp[3] * co * 4
            if not bwd:
                bias = torch.randn(co, generator=g, device=DEVICE) * 0.1
                xl, wl, bl = nchw(x), w.to(bf16), bias.to(bf16)
                return Case((lambda: fc.convtranspose2x2(x, w, bias)),
                            (lambda: fc.convtranspose2x2_plain(x, w, bias)),
                            [x, w, bias], flops, BF16_FLOP_PER_S,
                            lambda: F.conv_transpose2d(xl, wl, bl, stride=2))
            gt = randn(shp[0], 2 * shp[1], 2 * shp[2], co)
            # the library's backward: autograd through cuDNN's ConvTranspose (dx and dw)
            xr = nchw(x).detach().requires_grad_()
            wr = w.to(bf16).detach().requires_grad_()
            yr = F.conv_transpose2d(xr, wr, stride=2)
            gl = nchw(gt)
            return Case((lambda: fc.convtranspose2x2_bwd(x, w, gt)),
                        (lambda: fc.convtranspose2x2_bwd_plain(x, w, gt)),
                        [x, w, gt], 2 * flops, BF16_FLOP_PER_S,
                        lambda: torch.autograd.grad(yr, (xr, wr), gl, retain_graph=True))
        cases.append(("convtranspose2x2", label, mode, ct))
        cases.append(("convtranspose2x2_bwd", label, mode, lambda f=ct: f(bwd=True)))

    # K11 at the stem (no dx: the image takes no gradient) and the output
    # conv; the library's backward: autograd through the bf16 1x1 matmul
    for (label, shp, co, input_grad), mode in of_paths("1x1"):
        def one(shp=shp, co=co, input_grad=input_grad):
            ci, npix = shp[-1], shp[0] * shp[1] * shp[2]
            x, gt = randn(*shp), randn(*shp[:3], co)
            w = torch.randn((co, ci, 1, 1), generator=g, device=DEVICE) / ci ** 0.5
            xr = x.detach().requires_grad_(input_grad)
            wr = w[:, :, 0, 0].to(bf16).requires_grad_()
            br = torch.zeros(co, dtype=bf16, device=DEVICE, requires_grad=True)
            yr = F.linear(xr, wr, br)
            wrt = (xr, wr, br) if input_grad else (wr, br)

            def run(fn):
                return tuple(t for t in fn(x, gt, w, input_grad=input_grad) if t is not None)
            return Case((lambda: run(c11.conv1x1_bwd)), (lambda: run(c11.conv1x1_bwd_plain)),
                        [x, gt, w], npix * co * (2.0 * ci * (1 + input_grad) + 1), BF16_FLOP_PER_S,
                        lambda: torch.autograd.grad(yr, wrt, gt, retain_graph=True))
        batch = f"B{shp[0]} {shp[1]}x{shp[2]}"
        cases.append(("conv1x1_bwd", f"{label} {batch} {shp[-1]} -> {co}",
                      "sum" if mode == "sum" else "line", one))

    # the augmentor: the shear shifts of 16 drawn angles (rows twice, columns
    # once per step), the prompt step's packed stack (2 x 32 planes at
    # 256x256, its own line), |s| up to 511 (not on the main path), the
    # colour stage
    params = DataAugmentor(4).sample(BATCH, torch.Generator().manual_seed(SEED)).to(DEVICE)
    _, sx, sy = _shear3_shifts(params.angles, BATCH, SIZE, SIZE)
    prompt_angles = DataAugmentor(4).sample(
        PROMPT_BATCH, torch.Generator().manual_seed(SEED)).angles.to(DEVICE).repeat(2)
    _, psx, psy = _shear3_shifts(prompt_angles, 2 * PROMPT_BATCH, PROMPT_SIZE, PROMPT_SIZE)

    def extreme():
        s = torch.randint(-(SIZE - 1), SIZE, (BATCH, SIZE), generator=g, device=DEVICE,
                          dtype=torch.int32)
        s[:, 0], s[:, -1] = SIZE - 1, -(SIZE - 1)
        return s

    def shift(name, table, n=BATCH, size=SIZE):
        def make():
            x = torch.randint(-2**31, 2**31 - 1, (n, size, size), generator=g,
                              device=DEVICE, dtype=torch.int32)
            s = table() if callable(table) else table
            kern, plain = getattr(roll, name), getattr(roll, name + "_plain")
            return Case((lambda: kern(x, s)), (lambda: plain(x, s)), [x, s], tol="exact")
        return make

    cases.append(("row_shift", "shear 1 (rows)", "sum", shift("row_shift", sx)))
    cases.append(("col_shift", "shear 2 (columns)", "sum", shift("col_shift", sy)))
    cases.append(("row_shift", "shear 3 (rows)", "sum", shift("row_shift", sx)))
    stack = 2 * PROMPT_BATCH, PROMPT_SIZE
    cases.append(("row_shift", f"prompt stack {stack[0]}x{stack[1]}^2 (rows)", "line",
                  shift("row_shift", psx, *stack)))
    cases.append(("col_shift", f"prompt stack {stack[0]}x{stack[1]}^2 (columns)", "line",
                  shift("col_shift", psy, *stack)))
    cases.append(("row_shift", "|s| up to 511", None, shift("row_shift", extreme)))
    cases.append(("col_shift", "|s| up to 511", None, shift("col_shift", extreme)))

    def colour(dtype):
        def make():
            u8 = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=g, device=DEVICE,
                               dtype=torch.uint8)
            kw = dict(out_dtype=dtype)
            return Case((lambda: pp.preprocess(u8, params.jitter, params.blur, **kw)),
                        (lambda: pp.preprocess_plain(u8, params.jitter, params.blur, **kw)),
                        [u8, params.jitter, params.blur],
                        float(PREPROCESS_OPS_PER_PIXEL) * BATCH * SIZE * SIZE,
                        tol="colour" if dtype == torch.float32 else "bf16_step")
        return make

    cases.append(("preprocess", "u8 -> fp32", "sum", colour(torch.float32)))
    cases.append(("preprocess", "u8 -> bf16", None, colour(torch.bfloat16)))

    # the cross-attention kernel at the CLIP bottleneck of a 256x256 batch of
    # 32 (L = 32*32, D 512): the fusion phase's context and heads, the same
    # context over 8 heads (dh 64), one key, 77 tokens over 4 heads (the
    # long-context path), and the JAX kernel's own test shape
    def attention(b, length, s, heads):
        def make():
            q, k, v = randn(b, length, 512), randn(b, s, 512), randn(b, s, 512)
            split = [t.view(b, -1, heads, 512 // heads).transpose(1, 2) for t in (q, k, v)]
            return Case((lambda: xattn.cross_attention(q, k, v, heads)),
                        (lambda: xattn.cross_attention_plain(q, k, v, heads)),
                        [q, k, v], 4.0 * b * length * s * 512, BF16_FLOP_PER_S,
                        lambda: F.scaled_dot_product_attention(*split))
        return make

    bott = PROMPT_BATCH, (PROMPT_SIZE // 8) ** 2
    cases.append(("cross_attention", f"B{bott[0]} L{bott[1]} S{FUSION_TOKENS} heads {FUSION_HEADS}",
                  "sum", attention(*bott, FUSION_TOKENS, FUSION_HEADS)))
    for b, length, s, heads in ((*bott, FUSION_TOKENS, 8), (*bott, 1, 1), (*bott, 77, 4),
                                (1, 4096, 8, 1)):
        cases.append(("cross_attention", f"B{b} L{length} S{s} heads {heads}", "line",
                      attention(b, length, s, heads)))
    return cases


def compare(torch, label: str, got, ref, tol: str = "default") -> float:
    """Max abs error of a kernel's outputs against its plain version's;
    raises past the stated limits (see ``Case.tol``)."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, ref, strict=True)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{label}[{i}]: kernel {tuple(a.shape)}/{a.dtype} vs plain "
                                 f"{tuple(b.shape)}/{b.dtype}")
        if tol == "exact":
            err = float((a != b).sum().item())
            ok, what = err == 0.0, "exact (the count of differing words)"
        else:
            diff = (a.float() - b.float()).abs()
            err = diff.max().item()
            if tol == "colour":
                ok, what = err <= COLOUR_ATOL, f"atol {COLOUR_ATOL}"
            elif tol == "bf16_step":
                # one bf16 step, 2^(exponent - 7), at the larger of the two
                # values, plus the fp32 values' own limit
                mag = torch.maximum(a.float().abs(), b.float().abs()).clamp(min=2.0**-126)
                step = torch.exp2(torch.floor(torch.log2(mag)) - 7) + COLOUR_ATOL
                ok, what = bool((diff <= step).all()), f"one bf16 step + {COLOUR_ATOL} per element"
            else:
                rtol = KERNEL_RTOL if a.dtype == torch.bfloat16 else SUM_RTOL
                scale = b.float().abs().max().item()
                ok, what = err <= rtol * scale, f"{rtol} x max|plain| {scale!r}"
            ok = ok and bool(torch.isfinite(a).all())
        print(f"  {label}[{i}] {tuple(a.shape)} {str(a.dtype)[6:]}: max_abs_err={err!r} "
              f"limit {what}{'' if ok else ' FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"{label}[{i}]: kernel disagrees with its plain version")
        worst = max(worst, err)
    return worst


def _nbytes(tensors) -> int:
    flat = []
    for t in tensors:
        flat.extend(t if isinstance(t, tuple) else (t,))
    return sum(t.numel() * t.element_size() for t in flat if t is not None)


def kernel_phase(torch, mods, groups: list) -> dict:
    """Each kernel vs its plain version at every main-path shape (``groups``
    as :func:`path_shapes` gives them); per KERNEL_INFO entry, summed over
    its "sum" cases (the launches of one large_unet serving forward, train
    step and augmentor call; the prompt step's wgrad alone; the autoencoder
    step's unfused convs; one fusion call): the ms of both, the bound and
    the library call's ms."""
    results = {entry: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                       "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": None}
               for entry in KERNEL_INFO}
    for entry, label, timed, make in kernel_cases(torch, mods, groups):
        case = make()
        got = case.kern()
        r = results[entry]
        r["max_abs_err"] = max(r["max_abs_err"], compare(torch, f"{entry} {label}", got,
                                                         case.plain(), case.tol))
        if timed:
            # the least time: each input read once, each output written once
            bytes_ms = _nbytes([*case.inputs, got]) / HBM_BYTES_PER_S * 1e3
            ops_ms = case.ops / case.flop_per_s * 1e3
            # in turns: plain, kernel, kernel, plain; the conv kernels
            # (~1 ms a launch) and their library calls over CONV_ITERS
            # launches, their slow plain versions over 3
            conv = entry.startswith("conv3x3")
            iters, p_iters = (CONV_ITERS, 3) if conv else (10, 10)
            p1 = cuda_ms(torch, case.plain, p_iters)
            k1 = cuda_ms(torch, case.kern, iters)
            k2 = cuda_ms(torch, case.kern, iters)
            p2 = cuda_ms(torch, case.plain, p_iters)
            k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
            lib_ms = None if case.library is None else cuda_ms(torch, case.library, iters)
            bound = max(bytes_ms, ops_ms)
            rate = (f" {case.ops / k_ms / 1e9!r} TFLOP/s, {bound / k_ms!r} of the bound"
                    if entry.startswith(TENSOR_CORE_ENTRIES) else "")
            if entry in DEVICE_TIMED_ENTRIES:
                dev = device_us(torch, case.kern, iters)
                total = sum(dev.values())
                rate += (f" device_us={total!r} ({bound * 1e3 / total!r} of the bound; "
                         + ", ".join(f"{name[:48]} {us!r}" for name, us in dev.items()) + ")")
            print(f"kernel {entry} {label}: ms={k_ms!r} plain_ms={p_ms!r} "
                  f"bound_ms={bound!r} ({'bytes' if bytes_ms >= ops_ms else 'operations'}) "
                  f"library_ms={lib_ms!r}{rate}{'' if timed == 'sum' else ' (own line)'} ok",
                  flush=True)
        if timed == "sum":
            r["ms"] += k_ms
            r["plain_ms"] += p_ms
            r["bound_ms"] += max(bytes_ms, ops_ms)
            r["bytes_ms"] += bytes_ms
            r["ops_ms"] += ops_ms
            if lib_ms is not None:
                r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
        del case, got
        torch.cuda.empty_cache()
    for entry, r in results.items():
        ops_ms = r["ops_ms"]
        r["bound_by"] = "bytes" if r.pop("bytes_ms") >= r.pop("ops_ms") else "operations"
        if entry.startswith(TENSOR_CORE_ENTRIES) and r["ms"] > 0:
            # ops_ms is FLOPs / BF16_FLOP_PER_S in ms: back to FLOP/s over the kernel's ms
            print(f"kernel {entry} summed: ms={r['ms']!r} "
                  f"{ops_ms * BF16_FLOP_PER_S / r['ms'] / 1e12!r} TFLOP/s, "
                  f"{r['bound_ms'] / r['ms']!r} of the bound, library_ms={r['library_ms']!r}",
                  flush=True)
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
                if m.bias is not None:  # the ResNet's convs have none
                    normal(m.bias, 0.1)
            elif isinstance(m, nn.BatchNorm2d):
                uniform(m.weight, 0.5, 1.5)
                normal(m.bias, 0.1)
                normal(m.running_mean, 0.1)
                uniform(m.running_var, 0.5, 1.5)


def serving_phase(torch, mods, card: str) -> dict:
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
        before = counts(mods)
        out = fn()
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in counts(mods).items()}
        if delta != per_forward:
            raise AssertionError(f"{what}: launches {delta}, expected {per_forward}")
        return out

    # ---- the main path: counts from 0, read right after
    reset_counts(mods)
    for what, image in requests.items():
        mask = checked(f"predict {what}", lambda: predict(served, image))
        if mask.shape != (256, 256) or mask.min() < 0 or mask.max() >= NUM_CLASSES:
            raise AssertionError(f"predict {what}: mask {mask.shape} in [{mask.min()}, {mask.max()}]")
        print(f"predict {what}: mask {mask.shape}, class counts "
              f"{np.bincount(mask.ravel(), minlength=NUM_CLASSES).tolist()}", flush=True)
    with torch.inference_mode():
        logits = checked("forward b16", lambda: served(x16))
        logits1 = checked("forward b1", lambda: served(x16[:1]))
    launches = counts(mods)
    n_forwards = len(requests) + 2
    if launches != expected(PER_FORWARD, n_forwards):
        raise AssertionError(f"serving launches {launches} over {n_forwards} forwards")
    print(f"serving path: {n_forwards} forwards, launches {launches}", flush=True)

    # ---- outputs: finite, shaped, and the kernel path agrees with the plain path
    for name, t, shape in (("b16", logits, (BATCH, SIZE, SIZE, NUM_CLASSES)),
                           ("b1", logits1, (1, SIZE, SIZE, NUM_CLASSES))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not torch.isfinite(t).all():
            raise AssertionError(f"logits {name}: {tuple(t.shape)} {t.dtype}, finite={bool(torch.isfinite(t).all())}")
    with plain_path(mods), torch.inference_mode():
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
    return {k: p.grad.detach().float().clone() for k, p in model.named_parameters()
            if p.requires_grad}


def _rel_l2(got: dict, ref: dict, name: str) -> float:
    scale = ref[name[: -len("bias")] + "weight"] if name.endswith(CANCELLED_BIASES) else ref[name]
    return (got[name] - ref[name]).norm().item() / max(scale.norm().item(), 1e-30)


def _check_gradients(torch, gk: dict, gp: dict, g32: dict):
    """Step-0 gradients, kernel path vs plain path (see GRAD_RL2); with
    ``g32``, the plain path's fp32 gradients, a leaf that bf16 rounding
    alone moves by more than GRAD_RL2 (plain bf16 vs fp32) may instead be
    no further from the fp32 gradient than BF16_NOISE_FACTOR times the
    plain path is.  Returns (the largest kernel-vs-plain error, its leaf,
    the leaves held to the fp32 gradient as (leaf, plain bf16 vs fp32,
    kernel vs fp32))."""
    errs, held = [], []
    for name in gp:
        if not bool(torch.isfinite(gk[name]).all()):
            raise AssertionError(f"gradient {name} is not finite on the kernel path")
        err = _rel_l2(gk, gp, name)
        errs.append((err, name))
        if err <= GRAD_RL2:
            continue
        p32, k32 = _rel_l2(gp, g32, name), _rel_l2(gk, g32, name)
        if p32 > GRAD_RL2 and k32 <= BF16_NOISE_FACTOR * p32:
            held.append((name, p32, k32))
            errs[-1] = (0.0, name)  # held to the fp32 gradient instead
    errs.sort(reverse=True)
    if errs[0][0] > GRAD_RL2:
        print("largest relative L2 errors: " + ", ".join(f"{n} {e!r}" for e, n in errs[:12]),
              flush=True)
        raise AssertionError(f"gradient {errs[0][1]}: relative L2 {errs[0][0]!r} > {GRAD_RL2}")
    return errs[0][0], errs[0][1], held


def _step_ms(torch, trainer, images, masks, steps: int = 3) -> float:
    return cuda_ms(torch, lambda: trainer.train_step(images, masks, STEP_KEY), steps, warmup=1)


def _train_epoch(torch, mods, trainer, per_step: dict, per_forward: dict, what: str) -> dict:
    """The main path: ``trainer.train(1)`` (train steps, then ``evaluate``)
    with the counts set to 0 before and read after, exact per train step
    and per eval batch; returns the counts."""
    cfg = trainer.config
    reset_counts(mods)
    torch.cuda.reset_peak_memory_stats()
    hist = trainer.train(1)["history"]
    torch.cuda.synchronize()
    launches = counts(mods)
    n_train = len(trainer.train_data) * (cfg.data.augmentations_per_datapoint + 1) // cfg.batch_size
    n_val = math.ceil(len(trainer.val_data) / cfg.batch_size)
    want = {k: per_step.get(k, 0) * n_train + per_forward.get(k, 0) * n_val for k in WRAPPER_NAMES}
    if launches != want:
        raise AssertionError(f"{what} launches {launches}, expected {want}")
    row = hist[0]
    if not all(math.isfinite(v) for v in row.values()):
        raise AssertionError(f"{what} train(1) + evaluate: not finite: {row}")
    print(f"{what} path: {n_train} train steps (augmentation "
          f"{cfg.data.augmentations_per_datapoint}) + {n_val} eval batches, launches "
          f"{launches}; history {row}; peak memory {torch.cuda.max_memory_allocated()!r} B",
          flush=True)
    return launches


def _step_launches(torch, mods, trainer, images, masks, per_step: dict, what: str) -> dict:
    """One train step's launches, exactly ``per_step``."""
    before = counts(mods)
    trainer.train_step(images, masks, STEP_KEY)
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in counts(mods).items()}
    if delta != expected(per_step):
        raise AssertionError(f"{what}, one train step: launches {delta}, expected "
                             f"{expected(per_step)}")
    print(f"{what}, one train step: launches {delta}", flush=True)
    return delta


def _kernel_vs_plain(torch, mods, cfg, state: dict, images, masks, *, no_aug=False,
                     after: Optional[Callable] = None) -> dict:
    """3 train steps from ``state`` on one batch and one draw (STEP_KEY) on
    the kernel path and on the plain path: per-step losses within
    LOSS_RTOL, every step-0 gradient within GRAD_RL2 (or held to the plain
    path's fp32 gradient of one fp32 step, see BF16_NOISE_FACTOR); 5 more
    kernel-path steps must lower the loss; ``after(trainer)`` checks each
    trainer after its steps.  Returns {path: (ms per train step, peak
    bytes)}."""
    from image_segmentation_tpu_torch.engine.train import Trainer

    def run(steps: int, cfg=cfg):
        t = Trainer(cfg, device=DEVICE, make_artifacts=False)
        t.model.load_state_dict(state)
        losses, grads = [], None
        for _ in range(steps):
            losses.append(float(t.train_step(images, masks, STEP_KEY)))
            if grads is None:
                grads = _grads(t.model)
        return t, losses, grads

    times = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kt, k_losses, k_grads = run(3)
    more = [float(kt.train_step(images, masks, STEP_KEY)) for _ in range(5)]
    if after is not None:
        after(kt)
    times["kernel path"] = (_step_ms(torch, kt, images, masks), torch.cuda.max_memory_allocated())
    if no_aug:
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(kt, "augmentor", None):
            times["kernel path, no augmentation"] = (_step_ms(torch, kt, images, masks),
                                                     torch.cuda.max_memory_allocated())
    del kt
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with plain_path(mods):
        pt, p_losses, p_grads = run(3)
        if after is not None:
            after(pt)
        times["plain path"] = (_step_ms(torch, pt, images, masks), torch.cuda.max_memory_allocated())
        del pt
        torch.cuda.empty_cache()
        g32 = run(1, dataclasses.replace(cfg, bf16=False))[2]
    torch.cuda.empty_cache()
    for i, (a, b) in enumerate(zip(k_losses, p_losses)):
        print(f"step {i} loss: kernel path {a!r}, plain path {b!r} (limit {LOSS_RTOL} relative)",
              flush=True)
        if not (math.isfinite(a) and abs(a - b) <= LOSS_RTOL * abs(b)):
            raise AssertionError(f"step {i}: kernel-path loss {a!r} vs plain {b!r}")
    worst, where, held = _check_gradients(torch, k_grads, p_grads, g32)
    print(f"step-0 gradients of {len(p_grads)} parameters: largest relative L2 error vs the plain "
          f"path {worst!r} ({where}; limit {GRAD_RL2})", flush=True)
    ratio = max((k32 / p32 for _, p32, k32 in held), default=0.0)
    print(f"  {len(held)} leaves that bf16 rounding moves by more than {GRAD_RL2} held to the "
          f"fp32 gradient: kernel path at most {ratio!r} x the plain path's distance (limit "
          f"{BF16_NOISE_FACTOR})" + "".join(f"; {n}: plain bf16 {p!r}, kernel {k!r} from fp32"
                                             for n, p, k in held), flush=True)
    print(f"5 more steps on the batch, kernel path: losses {more}", flush=True)
    if not more[-1] < more[0]:
        raise AssertionError("5 steps on one fixed batch did not lower its loss")
    return times


def _print_times(what: str, batch: int, times: dict, card: str) -> None:
    for path, (ms, mem) in times.items():
        print(f"train step {what} bf16 batch {batch}, {path}: {ms!r} ms "
              f"({batch * 1000.0 / ms!r} img/s), max_memory_allocated {mem!r} B on {card}",
              flush=True)


def training_phase(torch, mods, card: str) -> dict:
    """The large_unet train step end to end, augmentation on; returns the
    launch counts of its run."""
    import numpy as np

    from image_segmentation_tpu_torch.engine.train import Trainer

    cfg = train_config()
    trainer = Trainer(cfg, device=DEVICE, make_artifacts=False)
    print(f"trainer: large_unet preset, {trainer.num_params} params, batch {cfg.batch_size}, "
          f"{cfg.data.image_size}x{cfg.data.image_size}, bf16={cfg.bf16}, "
          f"augmentor {trainer.augmentor}", flush=True)
    launches = _train_epoch(torch, mods, trainer, PER_STEP, PER_FORWARD, "training")

    rng = np.random.default_rng(SEED + 7)
    images = torch.from_numpy(rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)).to(DEVICE)
    masks = torch.from_numpy(rng.integers(0, NUM_CLASSES, (BATCH, SIZE, SIZE), dtype=np.uint8)).to(DEVICE)
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    _step_launches(torch, mods, trainer, images, masks, PER_STEP, "training")
    del trainer
    times = _kernel_vs_plain(torch, mods, cfg, state, images, masks, no_aug=True)
    _print_times(f"LargeUNet@{SIZE}", BATCH, times, card)
    return launches


# --------------------------------------------------------------------------
# prompt, ClipUnet and fusion phases
# --------------------------------------------------------------------------

def clip_config(name: str, batch: int = PROMPT_BATCH, length: int = PROMPT_LENGTH):
    """A CLIP preset of the port (``prompt``, ``clip_unet``, ``clip_res``,
    ``segment_classifier``, ``clip_autoencoder``) cut to a smoke run: the
    full-width model (ViT-B/32 tower, random weights from SEED), batch
    ``batch`` (32, as ``bench_extra.py`` measures the CLIP models on the
    JAX side), synthetic 256x256 data of ``length`` images per split, one
    epoch, the preset's augmentation."""
    from image_segmentation_tpu_torch.config import preset

    cfg = preset(name)
    data = dataclasses.replace(cfg.data, dataset="synthetic", image_size=PROMPT_SIZE,
                               synthetic_length=length)
    return dataclasses.replace(cfg, batch_size=batch, num_epochs=1, seed=SEED, data=data)


def _clip_batch(torch, seed: int, palette: bool, batch: int = PROMPT_BATCH):
    """A uint8 batch on the card: images, and class-id or palette masks."""
    import numpy as np

    from image_segmentation_tpu_torch.data.datasets import (
        CAT_PALETTE, DOG_PALETTE, UNCERTAIN_PALETTE)

    rng = np.random.default_rng(seed)
    shape = (batch, PROMPT_SIZE, PROMPT_SIZE)
    images = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    masks = rng.integers(0, NUM_CLASSES + palette, shape).astype(np.uint8)
    if palette:
        masks = np.array([0, CAT_PALETTE, DOG_PALETTE, UNCERTAIN_PALETTE], np.uint8)[masks]
    return torch.from_numpy(images).to(DEVICE), torch.from_numpy(masks).to(DEVICE)


def prompt_phase(torch, mods, card: str) -> dict:
    """The prompt preset's train step end to end (point prompts from the
    palette masks, the prompt augmentor, ClipUnetPrompt with the frozen
    tower, the binary loss, Adam with the frozen mask); returns the launch
    counts of its run."""
    from image_segmentation_tpu_torch.engine.train import Trainer
    from image_segmentation_tpu_torch.utils.convert import CLIP

    cfg = clip_config("prompt")
    trainer = Trainer(cfg, device=DEVICE, make_artifacts=False)
    tower = sum(p.numel() for p in trainer.model.clip_feature_extractor.parameters())
    print(f"trainer: prompt preset, {trainer.num_params} params ({tower} in the frozen tower), "
          f"batch {cfg.batch_size}, {cfg.data.image_size}x{cfg.data.image_size}, bf16={cfg.bf16}, "
          f"augmentor {trainer.augmentor}", flush=True)
    launches = _train_epoch(torch, mods, trainer, PER_PROMPT_STEP, PER_PROMPT_FORWARD, "prompt")
    images, raw = _clip_batch(torch, SEED + 17, palette=True)
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    delta = _step_launches(torch, mods, trainer, images, raw, PER_PROMPT_STEP, "prompt")
    if delta["conv3x3_dgrad"] != delta["conv3x3_wgrad"] - 1:
        raise AssertionError(f"prompt step: dgrad {delta['conv3x3_dgrad']} != wgrad - 1")
    del trainer

    def tower_unchanged(t):
        for k, v in t.model.state_dict().items():
            if k.startswith(CLIP) and not torch.equal(v, state[k]):
                raise AssertionError(f"the frozen tower moved: {k}")

    times = _kernel_vs_plain(torch, mods, cfg, state, images, raw, after=tower_unchanged)
    print("the frozen CLIP tower is bit-identical after the steps of both paths", flush=True)
    _print_times(f"ClipUnetPrompt@{PROMPT_SIZE}", PROMPT_BATCH, times, card)
    return launches


def clip_unet_phase(torch, mods, card: str) -> dict:
    """A train epoch and timed steps of the clip_unet preset; returns the
    launch counts of its run."""
    from image_segmentation_tpu_torch.engine.train import Trainer

    cfg = clip_config("clip_unet")
    trainer = Trainer(cfg, device=DEVICE, make_artifacts=False)
    launches = _train_epoch(torch, mods, trainer, PER_STEP, PER_FORWARD, "clip_unet")
    images, masks = _clip_batch(torch, SEED + 19, palette=False)
    torch.cuda.reset_peak_memory_stats()
    ms = _step_ms(torch, trainer, images, masks)
    _print_times(f"ClipUnet@{PROMPT_SIZE}", PROMPT_BATCH,
                 {"kernel path": (ms, torch.cuda.max_memory_allocated())}, card)
    del trainer
    torch.cuda.empty_cache()
    return launches


def fusion_phase(torch, mods, card: str) -> dict:
    """``CrossAttentionFusion(512, FUSION_HEADS)`` on a ClipUnet@256
    bottleneck map with a (32, FUSION_TOKENS, 512) context: the attention
    kernel once per call, against the plain path; returns the launch counts
    of its run."""
    from image_segmentation_tpu_torch.ops.cross_attention import CrossAttentionFusion

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    m = CrossAttentionFusion(512, FUSION_HEADS, device=DEVICE)
    with torch.no_grad():
        for name, p in m.named_parameters():
            scale = 0.1 if "bias" in name else p.shape[-1] ** -0.5
            p.copy_(torch.randn(p.shape, generator=g, device=DEVICE) * scale)
    side = PROMPT_SIZE // 8
    spatial = torch.randn((PROMPT_BATCH, side, side, 512), generator=g, device=DEVICE)
    ctx = torch.randn((PROMPT_BATCH, FUSION_TOKENS, 512), generator=g, device=DEVICE)
    with torch.no_grad():
        reset_counts(mods)
        out = m(spatial, ctx)
        torch.cuda.synchronize()
        launches = counts(mods)
        if launches != expected({"cross_attention": 1}):
            raise AssertionError(f"fusion launches {launches}, expected one cross_attention")
        before = counts(mods)
        one = m(spatial, ctx[:, 0])
        if counts(mods) != before:
            raise AssertionError("the one-token fusion launched a kernel")
        with plain_path(mods):
            ref = m(spatial, ctx)
            p_ms = cuda_ms(torch, lambda: m(spatial, ctx), 10)
        k_ms = cuda_ms(torch, lambda: m(spatial, ctx), 10)
    diff = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if (out.shape != ref.shape or one.shape != out.shape or not bool(torch.isfinite(out).all())
            or diff > KERNEL_RTOL * scale):
        raise AssertionError(f"fusion: kernel path {tuple(out.shape)} vs plain, max diff {diff!r}")
    print(f"fusion phase: CrossAttentionFusion(512, {FUSION_HEADS}) on {tuple(spatial.shape)} with "
          f"{FUSION_TOKENS} context tokens: launches {launches}, max_abs_diff vs plain path {diff!r} "
          f"(limit {KERNEL_RTOL} x {scale!r}); {k_ms!r} ms per call, plain path {p_ms!r} ms on "
          f"{card}", flush=True)
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# autoencoder phase
# --------------------------------------------------------------------------

def ae_config(w2d_impl: Optional[str] = None):
    """The port's ``autoencoder`` preset cut to a smoke run: batch 32,
    synthetic 256x256 data of AE_LENGTH images per split, one epoch, no
    augmentation (the preset's), as ``bench_extra.py:176-204`` measures it on
    the JAX side; ``w2d_impl`` replaces the preset's."""
    from image_segmentation_tpu_torch.config import preset

    cfg = preset("autoencoder")
    args = dict(cfg.model_args, **({} if w2d_impl is None else {"w2d_impl": w2d_impl}))
    data = dataclasses.replace(cfg.data, dataset="synthetic", image_size=AE_SIZE,
                               synthetic_length=AE_LENGTH)
    return dataclasses.replace(cfg, batch_size=AE_BATCH, num_epochs=1, seed=SEED, data=data,
                               model_args=args)


def autoencoder_phase(torch, mods, card: str) -> tuple:
    """The autoencoder preset's train step end to end (reconstruction: MSE
    on the normalised images, sigmoid output), then the same with
    ``w2d_impl="pallas"``; returns the launch counts of the two runs."""
    import numpy as np

    from image_segmentation_tpu_torch.engine.train import Trainer
    from image_segmentation_tpu_torch.ops.augment import normalize_image

    rng = np.random.default_rng(SEED + 23)
    shape = (AE_BATCH, AE_SIZE, AE_SIZE)
    images = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).to(DEVICE)
    masks = torch.zeros(shape, dtype=torch.uint8, device=DEVICE)  # read by no reconstruction step
    runs = []
    for impl, per_step, per_forward in ((None, PER_AE_STEP, PER_AE_FORWARD),
                                        ("pallas", PER_AE_UNFUSED_STEP, PER_AE_UNFUSED_FORWARD)):
        cfg = ae_config(impl)
        what = "autoencoder" + ("" if impl is None else f' w2d_impl="{impl}"')
        trainer = Trainer(cfg, device=DEVICE, make_artifacts=False)
        print(f"trainer: {what}, {trainer.num_params} params, batch {cfg.batch_size}, "
              f"{cfg.data.image_size}x{cfg.data.image_size}, bf16={cfg.bf16}, task "
              f"{trainer.task}, model args {cfg.model_args}", flush=True)
        runs.append(_train_epoch(torch, mods, trainer, per_step, per_forward, what))
        with torch.no_grad():
            out = trainer.model(normalize_image(images), train=False)
        if (tuple(out.shape) != (*shape, 3) or out.dtype != torch.float32
                or not bool(((out >= 0) & (out <= 1)).all())):
            raise AssertionError(f"{what}: reconstruction {tuple(out.shape)} {out.dtype} "
                                 f"in [{out.min().item()!r}, {out.max().item()!r}]")
        state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        _step_launches(torch, mods, trainer, images, masks, per_step, what)
        del trainer, out
        times = _kernel_vs_plain(torch, mods, cfg, state, images, masks)
        _print_times(f"Autoencoder@{AE_SIZE}" + ("" if impl is None else f" {impl}"), AE_BATCH,
                     times, card)
    return tuple(runs)


# --------------------------------------------------------------------------
# ClipRes, segment_classifier and ClipAutoencoder phases
# --------------------------------------------------------------------------

def _frozen_check(torch, state: dict):
    """``after`` for :func:`_kernel_vs_plain`: the tower's and the ResNet's
    parameters bit-identical to ``state``, the ResNet's running statistics
    moved by the steps (its BatchNorms run with batch statistics)."""
    from image_segmentation_tpu_torch.utils.convert import CLIP, RESNET

    def check(t):
        moved = 0
        for k, v in t.model.state_dict().items():
            if not k.startswith((CLIP, RESNET)) or k.endswith("num_batches_tracked"):
                continue
            if k.endswith(("running_mean", "running_var")):
                moved += not torch.equal(v, state[k])
            elif not torch.equal(v, state[k]):
                raise AssertionError(f"a frozen parameter moved: {k}")
        if moved == 0:
            raise AssertionError("the frozen ResNet's running statistics did not move")
    return check


def _frozen_phase(torch, mods, card: str, name: str, batch: int, length: int, per_step: dict,
                  per_forward: dict, what: str) -> dict:
    """A ClipRes preset's train step end to end (the frozen tower and
    ResNet-34, dec5 and the output on the kernels): one epoch with exact
    counts, one step's counts, 3 kernel-path steps held to the plain path
    with the frozen parts checked; returns the launch counts of its run."""
    from image_segmentation_tpu_torch.engine.train import Trainer

    cfg = clip_config(name, batch, length)
    trainer = Trainer(cfg, device=DEVICE, make_artifacts=False)
    m = trainer.model
    frozen = sum(p.numel() for p in m.parameters() if not p.requires_grad)
    print(f"trainer: {name} preset, {trainer.num_params} params ({frozen} frozen: the tower and "
          f"the ResNet-34), batch {cfg.batch_size}, {cfg.data.image_size}x{cfg.data.image_size}, "
          f"bf16={cfg.bf16}, task {trainer.task}, augmentor {trainer.augmentor}, model args "
          f"{cfg.model_args}", flush=True)
    launches = _train_epoch(torch, mods, trainer, per_step, per_forward, what)
    # the class task reads palette masks, clip_res class ids
    images, masks = _clip_batch(torch, SEED + 29, palette=trainer.task == "class", batch=batch)
    with torch.no_grad():
        out = m(trainer._prepare_batch(images, masks, augment=False)[0], train=False)
    logits = out[0] if isinstance(out, tuple) else out
    if not bool(torch.isfinite(logits).all()) or (trainer.task != "class" and logits.min() < 0):
        raise AssertionError(f"{what}: eval logits not finite, or negative after the output ReLU")
    state = {k: v.clone() for k, v in m.state_dict().items()}
    _step_launches(torch, mods, trainer, images, masks, per_step, what)
    del trainer, m, out, logits
    times = _kernel_vs_plain(torch, mods, cfg, state, images, masks, after=_frozen_check(torch, state))
    print(f"{what}: the frozen tower and ResNet-34 are bit-identical after the steps of both paths, "
          "the ResNet's running statistics moved", flush=True)
    _print_times(f"{what}@{PROMPT_SIZE}", batch, times, card)
    return launches


def clip_res_phase(torch, mods, card: str) -> dict:
    return _frozen_phase(torch, mods, card, "clip_res", PROMPT_BATCH, CLIP_RES_LENGTH,
                         PER_CLIP_RES_STEP, PER_CLIP_RES_FORWARD, "clip_res")


def segment_classifier_phase(torch, mods, card: str) -> dict:
    return _frozen_phase(torch, mods, card, "segment_classifier", CLASS_BATCH, CLASS_LENGTH,
                         PER_CLASS_STEP, PER_CLASS_FORWARD, "segment_classifier")


def clip_autoencoder_phase(torch, mods, card: str) -> dict:
    """A train epoch and timed steps of the clip_autoencoder preset (no
    kernel block: its launches are the augmentor's shifts); returns the
    launch counts of its run."""
    from image_segmentation_tpu_torch.engine.train import Trainer

    cfg = clip_config("clip_autoencoder")
    trainer = Trainer(cfg, device=DEVICE, make_artifacts=False)
    print(f"trainer: clip_autoencoder preset, {trainer.num_params} params, batch "
          f"{cfg.batch_size}, {cfg.data.image_size}x{cfg.data.image_size}", flush=True)
    launches = _train_epoch(torch, mods, trainer, PER_AUG_ONLY_STEP, {}, "clip_autoencoder")
    images, masks = _clip_batch(torch, SEED + 31, palette=False)
    torch.cuda.reset_peak_memory_stats()
    ms = _step_ms(torch, trainer, images, masks)
    _print_times(f"ClipAutoencoder@{PROMPT_SIZE}", PROMPT_BATCH,
                 {"kernel path": (ms, torch.cuda.max_memory_allocated())}, card)
    del trainer
    torch.cuda.empty_cache()
    return launches


def clip_res_serving_phase(torch, mods, card: str) -> dict:
    """A clip_res model (the preset's args) written with ``export_model``,
    read with ``load_model`` on the card: ``predict`` requests and batch-32
    and batch-1 eval forwards with exact counts, the batch-32 logits held
    to the plain path; returns the launch counts of its run."""
    import numpy as np

    from image_segmentation_tpu_torch.config import preset
    from image_segmentation_tpu_torch.engine.export import export_model, load_model, predict
    from image_segmentation_tpu_torch.models.registry import build_model
    from image_segmentation_tpu_torch.ops.augment import normalize_image

    model_args = preset("clip_res").model_args
    model = build_model("clip_res", device=DEVICE, **model_args)
    randomize_(torch, model, SEED + 3)
    with tempfile.TemporaryDirectory() as art:
        export_model(model, "clip_res", model_args, out_dir=art)
        served = load_model(art, device=DEVICE)
    del model
    rng = np.random.default_rng(SEED + 5)
    requests = {"u8 256x256": rng.integers(0, 256, (256, 256, 3), dtype=np.uint8),
                "u8 500x375": rng.integers(0, 256, (375, 500, 3), dtype=np.uint8)}
    u8 = torch.from_numpy(rng.integers(0, 256, (PROMPT_BATCH, PROMPT_SIZE, PROMPT_SIZE, 3),
                                       dtype=np.uint8)).to(DEVICE)
    x32 = normalize_image(u8)
    reset_counts(mods)
    for what, image in requests.items():
        mask = predict(served, image)
        if mask.shape != (256, 256) or mask.min() < 0 or mask.max() >= NUM_CLASSES:
            raise AssertionError(f"clip_res predict {what}: mask {mask.shape}")
        print(f"clip_res predict {what}: mask {mask.shape}, class counts "
              f"{np.bincount(mask.ravel(), minlength=NUM_CLASSES).tolist()}", flush=True)
    with torch.inference_mode():
        logits = served(x32)
        logits1 = served(x32[:1])
    torch.cuda.synchronize()
    launches = counts(mods)
    n_forwards = len(requests) + 2
    if launches != expected(PER_CLIP_RES_FORWARD, n_forwards):
        raise AssertionError(f"clip_res serving launches {launches} over {n_forwards} forwards")
    for t, shape in ((logits, (PROMPT_BATCH, PROMPT_SIZE, PROMPT_SIZE, NUM_CLASSES)),
                     (logits1, (1, PROMPT_SIZE, PROMPT_SIZE, NUM_CLASSES))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()) or t.min() < 0:
            raise AssertionError(f"clip_res logits {tuple(t.shape)}: not finite or negative")
    with plain_path(mods), torch.inference_mode():
        plain = served(x32)
    diff = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    print(f"clip_res serving: {n_forwards} forwards, launches {launches}; logits b{PROMPT_BATCH} "
          f"kernel vs plain path max_abs_diff={diff!r} (limit {LOGITS_RTOL} x {scale!r}), argmax "
          f"agreement={agree!r} (limit {ARGMAX_AGREEMENT})", flush=True)
    if diff > LOGITS_RTOL * scale or agree < ARGMAX_AGREEMENT:
        raise AssertionError("clip_res kernel-path logits disagree with the plain path")
    del plain
    with torch.inference_mode():
        x = x32.to(served.dtype)
        times = {f"forward batch {PROMPT_BATCH}": cuda_ms(torch, lambda: served(x32), 10),
                 "forward batch 1": cuda_ms(torch, lambda: served(x32[:1]), 20, warmup=3),
                 f"ResNet-34 alone, batch {PROMPT_BATCH}": cuda_ms(
                     torch, lambda: served.encoder(x), 10),
                 "ResNet-34 alone, batch 1": cuda_ms(torch, lambda: served.encoder(x[:1]), 20,
                                                      warmup=3)}
    for what, ms in times.items():
        print(f"serving ClipRes@{PROMPT_SIZE} bf16 {what}: {ms!r} ms on {card}", flush=True)
    del served
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# converter phase
# --------------------------------------------------------------------------

CONVERT_BATCH = 8
HEAT_ATOL = 1.2e-7  # two ulps at 1.0: exp on the card and on the host (the prompt tests')


def _randomize_norms_(torch, module, seed: int) -> None:
    """LayerNorm scales in [0.5, 1.5] and biases of scale 0.1, so that a
    scale and a bias swapped by a converter would show."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.copy_(torch.rand(m.weight.shape, generator=g, device=DEVICE) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g, device=DEVICE) * 0.1)


def _same_state(torch, got: dict, want: dict, what: str) -> None:
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: keys differ")
    for k, v in want.items():
        if not torch.equal(got[k].to(v.device, v.dtype), v):
            raise AssertionError(f"{what}: {k} differs")


def converter_phase(torch, mods, card: str) -> dict:
    """``cli.convert_pretrained`` on the full-width towers (the ViT-B/32
    of the clip_unet preset in the transformers vision layout, a
    ResNet-34 in torchvision's, random weights from SEED), each ``.npz``
    loaded back with ``state_dict_from_jax`` into fresh modules on the
    card and held bit for bit: the pooled CLIP embedding (batch 8 at
    224x224), the ResNet-34 feature map (batch 8 at 256x256), and the
    served clip_unet logits (batch 8 at 256x256) with the converted tower
    against the same model with the source tower, exact counts; then
    ``cli.check_prompt_data --device cuda``, its heatmaps against the
    host's for the same draws.  Returns the launch counts of its run."""
    import numpy as np

    from image_segmentation_tpu_torch.cli import check_prompt_data, convert_pretrained
    from image_segmentation_tpu_torch.config import preset
    from image_segmentation_tpu_torch.data.datasets import synthetic_dataset
    from image_segmentation_tpu_torch.data.prompts import make_prompt_batch, sample_prompt_draws
    from image_segmentation_tpu_torch.engine.export import export_model, load_model
    from image_segmentation_tpu_torch.engine.train import init_weights_
    from image_segmentation_tpu_torch.models.clip import ClipFeatureExtractor
    from image_segmentation_tpu_torch.models.registry import build_model
    from image_segmentation_tpu_torch.models.resnet import ResNet34Features
    from image_segmentation_tpu_torch.ops.augment import normalize_image
    from image_segmentation_tpu_torch.utils.convert import (
        CLIP, read_flat_npz, state_dict_from_jax, torchvision_resnet34_keys)

    t0 = time.perf_counter()
    model_args = preset("clip_unet").model_args
    model = build_model("clip_unet", device=DEVICE, **model_args)
    init_weights_(model, torch.Generator().manual_seed(SEED + 23))
    randomize_(torch, model, SEED + 23)
    _randomize_norms_(torch, model.clip_feature_extractor, SEED + 23)
    resnet = ResNet34Features(device=DEVICE)
    randomize_(torch, resnet, SEED + 29)
    fe = model.clip_feature_extractor
    sources = {"clip": {k: v.cpu() for k, v in fe.clip_model.state_dict().items()},
               "resnet34": torchvision_resnet34_keys(
                   {k: v.cpu() for k, v in resnet.state_dict().items()})}
    trees = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tower, sd in sources.items():
            src, out = f"{tmp}/{tower}.pt", f"{tmp}/{tower}.npz"
            torch.save(sd, src)
            convert_pretrained.main([tower, "--torch-state-dict", src, "--out", out])
            trees[tower] = read_flat_npz(out)
        export_model(model, "clip_unet", model_args, out_dir=f"{tmp}/art")
        served = load_model(f"{tmp}/art", device=DEVICE)

    # the towers loaded back into fresh modules
    clip_sd = state_dict_from_jax({"clip_tower": trees["clip"]["params"]}, {})
    fresh_fe = ClipFeatureExtractor(torch.bfloat16, device=DEVICE)
    prefix = CLIP[:-len("clip_model.")]
    fresh_fe.load_state_dict({k[len(prefix):]: v for k, v in clip_sd.items()}, strict=True)
    _same_state(torch, fresh_fe.state_dict(), fe.state_dict(), "converted CLIP tower")
    rn = trees["resnet34"]
    rn_sd = state_dict_from_jax({"resnet_backbone": rn["params"]},
                                {"resnet_backbone": rn["batch_stats"]})
    fresh_rn = ResNet34Features(device=DEVICE)
    fresh_rn.load_state_dict({k[len("encoder."):]: v for k, v in rn_sd.items()}, strict=True)
    _same_state(torch, fresh_rn.state_dict(), resnet.state_dict(), "converted ResNet-34")
    rng = np.random.default_rng(SEED + 31)
    x224 = normalize_image(torch.from_numpy(rng.integers(
        0, 256, (CONVERT_BATCH, 224, 224, 3), dtype=np.uint8)).to(DEVICE))
    x256 = normalize_image(torch.from_numpy(rng.integers(
        0, 256, (CONVERT_BATCH, PROMPT_SIZE, PROMPT_SIZE, 3), dtype=np.uint8)).to(DEVICE))
    with torch.inference_mode():
        pairs = {"pooled CLIP embedding": (fresh_fe(x224), fe(x224)),
                 "ResNet-34 feature map": (fresh_rn(x256), resnet(x256))}
    del model, resnet, fresh_fe, fresh_rn

    # the served clip_unet: its own (source) tower, then a fresh model's
    # other weights with the converted tower
    reset_counts(mods)
    with torch.inference_mode():
        want = served(x256, train=False)
    other = build_model("clip_unet", device=DEVICE, **model_args).requires_grad_(False)
    patch = CLIP + "vision_model.embeddings.patch_embedding.weight"
    if torch.equal(other.state_dict()[patch], served.state_dict()[patch]):
        raise AssertionError("the fresh clip_unet already holds the source tower")
    other.load_state_dict({**{k: v for k, v in served.state_dict().items()
                              if not k.startswith(CLIP)}, **clip_sd}, strict=True)
    _same_state(torch, other.state_dict(), served.state_dict(), "clip_unet, converted tower")
    with torch.inference_mode():
        pairs["served clip_unet logits"] = (other(x256, train=False), want)
    torch.cuda.synchronize()
    launches = counts(mods)
    if launches != expected(PER_FORWARD, 2):
        raise AssertionError(f"converter phase launches {launches} over 2 clip_unet forwards")
    for what, (got, ref) in pairs.items():
        if not bool(torch.isfinite(ref).all()) or not torch.equal(got, ref):
            raise AssertionError(f"{what}: the converted tower's differs from the source's")
        print(f"converter: {what} {tuple(ref.shape)} {ref.dtype} bit-identical to the source "
              f"tower's", flush=True)
    del served, other

    # the prompt check on the card, its heatmaps against the host's
    result = check_prompt_data.main(["--device", DEVICE, "--dataset", "synthetic", "--no-plot"])
    checks = [x for x in result["lines"] if x.endswith("label at peak = 1.0 (must be 1.0)")]
    if len(checks) != check_prompt_data.N:
        raise AssertionError(f"check_prompt_data: {len(checks)} label checks passed")
    generator = torch.Generator(device=DEVICE).manual_seed(0)
    draws = sample_prompt_draws(check_prompt_data.N, generator).to("cpu")
    raw = torch.from_numpy(synthetic_dataset(length=check_prompt_data.N,
                                             keep_raw_masks=True).raw_masks)
    heat, label = make_prompt_batch(raw, draws)
    heat_err = float(np.abs(result["heat"] - heat[..., 0].numpy()).max())
    print(f"check_prompt_data on the card: {len(checks)} label checks, heatmaps against the "
          f"host's max_abs_err={heat_err!r} (limit {HEAT_ATOL}), labels equal "
          f"{bool(np.array_equal(result['label'], label.numpy()))}", flush=True)
    if heat_err > HEAT_ATOL or not np.array_equal(result["label"], label.numpy()):
        raise AssertionError("check_prompt_data: the card's prompts differ from the host's")
    torch.cuda.empty_cache()
    print(f"converter phase: {time.perf_counter() - t0!r} s host on {card}", flush=True)
    return launches


# --------------------------------------------------------------------------
# augmentor phase
# --------------------------------------------------------------------------

def augmentor_phase(torch, mods, card: str) -> dict:
    """``DataAugmentor(4, backend="pallas").apply_u8`` at batch 16, 512x512;
    returns the launch counts of its run."""
    import numpy as np

    from image_segmentation_tpu_torch.ops.augment import DataAugmentor, apply_geometric

    rng = np.random.default_rng(SEED + 11)
    images = torch.from_numpy(rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)).to(DEVICE)
    masks = torch.from_numpy(rng.integers(0, NUM_CLASSES, (BATCH, SIZE, SIZE), dtype=np.uint8)).to(DEVICE)
    fused, xla = DataAugmentor(4, backend="pallas"), DataAugmentor(4)
    params = fused.sample(BATCH, torch.Generator().manual_seed(SEED)).to(DEVICE)

    # ---- the main path: counts from 0, read right after
    reset_counts(mods)
    out_i, out_m = fused.apply_u8(params, images, masks)
    torch.cuda.synchronize()
    launches = counts(mods)
    if launches != expected(PER_AUGMENT):
        raise AssertionError(f"augmentor launches {launches}, expected {expected(PER_AUGMENT)}")
    ref_i, ref_m = xla.apply_u8(params, images, masks)
    if (tuple(out_i.shape) != (BATCH, SIZE, SIZE, 3) or out_i.dtype != torch.float32
            or out_m.dtype != torch.int64 or not bool(torch.isfinite(out_i).all())):
        raise AssertionError(f"augmentor: {tuple(out_i.shape)} {out_i.dtype}, masks {out_m.dtype}")
    err = (out_i - ref_i).abs().max().item()
    same_masks = bool(torch.equal(out_m, ref_m))
    print(f"augmentor backend=pallas vs xla on the same draws: images max_abs_err={err!r} "
          f"(limit {COLOUR_ATOL}), masks equal={same_masks}, launches {launches}", flush=True)
    if err > COLOUR_ATOL or not same_masks:
        raise AssertionError("the fused colour stage disagrees with the xla stage")
    if out_i.min().item() < 0.0 or out_i.max().item() > 1.0 or out_m.max().item() >= NUM_CLASSES:
        raise AssertionError("augmented images leave [0, 1] or masks leave the classes")
    del out_i, out_m, ref_i, ref_m

    stacked = torch.cat([images, masks[..., None]], dim=-1)
    times = {
        "apply_u8 backend=pallas": cuda_ms(torch, lambda: fused.apply_u8(params, images, masks), 10),
        "apply_u8 backend=xla": cuda_ms(torch, lambda: xla.apply_u8(params, images, masks), 10),
        "geometry alone (flip, quarter turn, 3 shears)":
            cuda_ms(torch, lambda: apply_geometric(stacked, params.flip, params.angles), 10),
    }
    for what, ms in times.items():
        print(f"augmentor {what}, batch {BATCH} {SIZE}x{SIZE} u8: {ms!r} ms on {card}", flush=True)
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# robustness and artifacts phase
# --------------------------------------------------------------------------

def _csv_rows(path) -> list:
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def _check_scores(out: Path) -> int:
    """The CLI's battery CSVs: 81 lines of the int grid, 8 float files,
    every metric finite and in [0, 1]; returns the number of values."""
    from image_segmentation_tpu_torch.data import perturbations as pert

    rows = _csv_rows(out / "results" / "robustness_scores.csv")
    n_int = sum(len(i["params"]) for i in pert.INT_SWEEPS.values())
    if len(rows) != n_int + 1 or rows[0] != ["perturbation_type", "param_value", "mean_dice"]:
        raise AssertionError(f"robustness_scores.csv: {len(rows)} lines, header {rows[0]}")
    values = [float(r[2]) for r in rows[1:]]
    files = sorted(p.name for p in (out / "augmentation-results").iterdir())
    if files != sorted(f"{n}.csv" for n in pert.FLOAT_SWEEPS):
        raise AssertionError(f"augmentation-results: {files}")
    for name, info in pert.FLOAT_SWEEPS.items():
        rows = _csv_rows(out / "augmentation-results" / f"{name}.csv")
        if len(rows) != len(info["params"]) + 1:
            raise AssertionError(f"{name}.csv: {len(rows)} lines")
        values += [float(v) for r in rows[1:] for v in r[1:]]
    if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in values):
        raise AssertionError("a battery metric is not finite or leaves [0, 1]")
    return len(values)


def _same_trainer_state(torch, a, b) -> None:
    """Parameters, running statistics, Adam's moments and step equal bit
    for bit."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        if not torch.equal(sa[k], sb[k]):
            raise AssertionError(f"restored {k} differs from the trained Trainer's")
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    for name in pa:
        st_a, st_b = a.optimizer.state.get(pa[name], {}), b.optimizer.state.get(pb[name], {})
        if sorted(st_a) != sorted(st_b) or not all(torch.equal(st_a[k], st_b[k]) for k in st_a):
            raise AssertionError(f"restored Adam state of {name} differs")
    if a.step != b.step:
        raise AssertionError(f"restored step {b.step} != {a.step}")


def _dice_bound(torch, plain_logits, masks, share: float) -> float:
    """How far the soft Dice (``ops/losses.dice_score``: per class c,
    D_c = 2 A_c / B_c with A_c = sum(p t), B_c = sum(p) + sum(t), p =
    softmax(softmax(z))) can move when a ``share`` of the N pixels takes
    any probabilities in [0, 1] and the rest stay: A_c and B_c move by at
    most share * N each, so |dD_c| <= (2 + D_c) share N / (B_c - share N);
    the largest class's bound (the Dice is their mean)."""
    import torch.nn.functional as F

    p = F.softmax(F.softmax(plain_logits.float(), -1), -1).reshape(-1, NUM_CLASSES)
    t = F.one_hot(masks.reshape(-1).long(), NUM_CLASSES).float()
    moved = share * p.shape[0]
    card = p.sum(0) + t.sum(0)
    dice = 2 * (p * t).sum(0) / card
    return ((2 + dice) * moved / (card - moved)).max().item()


def _family_times(torch, ev, family_s: dict, card: str) -> None:
    """Each family's wall seconds, and the device's busy share of one
    family (int contrast_increase) from ``torch.profiler``: its device
    time over its unprofiled wall time."""
    from image_segmentation_tpu_torch.data import perturbations as pert

    for (kind, name), sec in family_s.items():
        if kind != "clean":
            print(f"  {kind} {name}: {sec!r} s", flush=True)
    params = pert.INT_SWEEPS["contrast_increase"]["params"]
    busy = sum(device_us(torch, lambda: ev._run_sweep_family("int", "contrast_increase", params),
                         1).values()) / 1e6
    wall = family_s[("int", "contrast_increase")]
    print(f"  int contrast_increase: device busy {busy!r} s of {wall!r} s wall, idle share "
          f"{1.0 - busy / wall!r} on {card}", flush=True)


def robustness_phase(torch, mods, card: str) -> dict:
    """Train -> checkpoint -> evaluate through the CLIs at the large_unet
    preset's width and 256x256 images, then the Evaluator's checks and the
    battery times; returns the launch counts of the two CLI runs."""
    import numpy as np

    from image_segmentation_tpu_torch.cli import evaluate as cli_evaluate
    from image_segmentation_tpu_torch.cli import train as cli_train
    from image_segmentation_tpu_torch.data import perturbations as pert
    from image_segmentation_tpu_torch.data.datasets import synthetic_dataset
    from image_segmentation_tpu_torch.engine.evaluate import Evaluator
    from image_segmentation_tpu_torch.engine.train import Trainer, _dataset_from_config
    from image_segmentation_tpu_torch.models.registry import build_model
    from image_segmentation_tpu_torch.ops import losses as L
    from image_segmentation_tpu_torch.ops.augment import normalize_image

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # ---- the main path, 1: train to a checkpoint (counts from 0, read after)
        reset_counts(mods)
        t0 = time.perf_counter()
        trained = cli_train.main(["--preset", "large_unet", "--dataset", "synthetic", "--epochs",
                                  "1", "--batch-size", str(ROBUST_BATCH), "--save-dir",
                                  str(tmp / "runs"), "--device", DEVICE])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = counts(mods)
        cfg = trained.config
        n_train = len(trained.train_data) * (cfg.data.augmentations_per_datapoint + 1) // cfg.batch_size
        n_val = math.ceil(len(trained.val_data) / cfg.batch_size)
        want = {k: PER_STEP.get(k, 0) * n_train + PER_FORWARD.get(k, 0) * n_val
                for k in WRAPPER_NAMES}
        if train_launches != want:
            raise AssertionError(f"cli.train launches {train_launches}, expected {want}")
        run = Path(trained.run_dir)
        files = sorted(p.name for p in run.iterdir())
        loss_rows = _csv_rows(run / "loss.csv")
        with open(run / "model_settings.json") as f:
            settings = json.load(f)
        if (files != ["loss.csv", "model_1.npz", "model_settings.json"] or len(loss_rows) != 2
                or loss_rows[0][0] != "Epoch" or settings["model"] != "LargeUNet"
                or settings["num_params"] != trained.num_params
                or not all(math.isfinite(float(v)) for v in loss_rows[1])):
            raise AssertionError(f"run folder {files}, loss.csv {loss_rows}")
        print(f"cli.train large_unet@{cfg.data.image_size} batch {cfg.batch_size}: {n_train} train "
              f"steps + {n_val} eval batches in {train_s!r} s, launches {train_launches}; run "
              f"folder {files}, loss.csv row {loss_rows[1]}", flush=True)

        ckpt = str(run / "model_1.npz")
        fresh = Trainer(cfg, device=DEVICE, make_artifacts=False)
        fresh.restore(ckpt)
        _same_trainer_state(torch, trained, fresh)
        images = torch.from_numpy(trained.val_data.images[:cfg.batch_size]).to(DEVICE)
        masks = torch.from_numpy(trained.val_data.masks[:cfg.batch_size]).to(DEVICE)
        la = float(trained.train_step(images, masks, STEP_KEY))
        lb = float(fresh.train_step(images, masks, STEP_KEY))
        print(f"checkpoint {Path(ckpt).name} restored into a fresh Trainer: parameters, running "
              f"statistics, Adam moments and step (={trained.step - 1}) bit-identical; next "
              f"step's loss {la!r} (trained) vs {lb!r} (restored)", flush=True)
        if la != lb:
            raise AssertionError("the restored Trainer's next step differs")
        del trained, fresh
        torch.cuda.empty_cache()

        # ---- the main path, 2: evaluate the checkpoint through the CLI
        out = tmp / "cli"
        reset_counts(mods)
        t0 = time.perf_counter()
        cli_clean = cli_evaluate.main(["--preset", "large_unet", "--ckpt", ckpt, "--dataset",
                                       "synthetic", "--robustness-int", "--robustness",
                                       "--out-dir", str(out), "--device", DEVICE])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        eval_launches = counts(mods)
        test_data = _dataset_from_config(cfg, False)
        n_points = {kind: sum(len(i["params"]) for i in pert.SWEEPS[kind].values())
                    for kind in ("int", "float")}
        n_batches = math.ceil(len(test_data) / EVAL_BATCH)
        n_forwards = (1 + n_points["int"] + n_points["float"]) * n_batches
        if eval_launches != expected(PER_FORWARD, n_forwards):
            raise AssertionError(f"cli.evaluate launches {eval_launches} over {n_forwards} "
                                 f"forwards, expected {expected(PER_FORWARD, n_forwards)}")
        n_values = _check_scores(out)
        print(f"cli.evaluate --robustness-int --robustness: clean {cli_clean}; (1 + "
              f"{n_points['int']} + {n_points['float']} points) x {n_batches} batches = "
              f"{n_forwards} forwards in {cli_s!r} s, launches {eval_launches}; {n_values} "
              "metrics finite and in [0, 1]", flush=True)

        # ---- the Evaluator API on the same model and split
        restored = Trainer(cfg, device=DEVICE, make_artifacts=False)
        restored.restore(ckpt)
        model = restored.model
        ev = Evaluator(model, test_data, batch_size=EVAL_BATCH, device=DEVICE)
        ev.test()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clean = ev.test()
        clean_s = time.perf_counter() - t0
        if clean != cli_clean:
            raise AssertionError(f"Evaluator.test() {clean} != the CLI's {cli_clean}")
        api = tmp / "api"
        t0 = time.perf_counter()
        int_res = ev.robustness_evaluation(str(api / "results" / "robustness_scores.csv"))
        int_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        float_res = ev.test_robustness(str(api / "augmentation-results"))
        float_s = time.perf_counter() - t0
        family_s = dict(ev.family_seconds)  # the checks below run families again
        for rel in ["results/robustness_scores.csv"] + [f"augmentation-results/{n}.csv"
                                                        for n in pert.FLOAT_SWEEPS]:
            if (api / rel).read_bytes() != (out / rel).read_bytes():
                raise AssertionError(f"{rel}: the Evaluator's file differs from the CLI's")
        worst = 0.0
        for name, pts in int_res.items():
            worst = max(worst, abs(pts[0][1] - clean["dice"]))
        for name, rows in float_res.items():
            if name != "gaussian_noise":  # its first point is 1e-6
                worst = max(worst, *(abs(a - b) for a, b in zip(rows[0][1:], clean.values())))
        if worst > EVAL_ATOL:
            raise AssertionError(f"an identity point is {worst!r} from test()")
        print(f"Evaluator: test() equals the CLI's; both batteries' CSVs byte-equal to the CLI's; "
              f"identity points vs test() {worst!r} (limit {EVAL_ATOL})", flush=True)

        # kernel path vs plain path on one 8-image batch, the last point of each
        # int family, through two models.  The trained one: its logits held as
        # the serving phase holds them (LOGITS_RTOL); trained one epoch on random
        # masks, it has near-tied logits, where bf16 rounding flips the argmax.
        # The serving phase's randomized model (randomize_), whose logits are not
        # near-tied: held as well to the serving phase's argmax agreement
        # (ARGMAX_AGREEMENT), and its soft Dice to what the disagreeing share of
        # pixels, taking any probabilities, can move it (_dice_bound).
        randomized = build_model("large_unet", device=DEVICE, dtype=restored.dtype,
                                 **cfg.model_args)
        randomize_(torch, randomized, SEED)
        images_u8 = torch.from_numpy(test_data.images[:EVAL_BATCH]).to(DEVICE)
        masks = torch.from_numpy(test_data.masks[:EVAL_BATCH]).to(DEVICE).long()
        for name, info in pert.INT_SWEEPS.items():
            p = info["params"][-1]
            x = ev.perturb("int", name, images_u8, p, ev.batch_draws("int", name, 0, p,
                                                                     images_u8.shape))
            x = normalize_image(x)
            for what, m in (("trained", model), ("randomized", randomized)):
                with torch.no_grad():
                    zk = m(x, train=False)
                    with plain_path(mods):
                        zp = m(x, train=False)
                diff, scale = (zk - zp).abs().max().item(), zp.abs().max().item()
                line = (f"int {name}={p}, {what} model: logits max_abs_diff {diff!r} (limit "
                        f"{LOGITS_RTOL} x {scale!r})")
                ok = diff <= LOGITS_RTOL * scale
                if what == "randomized":
                    dk, dp = L.dice_score(zk, masks).item(), L.dice_score(zp, masks).item()
                    bound = _dice_bound(torch, zp, masks, 1.0 - ARGMAX_AGREEMENT)
                    agree = (zk.argmax(-1) == zp.argmax(-1)).float().mean().item()
                    line += (f"; argmax agreement {agree!r} (limit {ARGMAX_AGREEMENT}); dice "
                             f"kernel {dk!r} plain {dp!r} (|diff| {abs(dk - dp)!r}, limit "
                             f"{bound!r})")
                    ok = ok and agree >= ARGMAX_AGREEMENT and abs(dk - dp) <= bound
                print(line, flush=True)
                if not ok:
                    raise AssertionError(f"int {name}={p}, {what} model: the kernel path "
                                         "disagrees with the plain path")
        del randomized

        # ---- times
        n_all = 1 + n_points["int"] + n_points["float"]
        x8 = normalize_image(images_u8)
        with torch.no_grad():
            fwd_ms = cuda_ms(torch, lambda: model(x8, train=False), 10)
        print(f"battery on the CLI's split ({len(test_data)} images "
              f"{cfg.data.image_size}x{cfg.data.image_size}, batch {EVAL_BATCH}, {n_batches} "
              f"batches): int 8x10 grid {int_s!r} s, float battery {float_s!r} s, the CLI's whole "
              f"run {cli_s!r} s; clean test() {clean_s!r} s, x {n_all} points = "
              f"{clean_s * n_all!r} s (share {clean_s * n_all / (int_s + float_s + clean_s)!r}); "
              f"the batch-{EVAL_BATCH} forward "
              f"{fwd_ms!r} ms (CUDA events), x {n_all * n_batches} forwards = share "
              f"{fwd_ms * n_all * n_batches / 1e3 / (int_s + float_s + clean_s)!r} on {card}",
              flush=True)
        _family_times(torch, ev, family_s, card)
        bench = synthetic_dataset(BENCH_LENGTH, BENCH_SIZE, BENCH_SIZE, seed=BENCH_SEED)
        ev = Evaluator(model, bench, batch_size=BENCH_BATCH, device=DEVICE)
        ev.test()  # warm-up at this size
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev.test()
        bench_clean = time.perf_counter() - t0
        t0 = time.perf_counter()
        ev.robustness_evaluation(str(tmp / "bench.csv"))
        grid_s = time.perf_counter() - t0
        xb = normalize_image(torch.from_numpy(bench.images[:BENCH_BATCH]).to(DEVICE))
        with torch.no_grad():
            fwd_ms = cuda_ms(torch, lambda: model(xb, train=False), 10)
        n_bench = math.ceil(len(bench) / BENCH_BATCH) * n_points["int"]
        print(f"battery bench cell (bench_extra.py:267: synthetic_dataset({BENCH_LENGTH}, "
              f"{BENCH_SIZE}, {BENCH_SIZE}, seed={BENCH_SEED}), batch {BENCH_BATCH}): int 8x10 grid "
              f"{grid_s!r} s; clean test() {bench_clean!r} s, x {n_points['int']} points = share "
              f"{bench_clean * n_points['int'] / grid_s!r}; the batch-{BENCH_BATCH} forward "
              f"{fwd_ms!r} ms (CUDA events), x {n_bench} forwards = share "
              f"{fwd_ms * n_bench / 1e3 / grid_s!r} on {card}", flush=True)
        _family_times(torch, ev, dict(ev.family_seconds), card)
        del restored, model, ev
    torch.cuda.empty_cache()
    return {k: train_launches[k] + eval_launches[k] for k in WRAPPER_NAMES}


# --------------------------------------------------------------------------
# data, distributed, export and profiler phases
# --------------------------------------------------------------------------

# the data phase: 64 synthetic_shapes_dataset images a split at 256x256 as
# <split>_arrays.npz with palette raw_masks; cli.train of the large_unet
# preset at batch 16 (aug 4: 20 steps, then 4 eval batches) on the native loader
DATA_LENGTH, DATA_SIZE, DATA_BATCH = 64, 256, 16
# the distributed phase's gloo ranks: 2 on the one card, 8 rows each
GLOO_RANKS = 2
# the tensor-parallel phase: 2 gloo ranks on the one card, one model group
# (data=1, model=2), each holding the whole global batch of 8
TP_RANKS, TP_BATCH = 2, 8
# its runs (one augmented step each; the autoencoder never augments) and
# the launches of one step, each the world-1 step's: under remat the
# checkpointed forward runs again in the backward, its kernels with it
PER_FD_REMAT_STEP = {w: PER_FD_STEP.get(w, 0) + PER_FD_FORWARD.get(w, 0)
                     for w in {**PER_FD_STEP, **PER_FD_FORWARD}}
TP_RUNS = {"large_unet": PER_STEP, "clip_unet": PER_STEP, "autoencoder": PER_AE_STEP,
           "clip_res": PER_CLIP_RES_STEP, "segment_classifier": PER_CLASS_STEP,
           "clip_autoencoder": PER_AUG_ONLY_STEP, "unet fused_deep remat": PER_FD_REMAT_STEP}
# the kernel blocks that the rule leaves whole in a run, by key prefix:
# ClipRes's dec5 (32 -> 16) and output block (19 -> 3), under 4096 elements
TP_WHOLE = {"clip_res": ("dec5.", "out."), "segment_classifier": ("dec5.",)}
# the profiler phase: cli.profiler's warm-up step and its traced steps
PROFILE_STEPS = 3


def _palette(masks):
    """Class ids -> the Pet palette values (0 background, 38 cat, 75 dog)."""
    import numpy as np

    return np.array([0, 38, 75], np.uint8)[masks]


def _pipeline_rate(torch, pipe, epochs: int = 3) -> float:
    """Images per second that a pipeline hands to the card over ``epochs``
    epochs after a first one (its set-up: the native loader's thread and
    its slots' page-locking), each batch waited for on the card."""
    for _ in pipe.epoch(0):
        pass
    torch.cuda.synchronize()
    t0, n = time.perf_counter(), 0
    for epoch in range(1, epochs + 1):
        for images, _ in pipe.epoch(epoch):
            torch.cuda.current_stream().synchronize()
            n += images.shape[0]
    return n / (time.perf_counter() - t0)


def data_phase(torch, mods, card: str) -> dict:
    """The Pet route on disk -> the native loader -> cli.train; returns the
    launch counts of its run."""
    import numpy as np

    from image_segmentation_tpu_torch.cli import train as cli_train
    from image_segmentation_tpu_torch.data import native_loader
    from image_segmentation_tpu_torch.data.datasets import load_pet_dataset, synthetic_shapes_dataset
    from image_segmentation_tpu_torch.data.pipeline import BatchPipeline

    if not native_loader.native_loader_available():
        raise AssertionError("the native loader did not build (g++ and runtime/loader.cpp)")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for split, seed in (("train", SEED), ("validation", SEED + 1)):
            ds = synthetic_shapes_dataset(DATA_LENGTH, DATA_SIZE, DATA_SIZE, seed=seed)
            np.savez(Path(tmp) / f"{split}_arrays.npz", images=ds.images, masks=ds.masks,
                     raw_masks=_palette(ds.masks))
        print(f"data: {DATA_LENGTH} synthetic_shapes_dataset images a split at "
              f"{DATA_SIZE}x{DATA_SIZE} written as <split>_arrays.npz in "
              f"{time.perf_counter() - t0!r} s", flush=True)
        # ---- the main path: counts from 0, read right after
        reset_counts(mods)
        t0 = time.perf_counter()
        trainer = cli_train.main(["--preset", "large_unet", "--dataset", "oxford-pet",
                                  "--dataset-loc", tmp, "--epochs", "1", "--batch-size",
                                  str(DATA_BATCH), "--native-loader", "--save-dir",
                                  str(Path(tmp) / "runs"), "--device", DEVICE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts(mods)
        train_pipe, val_pipe = trainer._pipelines()
        if not isinstance(train_pipe, native_loader.NativeBatchPipeline):
            raise AssertionError(f"the train loader is {type(train_pipe).__name__}, not native")
        aug = trainer.config.data.augmentations_per_datapoint
        n_train = DATA_LENGTH * (aug + 1) // DATA_BATCH
        n_val = math.ceil(DATA_LENGTH / DATA_BATCH)
        want = {k: PER_STEP.get(k, 0) * n_train + PER_FORWARD.get(k, 0) * n_val
                for k in WRAPPER_NAMES}
        if launches != want:
            raise AssertionError(f"data phase launches {launches}, expected {want}")
        print(f"data path: loader native, {n_train} train batches of {DATA_BATCH} + {n_val} "
              f"eval batches, cli.train {wall!r} s, launches {launches}", flush=True)

        # the native batches equal the Python pipeline's through the same
        # strided shard at R = 1 (unshuffled: the orders come from different
        # generators), and both pipelines' rates
        pet = load_pet_dataset("train", tmp)
        kw = dict(device=DEVICE, augmentations_per_datapoint=aug, shuffle=False)
        native = native_loader.NativeBatchPipeline(pet, DATA_BATCH, **kw)
        python = BatchPipeline(pet, DATA_BATCH, **kw)
        n = 0
        for (ni, nm), (pi, pm) in zip(native.epoch(0), python.epoch(0)):
            if not (torch.equal(ni, pi) and torch.equal(nm, pm)):
                raise AssertionError(f"native batch {n} differs from the Python pipeline's")
            n += 1
        if n != n_train:
            raise AssertionError(f"{n} batches compared, expected {n_train}")
        kw["shuffle"] = True
        rates = {"native": [], "python": []}
        for _ in range(3):  # in turns: the host's speed drifts within a call
            for name, cls in (("native", native_loader.NativeBatchPipeline),
                              ("python", BatchPipeline)):
                rates[name].append(_pipeline_rate(torch, cls(pet, DATA_BATCH, **kw)))
        print(f"data: the {n} native batches equal the Python pipeline's; loader rates to the "
              f"card (batch {DATA_BATCH}, {DATA_SIZE}x{DATA_SIZE}, {n_train} batches an epoch, "
              f"epochs 1-3 of a fresh pipeline, three turns): native {rates['native']!r} img/s, "
              f"python {rates['python']!r} img/s on {card}", flush=True)
        del trainer, train_pipe, val_pipe, native, python
    torch.cuda.empty_cache()
    return launches


def _gloo_rank(settings: dict) -> dict:
    """One of GLOO_RANKS ranks on the card (``mesh.launch``, gloo), with
    the launching process's ``settings`` (DEVICE, BATCH, SIZE, ...): its 8
    rows of a fixed global batch of 16 at 512x512 through one augmented
    train step of train_config(), then a second step, timed.  Rank 0 then
    computes, alone, the world-1 step on the whole batch (and the same
    step in fp32 on the plain path) and holds the averaged gradients of the
    first step to it as the kernel-vs-plain checks do (``_check_gradients``:
    GRAD_RL2, or for a leaf that bf16 rounding alone moves by more, the
    fp32 gradient).  Returns the loss, that check's largest error, whether
    the ranks' parameters are bit-identical, and the times."""
    import numpy as np
    import torch

    from image_segmentation_tpu_torch.engine.train import Trainer
    from image_segmentation_tpu_torch.parallel import mesh

    globals().update(settings)

    def sync():
        if DEVICE == "cuda":
            torch.cuda.synchronize()

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_config()
    rng = np.random.default_rng(SEED + 11)
    images = torch.from_numpy(rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8))
    masks = torch.from_numpy(rng.integers(0, NUM_CLASSES, (BATCH, SIZE, SIZE), dtype=np.uint8))
    rows = mesh.rows(BATCH)
    trainer = Trainer(cfg, device=DEVICE, make_artifacts=False)
    mine = images[rows].to(DEVICE), masks[rows].to(DEVICE)
    loss = float(trainer.train_step(*mine, STEP_KEY))
    grads = _grads(trainer.model)
    stats = {k: v.clone() for k, v in trainer.model.named_buffers() if "running" in k}
    sync()
    t0 = time.perf_counter()
    trainer.train_step(*mine, STEP_KEY + 1)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3
    flat = torch.cat([p.detach().reshape(-1) for p in trainer.model.parameters()])
    rank0 = flat.clone()
    mesh.broadcast_([rank0])
    same = bool(torch.equal(flat, rank0))
    # the gradient all-reduce alone (the averaged gradients are equal on
    # every rank, so averaging them again leaves them as they are)
    sync()
    t0 = time.perf_counter()
    for _ in range(3):
        mesh.average_gradients(trainer.trainable)
    sync()
    allreduce_ms = (time.perf_counter() - t0) * 1e3 / 3
    out = {"rank": mesh.rank(), "loss": loss, "params_identical": same,
           "step_ms": step_ms, "allreduce_ms": allreduce_ms,
           "grad_bytes": 4 * sum(p.numel() for p in trainer.trainable)}
    del trainer, flat, rank0
    if mesh.is_main():
        full = images.to(DEVICE), masks.to(DEVICE)
        with mesh.local():
            ref = Trainer(cfg, device=DEVICE, make_artifacts=False)
            ref_loss = float(ref.train_step(*full, STEP_KEY))
            ref_grads = _grads(ref.model)
            ref_stats = dict(ref.model.named_buffers())
            del ref
            with plain_path(kernel_modules()):
                ref32 = Trainer(dataclasses.replace(cfg, bf16=False), device=DEVICE,
                                make_artifacts=False)
                ref32.train_step(*full, STEP_KEY)
                grads32 = _grads(ref32.model)
            del ref32
        err, leaf, held = _check_gradients(torch, grads, ref_grads, grads32)
        # the leaves held directly nearest the limit, each with how far bf16
        # rounding alone puts the world-1 step (and the two ranks' step)
        # from the fp32 step
        held_names = {n for n, _, _ in held}
        direct = sorted(((_rel_l2(grads, ref_grads, n), n) for n in ref_grads
                         if n not in held_names), reverse=True)[:3]
        nearest = [[n, e, _rel_l2(ref_grads, grads32, n), _rel_l2(grads, grads32, n)]
                   for e, n in direct]
        # the running statistics committed by the first step: enc1's first
        # BatchNorm takes (S, Q) from conv3x3's epilogue over identical rows,
        # summed over the ranks, so only the order of the fp32 sums differs
        stat_err = {k: ((v - ref_stats[k]).abs().max() / ref_stats[k].abs().max()).item()
                    for k, v in stats.items()}
        out.update(ref_loss=ref_loss, max_rel_err=err, worst_leaf=leaf, nearest=nearest,
                   held=[[n, p32, k32] for n, p32, k32 in held], stat_err=stat_err)
    return out


def distributed_phase(torch, mods, card: str) -> dict:
    """cli.train_distributed on NCCL at world size 1 (counted), then
    GLOO_RANKS gloo ranks on the card against the world-1 step; returns
    the launch counts of the CLI run."""
    from image_segmentation_tpu_torch.cli import train_distributed
    from image_segmentation_tpu_torch.parallel import mesh

    cfg = train_config()
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts(mods)
        t0 = time.perf_counter()
        trainer = train_distributed.main([
            "--preset", "large_unet", "--dataset", "synthetic", "--image-size", str(SIZE),
            "--synthetic-length", str(TRAIN_LENGTH), "--batch-size", str(BATCH), "--epochs", "1",
            "--coordinator", f"localhost:{mesh.free_port()}", "--num-processes", "1",
            "--process-id", "0", "--save-dir", tmp, "--device", DEVICE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts(mods)
        backend = torch.distributed.get_backend()
        world = mesh.world_size()
        mesh.shutdown()
        if backend != ("nccl" if DEVICE == "cuda" else "gloo") or world != 1:
            raise AssertionError(f"train_distributed ran on {backend} at world size {world}")
        n_train = TRAIN_LENGTH * (cfg.data.augmentations_per_datapoint + 1) // BATCH
        n_val = math.ceil(TRAIN_LENGTH / BATCH)
        want = {k: PER_STEP.get(k, 0) * n_train + PER_FORWARD.get(k, 0) * n_val
                for k in WRAPPER_NAMES}
        if launches != want:
            raise AssertionError(f"train_distributed launches {launches}, expected {want}")
        if not (Path(trainer.run_dir) / "model_1.npz").exists():
            raise AssertionError("train_distributed wrote no checkpoint")
        print(f"train_distributed: nccl, world 1, {n_train} steps + {n_val} eval batches at "
              f"{SIZE}x{SIZE}, {wall!r} s, launches {launches}", flush=True)
        del trainer
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    settings = {k: globals()[k] for k in ("DEVICE", "SEED", "BATCH", "SIZE", "TRAIN_LENGTH",
                                          "STEP_KEY")}
    ranks = mesh.launch("chip_smoke:_gloo_rank", GLOO_RANKS, [settings], backend="gloo",
                        timeout=600)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    losses = [r["loss"] for r in ranks]
    loss_err = abs(losses[0] - r0["ref_loss"]) / abs(r0["ref_loss"])
    print(f"gloo, {GLOO_RANKS} ranks on the card, one augmented step of train_config() "
          f"(global batch {BATCH}, {BATCH // GLOO_RANKS} rows a rank, {SIZE}x{SIZE}): losses "
          f"{losses} vs world-1 {r0['ref_loss']!r} (rel {loss_err!r}, limit {LOSS_RTOL}); "
          f"averaged gradients vs world-1: max relative L2 {r0['max_rel_err']!r} "
          f"({r0['worst_leaf']}, limit {GRAD_RL2}); the three held directly nearest the limit "
          f"(leaf, vs world-1, world-1 bf16 vs fp32, 2 ranks vs fp32): {r0['nearest']}; "
          f"held to the fp32 gradient (leaf, world-1 "
          f"bf16 vs fp32, 2 ranks vs fp32; limit {BF16_NOISE_FACTOR}x): {r0['held']}; "
          f"parameters identical across ranks {[r['params_identical'] for r in ranks]}; second "
          f"step {[r['step_ms'] for r in ranks]} ms, gradient all-reduce "
          f"{[r['allreduce_ms'] for r in ranks]} ms per step "
          f"({r0['grad_bytes']} B); {wall!r} s with the processes' start on {card}", flush=True)
    enc1 = {k: v for k, v in r0["stat_err"].items() if k.startswith("enc1.block.0.conv.1.")}
    print(f"gloo: running statistics vs world-1, max relative error {max(r0['stat_err'].values())!r}"
          f" over every BatchNorm, enc1's first (the conv3x3 epilogue's sums) {enc1} (limit "
          f"{SUM_RTOL})", flush=True)
    if len(enc1) != 2 or max(enc1.values()) > SUM_RTOL:
        raise AssertionError(f"enc1's running statistics at {GLOO_RANKS} ranks: {enc1}")
    if len(set(losses)) != 1 or loss_err > LOSS_RTOL:
        raise AssertionError(f"gloo losses {losses} vs world-1 {r0['ref_loss']}")
    if not all(r["params_identical"] for r in ranks):
        raise AssertionError("the ranks' parameters differ after the step")
    return launches


def _tp_config(name: str, n_model: int):
    """A run of the tensor-parallel phase (``TP_RUNS``) at batch TP_BATCH
    with ``n_model`` shards: ``train_config()`` (512x512), the CLIP presets
    (``clip_config``, 256x256), the autoencoder preset (``ae_config``,
    256x256), or the unet preset at UNET_SIZE with ``fused_deep`` and
    ``remat``."""
    if name == "large_unet":
        cfg = train_config()
    elif name == "autoencoder":
        cfg = ae_config()
    elif name == "unet fused_deep remat":
        cfg = dataclasses.replace(train_config("unet", UNET_SIZE, fused_deep=True), remat=True)
    else:
        cfg = clip_config(name)
    return dataclasses.replace(cfg, batch_size=TP_BATCH, n_model_shards=n_model)


def tp_batch(name: str, size: int):
    """The fixed uint8 global batch of the tensor-parallel run ``name``
    (numpy): TP_BATCH images and masks, class ids or, for the class and
    prompt tasks, palette masks."""
    import numpy as np

    from image_segmentation_tpu_torch.data.datasets import (
        CAT_PALETTE, DOG_PALETTE, UNCERTAIN_PALETTE)

    rng = np.random.default_rng(SEED + 13)
    images = rng.integers(0, 256, (TP_BATCH, size, size, 3), dtype=np.uint8)
    palette = name in ("segment_classifier", "prompt")
    masks = rng.integers(0, NUM_CLASSES + palette, (TP_BATCH, size, size)).astype(np.uint8)
    if palette:
        masks = np.array([0, CAT_PALETTE, DOG_PALETTE, UNCERTAIN_PALETTE], np.uint8)[masks]
    return images, masks


def _kernel_block_weights(model) -> dict:
    """The conv and ConvTranspose weights of the model's fused kernel
    blocks, by state-dict key: each ``FusedConvBlock`` (the level 0-2
    blocks' own, the ``FusedDeep…`` blocks', a fused bottleneck) and the
    up-conv of each ``FusedConvBlockUpsample[Skip]`` (the ConvTranspose
    kernel; the ``FusedDeep…`` decoders' up-conv is cuDNN's)."""
    from image_segmentation_tpu_torch.models import fused

    out = {}
    for name, m in model.named_modules():
        if isinstance(m, fused.FusedConvBlock):
            out[f"{name}.conv.0.weight"], out[f"{name}.conv.3.weight"] = (
                m.conv[0].weight, m.conv[3].weight)
        elif isinstance(m, (fused.FusedConvBlockUpsampleSkip, fused.FusedConvBlockUpsample)):
            out[f"{name}.up.weight"] = m.up.weight
    return out


def _frozen_backbone(torch, trainer) -> tuple:
    """The ResNet-34's whole parameters and running statistics, cloned."""
    from image_segmentation_tpu_torch.parallel import tensor
    from image_segmentation_tpu_torch.utils.convert import RESNET

    params = tensor.full_state(trainer.model, {k: p.detach() for k, p in
                                               trainer.model.named_parameters()
                                               if k.startswith(RESNET)})
    stats = {k: b.clone() for k, b in trainer.model.named_buffers()
             if k.startswith(RESNET) and not k.endswith("num_batches_tracked")}
    return {k: v.clone() for k, v in params.items()}, stats


def _tp_run(name: str) -> dict:
    """One run of :func:`_tp_rank`; see there."""
    import torch

    from image_segmentation_tpu_torch.engine.train import Trainer
    from image_segmentation_tpu_torch.parallel import mesh, tensor

    def sync():
        if DEVICE == "cuda":
            torch.cuda.synchronize()

    mods = kernel_modules()
    cfg = _tp_config(name, TP_RANKS)
    images, masks = (torch.from_numpy(a) for a in tp_batch(name, cfg.data.image_size))
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, device=DEVICE, make_artifacts=False)
    rows = mesh.rows(TP_BATCH)  # the data row's: the grid is the Trainer's
    mine = images[rows].to(DEVICE), masks[rows].to(DEVICE)
    shards = tensor.shards(trainer.model)
    whole = TP_WHOLE.get(name, ())
    co = {}
    for key, w in _kernel_block_weights(trainer.model).items():
        s = shards.get(key)
        if key.startswith(whole):  # left whole by the rule (under its 4096 elements)
            if s is not None:
                raise AssertionError(f"{name}: the kernel block weight {key} is sharded ({s})")
            co[key] = w.shape[1 if key.endswith("up.weight") else 0]
        elif s is None or w.shape[s.dim] * TP_RANKS != s.length:
            raise AssertionError(f"{name}: the kernel block weight {key} {tuple(w.shape)} is "
                                 f"not a 1/{TP_RANKS} slice ({s})")
        else:
            co[key] = w.shape[s.dim]
    backbone = _frozen_backbone(torch, trainer) if trainer.frozen and "res" in cfg.model else None
    reset_counts(mods)
    loss = float(trainer.train_step(*mine, STEP_KEY))
    sync()
    launches = counts(mods)
    grads = {k: g.cpu() for k, g in tensor.full_state(
        trainer.model, {k: p.grad.detach().float() for k, p in
                        trainer.model.named_parameters() if p.requires_grad}).items()}
    flat = torch.cat([p.detach().reshape(-1) for p in tensor.full_state(
        trainer.model, dict(trainer.model.named_parameters())).values()])
    rank0 = flat.clone()
    mesh.broadcast_([rank0])
    same = bool(torch.equal(flat, rank0))
    del flat, rank0
    frozen = None
    if backbone is not None:
        params, stats = _frozen_backbone(torch, trainer)
        frozen = {"changed": [k for k in params if not torch.equal(params[k], backbone[0][k])],
                  "moved": sum(not torch.equal(stats[k], backbone[1][k]) for k in stats),
                  "stats": len(stats), "sharded": sum(k in shards for k in params)}
        del params, stats, backbone
    sync()
    if DEVICE == "cuda":  # the peak of a step with none of the checks' copies on the card
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.train_step(*mine, STEP_KEY + 1)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    coll = {}

    def timed(what, fn):
        def run(t, *args, **kwargs):
            sync()
            t1 = time.perf_counter()
            out = fn(t, *args, **kwargs)
            sync()
            c = coll.setdefault(what, [0.0, 0, 0])
            c[0] += (time.perf_counter() - t1) * 1e3
            c[1] += 1
            c[2] += t.numel() * t.element_size()
            return out
        return run

    with ExitStack() as stack:
        for what in ("gather", "reduce_scatter", "all_reduce"):
            stack.enter_context(mock.patch.object(tensor, what, timed(what, getattr(tensor, what))))
        trainer.train_step(*mine, STEP_KEY + 2)
    out = {"rank": mesh.rank(), "loss": loss, "launches": launches, "params_identical": same,
           "step_ms": step_ms, "collectives": coll, "peak_bytes": peak, "frozen": frozen,
           "sharded": len(trainer.tp_plan), "leaves": len(list(trainer.model.parameters())),
           "kernel_block_co": co}
    del trainer
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    if mesh.is_main():
        full = images.to(DEVICE), masks.to(DEVICE)
        one = _tp_config(name, 1)
        with mesh.local():
            ref = Trainer(one, device=DEVICE, make_artifacts=False)
            ref_loss = float(ref.train_step(*full, STEP_KEY))
            ref_grads = {k: g.cpu() for k, g in _grads(ref.model).items()}
            sync()
            if DEVICE == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ref.train_step(*full, STEP_KEY + 1)
            sync()
            ref_ms = (time.perf_counter() - t0) * 1e3
            ref_peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
            del ref
            with plain_path(kernel_modules()):
                ref32 = Trainer(dataclasses.replace(one, bf16=False), device=DEVICE,
                                make_artifacts=False)
                ref32.train_step(*full, STEP_KEY)
                grads32 = {k: g.cpu() for k, g in _grads(ref32.model).items()}
            del ref32
        err, leaf, held = _check_gradients(torch, grads, ref_grads, grads32)
        out.update(ref_loss=ref_loss, ref_step_ms=ref_ms, ref_peak_bytes=ref_peak,
                   max_rel_err=err, worst_leaf=leaf,
                   held=[[n, p32, k32] for n, p32, k32 in held])
        del ref_grads, grads32
    del grads
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def _tp_rank(settings: dict, names: list) -> dict:
    """One of TP_RANKS ranks of the tensor-parallel phase (``mesh.launch``,
    gloo, one model group) with the launching process's ``settings``, for
    each run in ``names``: one augmented step (the autoencoder's never is)
    of ``_tp_config(name)`` on a fixed global batch with exact launch
    counts and the kernel blocks' weights checked to be their ``Co/M``
    slices (or whole, where the rule leaves them so: ``TP_WHOLE``), the
    gathered gradients and parameters, the frozen ResNet-34 of the ClipRes
    runs made whole before and after the step, a second step timed with its
    peak memory (the gathered gradients on the host, the backbone's copies
    freed), a third with the model group's collectives timed (each waited
    for).  Rank 0 then computes, alone, the world-1 step on the same batch
    (its second step's time and peak memory the same way, and the first
    step in fp32 on the plain path) and holds the gathered gradients to it
    as the distributed phase does.  Returns each
    run's results by name."""
    import torch

    globals().update(settings)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return {name: _tp_run(name) for name in names}


def tp_phase(torch, mods, card: str) -> None:
    """TP_RANKS gloo ranks on the card at (data=1, model=TP_RANKS), one
    ``mesh.launch`` for every run of ``TP_RUNS``: each step against world 1
    (see :func:`_tp_rank`)."""
    from image_segmentation_tpu_torch.parallel import mesh

    settings = {k: globals()[k] for k in ("DEVICE", "SEED", "BATCH", "SIZE", "TRAIN_LENGTH",
                                          "STEP_KEY", "PROMPT_SIZE", "PROMPT_LENGTH",
                                          "PROMPT_BATCH", "TP_BATCH", "AE_SIZE", "AE_LENGTH",
                                          "UNET_SIZE")}
    t0 = time.perf_counter()
    runs = mesh.launch("chip_smoke:_tp_rank", TP_RANKS, [settings, list(TP_RUNS)],
                       backend="gloo", timeout=900)
    wall = time.perf_counter() - t0
    print(f"tensor parallel: {len(TP_RUNS)} runs in one launch of {TP_RANKS} gloo ranks, "
          f"{wall!r} s with the processes' start on {card}", flush=True)
    for name, per_step in TP_RUNS.items():
        ranks = [r[name] for r in runs]
        r0 = ranks[0]
        losses = [r["loss"] for r in ranks]
        loss_err = abs(losses[0] - r0["ref_loss"]) / abs(r0["ref_loss"])
        want = expected(per_step)
        cfg = _tp_config(name, 1)
        size = cfg.data.image_size
        print(f"tensor parallel {name}: gloo, {TP_RANKS} ranks on the card at (data=1, "
              f"model={TP_RANKS}), global batch {TP_BATCH} on every rank, {size}x{size}, "
              f"augmentation {cfg.data.augmentations_per_datapoint}, {r0['sharded']} of "
              f"{r0['leaves']} parameters sharded; one step: "
              f"losses {losses} vs world-1 {r0['ref_loss']!r} (rel {loss_err!r}, limit "
              f"{LOSS_RTOL}); gathered gradients vs world-1: max relative L2 "
              f"{r0['max_rel_err']!r} ({r0['worst_leaf']}, limit {GRAD_RL2}); held to the fp32 "
              f"gradient (leaf, world-1 bf16 vs fp32, TP vs fp32; limit {BF16_NOISE_FACTOR}x): "
              f"{r0['held']}; parameters identical across ranks "
              f"{[r['params_identical'] for r in ranks]}; launches per rank "
              f"{[r['launches'] for r in ranks]}; kernel-block output channels "
              f"{r0['kernel_block_co']}", flush=True)
        print(f"tensor parallel {name}: step {[r['step_ms'] for r in ranks]} ms at "
              f"(1, {TP_RANKS}) vs {r0['ref_step_ms']!r} ms at world 1 (batch {TP_BATCH}); "
              f"model-group collectives in a step, each waited for (ms, calls, bytes): "
              f"{[r['collectives'] for r in ranks]}; peak memory per rank "
              f"{[r['peak_bytes'] for r in ranks]} B vs {r0['ref_peak_bytes']!r} B at world 1 "
              f"(rank 0 alone; each over a second step) on {card}", flush=True)
        if len(set(losses)) != 1 or loss_err > LOSS_RTOL:
            raise AssertionError(f"tensor parallel {name}: losses {losses} vs world-1 "
                                 f"{r0['ref_loss']}")
        if not all(r["params_identical"] for r in ranks):
            raise AssertionError(f"tensor parallel {name}: the ranks' parameters differ")
        for r in ranks:
            if r["launches"] != want:
                raise AssertionError(f"tensor parallel {name}, rank {r['rank']}: launches "
                                     f"{r['launches']}, expected {want}")
        if "res" in cfg.model:
            frozen = [r["frozen"] for r in ranks]
            print(f"tensor parallel {name}: the frozen ResNet-34, {frozen[0]['sharded']} convs "
                  f"sharded, made whole: unchanged by the step on every rank "
                  f"{[not f['changed'] for f in frozen]}, running statistics moved "
                  f"{[f['moved'] for f in frozen]} of {frozen[0]['stats']}", flush=True)
            if any(f["changed"] or f["moved"] != f["stats"] or not f["sharded"] for f in frozen):
                raise AssertionError(f"tensor parallel {name}: the frozen ResNet-34 {frozen}")


def export_phase(torch, mods, card: str) -> dict:
    """The served LargeUNet at 512x512 as an exported program on the card
    (``export_model(exported_program=True)`` -> ``load_program``); returns
    the launch counts of the program's two checked calls."""
    import numpy as np

    from image_segmentation_tpu_torch.engine.export import export_model, load_model, load_program
    from image_segmentation_tpu_torch.models.registry import build_model
    from image_segmentation_tpu_torch.ops.augment import normalize_image

    model_args = train_config().model_args
    model = build_model("large_unet", device=DEVICE, **model_args)
    randomize_(torch, model, SEED)
    with tempfile.TemporaryDirectory() as art:
        t0 = time.perf_counter()
        export_model(model, "large_unet", model_args, out_dir=art, exported_program=True,
                     image_size=SIZE)
        export_s = time.perf_counter() - t0
        served = load_model(art, device=DEVICE)
        program = load_program(str(Path(art) / "model.pt2"))
        size_mb = (Path(art) / "model.pt2").stat().st_size / 1e6
    del model
    ops = [str(n.target) for n in program.program.graph.nodes if str(n.target).startswith("imgseg.")]
    per_op = {op: sum(o.startswith(op) for o in ops) for op in
              ("imgseg.conv3x3", "imgseg.maxpool2x2_affine_relu", "imgseg.convtranspose2x2")}
    if per_op != {"imgseg.conv3x3": 8, "imgseg.maxpool2x2_affine_relu": 2,
                  "imgseg.convtranspose2x2": 2}:
        raise AssertionError(f"the exported graph's imgseg operators: {per_op}")
    rng = np.random.default_rng(SEED + 3)
    x16 = normalize_image(torch.from_numpy(
        rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)).to(DEVICE))
    # ---- the main path: counts from 0, read right after
    reset_counts(mods)
    got16, got1 = program(x16), program(x16[:1])
    torch.cuda.synchronize()
    launches = counts(mods)
    if launches != expected(PER_FORWARD, 2):
        raise AssertionError(f"exported program launches {launches}, expected "
                             f"{expected(PER_FORWARD, 2)}")
    with torch.inference_mode():
        ref16, ref1 = served(x16), served(x16[:1])
    for name, got, ref in (("b16", got16, ref16), ("b1", got1, ref1)):
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(f"program logits {name}: {tuple(got.shape)}")
        diff = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        print(f"exported program {name} vs the eager forward: max_abs_diff={diff!r} (limit "
              f"{LOGITS_RTOL} x {scale!r}), argmax agreement={agree!r} (limit "
              f"{ARGMAX_AGREEMENT})", flush=True)
        if diff > LOGITS_RTOL * scale or agree < ARGMAX_AGREEMENT:
            raise AssertionError(f"the exported program's {name} logits disagree")
    del got16, got1, ref16, ref1
    with torch.inference_mode():
        times = {f"{what} b{b}": cuda_ms(torch, lambda: fn(x16[:b]), iters=3 if b > 1 else 20,
                                         warmup=3)
                 for b in (BATCH, 1) for what, fn in (("program", program), ("eager", served))}
    print(f"export: torch.export of LargeUNet@{SIZE} in {export_s!r} s ({size_mb!r} MB, "
          f"operators {per_op}); ms per call {times} on {card}", flush=True)
    del served, program
    torch.cuda.empty_cache()
    return launches


def profiler_phase(torch, mods, card: str) -> dict:
    """cli.profiler of the large_unet preset: a trace file and the memory
    report; returns the launch counts of its run."""
    from image_segmentation_tpu_torch.cli import profiler

    with tempfile.TemporaryDirectory() as tmp:
        reset_counts(mods)
        t0 = time.perf_counter()
        path = profiler.main(["--preset", "large_unet", "--dataset", "synthetic", "--batch-size",
                              str(DATA_BATCH), "--steps", str(PROFILE_STEPS), "--log-dir", tmp,
                              "--device", DEVICE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts(mods)
        want = expected(PER_STEP, PROFILE_STEPS + 1)  # the warm-up step and the traced ones
        if launches != want:
            raise AssertionError(f"profiler launches {launches}, expected {want}")
        size = Path(path).stat().st_size if Path(path).exists() else 0
        if size == 0:
            raise AssertionError(f"cli.profiler wrote no trace at {path}")
        print(f"profiler: cli.profiler large_unet, {PROFILE_STEPS} traced steps, trace "
              f"{Path(path).name} {size} B, {wall!r} s, launches {launches} on {card}", flush=True)
    return launches


# --------------------------------------------------------------------------
# options phase
# --------------------------------------------------------------------------



def _fold1_blocks(model) -> list:
    from image_segmentation_tpu_torch.models import fused

    deep = (fused.FusedDeepConvBlockDownsample, fused.FusedDeepConvBlockUpsampleSkip)
    return [n for n, m in model.named_children()
            if isinstance(m, deep) or type(m) is fused.FusedConvBlock]


def _u8_batch(torch, seed: int, size: int, batch: Optional[int] = None):
    import numpy as np

    batch = batch or BATCH
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
    masks = rng.integers(0, NUM_CLASSES, (batch, size, size)).astype(np.uint8)
    return torch.from_numpy(images).to(DEVICE), torch.from_numpy(masks).to(DEVICE)


def _snapshot(trainer) -> dict:
    """Parameters, buffers and Adam moments of a Trainer, cloned."""
    out = {f"state {k}": v.clone() for k, v in trainer.model.state_dict().items()}
    for i, p in enumerate(trainer.trainable):
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"adam {i} {k}"] = trainer.optimizer.state[p][k].clone()
    return out


def _differ(torch, a: dict, b: dict) -> list:
    return [k for k in a if not torch.equal(a[k], b[k])]


def _timed_turns(torch, images, masks, trainers: dict, card: str, what: str,
                 steps: int = 3) -> dict:
    """Step ms of each Trainer in turns (a, b, b, a), each the mean of
    ``steps`` steps after one, and the peak memory of its steps above what
    was allocated before them (both Trainers resident); returns {name:
    [ms, ms]}."""
    names = list(trainers)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        ms = _step_ms(torch, trainers[n], images, masks, steps)
        peak = torch.cuda.max_memory_allocated()
        times[n].append(ms)
        print(f"{what}, {n}: {ms!r} ms a step, max_memory_allocated {peak!r} B "
              f"({peak - resident!r} B above the {resident!r} B resident) on {card}", flush=True)
    return times


def fused_deep_training(torch, mods, card: str, name: str = "large_unet",
                        size: Optional[int] = None) -> dict:
    """A U-Net preset with ``fused_deep=True``: one epoch with exact counts
    (the main path), one step's counts, 3 steps held to the plain path;
    for large_unet the step timed beside ``fused_deep=False`` in turns.
    Returns the launch counts of the epoch."""
    from image_segmentation_tpu_torch.engine.train import Trainer

    size = size or SIZE
    cfg = train_config(name, size, fused_deep=True)
    what = f"fused_deep {name}@{size}"
    trainer = Trainer(cfg, device=DEVICE, make_artifacts=False)
    blocks = _fold1_blocks(trainer.model)
    if blocks != FUSED_DEEP_BLOCKS[name]:
        raise AssertionError(f"{what}: fold-1 kernel blocks {blocks}")
    print(f"trainer: {what}, batch {cfg.batch_size}, fold-1 kernel blocks {blocks}", flush=True)
    launches = _train_epoch(torch, mods, trainer, PER_FD_STEP, PER_FD_FORWARD, what)
    images, masks = _u8_batch(torch, SEED + 37, size)
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    _step_launches(torch, mods, trainer, images, masks, PER_FD_STEP, what)
    if name == "large_unet":
        off = Trainer(train_config(name, size), device=DEVICE, make_artifacts=False)
        off.model.load_state_dict(state)
        trainer.model.load_state_dict(state)
        turns = _timed_turns(torch, images, masks,
                             {"fused_deep=False": off, "fused_deep=True": trainer}, card,
                             f"train step LargeUNet@{size} bf16 batch {BATCH}")
        print(f"{what}: step ms fused_deep=True {turns['fused_deep=True']} against "
              f"fused_deep=False {turns['fused_deep=False']} on {card}", flush=True)
        del off
    del trainer
    torch.cuda.empty_cache()
    times = _kernel_vs_plain(torch, mods, cfg, state, images, masks)
    _print_times(what, BATCH, times, card)
    return launches


def fused_deep_serving(torch, mods, card: str) -> dict:
    """A large_unet with ``fused_deep=True`` written with ``export_model``
    and read with ``load_model``: batch-16 and batch-1 forwards with exact
    counts (the main path), the batch-16 logits held to the plain path,
    both timed beside the same weights with ``fused_deep=False``.  Returns
    the launch counts of the two forwards."""
    from image_segmentation_tpu_torch.engine.export import export_model, load_model
    from image_segmentation_tpu_torch.models.registry import build_model
    from image_segmentation_tpu_torch.ops.augment import normalize_image

    model_args = train_config(fused_deep=True).model_args
    model = build_model("large_unet", device=DEVICE, **model_args)
    randomize_(torch, model, SEED + 3)
    with tempfile.TemporaryDirectory() as art:
        export_model(model, "large_unet", model_args, out_dir=art)
        served = load_model(art, device=DEVICE)
    off = build_model("large_unet", device=DEVICE, **train_config().model_args)
    off.load_state_dict(model.state_dict())
    off.eval().requires_grad_(False)
    del model
    if _fold1_blocks(served) != FUSED_DEEP_BLOCKS["large_unet"]:
        raise AssertionError(f"served fused_deep model: fold-1 blocks {_fold1_blocks(served)}")
    x16 = normalize_image(_u8_batch(torch, SEED + 43, SIZE)[0])
    with torch.inference_mode():
        reset_counts(mods)
        logits = served(x16)
        logits1 = served(x16[:1])
        torch.cuda.synchronize()
        launches = counts(mods)
        if launches != expected(PER_FD_FORWARD, 2):
            raise AssertionError(f"fused_deep serving launches {launches}, expected "
                                 f"{expected(PER_FD_FORWARD, 2)}")
        with plain_path(mods):
            plain_logits = served(x16)
    for t, b in ((logits, BATCH), (logits1, 1)):
        if tuple(t.shape) != (b, SIZE, SIZE, NUM_CLASSES) or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"fused_deep logits batch {b}: {tuple(t.shape)}, not finite")
    diff = (logits - plain_logits).abs().max().item()
    scale = plain_logits.abs().max().item()
    agree = (logits.argmax(-1) == plain_logits.argmax(-1)).float().mean().item()
    print(f"fused_deep serving: launches {launches}; logits b16 kernel vs plain path: "
          f"max_abs_diff={diff!r} (limit {LOGITS_RTOL} x {scale!r}), argmax agreement={agree!r} "
          f"(limit {ARGMAX_AGREEMENT})", flush=True)
    if diff > LOGITS_RTOL * scale or agree < ARGMAX_AGREEMENT:
        raise AssertionError("fused_deep kernel-path logits disagree with the plain path")
    del plain_logits
    with torch.inference_mode():
        for m, what in ((off, "fused_deep=False"), (served, "fused_deep=True"),
                        (served, "fused_deep=True"), (off, "fused_deep=False")):
            b16 = cuda_ms(torch, lambda: m(x16), iters=3)
            b1 = cuda_ms(torch, lambda: m(x16[:1]), iters=20, warmup=3)
            print(f"serving LargeUNet@{SIZE} bf16 {what}: batch {BATCH} {b16!r} ms, batch 1 "
                  f"{b1!r} ms on {card}", flush=True)
    del served, off
    torch.cuda.empty_cache()
    return launches


def remat_check(torch, mods, card: str) -> None:
    """train_config() with ``remat`` against without, from one state over
    OPTION_STEPS steps on one batch and draw: parameters, running
    statistics and Adam moments bit for bit (or, where two runs without
    remat already differ, bit for bit under cudnn.deterministic, the
    leaves named); then step time and peak memory both ways, in turns."""
    from image_segmentation_tpu_torch.engine.train import Trainer

    cfg = train_config()
    images, masks = _u8_batch(torch, SEED + 47, SIZE)
    state = {k: v.clone() for k, v in
             Trainer(cfg, device=DEVICE, make_artifacts=False).model.state_dict().items()}

    def run(remat: bool):
        t = Trainer(dataclasses.replace(cfg, remat=remat), device=DEVICE, make_artifacts=False)
        t.model.load_state_dict(state)
        for _ in range(OPTION_STEPS):
            t.train_step(images, masks, STEP_KEY)
        return t

    on, off = run(True), run(False)
    a, b = _snapshot(on), _snapshot(off)
    diff = _differ(torch, a, b)
    if diff:
        nondet = _differ(torch, b, _snapshot(run(False)))
        print(f"remat vs no remat: {len(diff)} of {len(b)} leaves differ (first {diff[:4]}); "
              f"two runs without remat differ in {len(nondet)} (first {nondet[:4]})", flush=True)
        if not nondet:
            raise AssertionError(f"remat changes the step: {diff[:8]}")
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            diff = _differ(torch, _snapshot(run(True)), _snapshot(run(False)))
        finally:
            torch.backends.cudnn.deterministic = deterministic
        if diff:
            raise AssertionError(f"remat changes the step under cudnn.deterministic: {diff[:8]}")
        print("remat vs no remat: bit for bit under cudnn.deterministic (cuDNN's default "
              "backward algorithms are not deterministic run to run)", flush=True)
    else:
        print(f"remat vs no remat after {OPTION_STEPS} steps: {len(b)} parameters, running "
              "statistics and Adam moments bit for bit", flush=True)
    del a, b
    torch.cuda.empty_cache()
    turns = _timed_turns(torch, images, masks, {"remat=False": off, "remat=True": on}, card,
                         f"train step LargeUNet@{SIZE} bf16 batch {BATCH}")
    print(f"remat: step ms {turns['remat=True']} against {turns['remat=False']} without "
          f"on {card}", flush=True)
    del on, off
    torch.cuda.empty_cache()


def freeze_clip_check(torch, mods, card: str) -> None:
    """The clip_unet preset at 256x256, batch 32 with ``freeze_clip=False``
    against ``True``, from one state over OPTION_STEPS steps: every
    parameter, buffer and Adam moment bit for bit, the tower unchanged and
    without a gradient; step time both ways, in turns."""
    from image_segmentation_tpu_torch.engine.train import Trainer
    from image_segmentation_tpu_torch.utils.convert import CLIP

    cfg = clip_config("clip_unet")
    images, masks = _clip_batch(torch, SEED + 53, palette=False)
    trainers, snaps = {}, {}
    for freeze in (True, False):
        c = dataclasses.replace(cfg, model_args=dict(cfg.model_args, freeze_clip=freeze))
        t = Trainer(c, device=DEVICE, make_artifacts=False)
        if freeze:
            state = {k: v.clone() for k, v in t.model.state_dict().items()}
        t.model.load_state_dict(state)
        for _ in range(OPTION_STEPS):
            t.train_step(images, masks, STEP_KEY)
        for k, p in t.model.named_parameters():
            if k.startswith(CLIP) and (p.grad is not None or not torch.equal(p, state[k])
                                       or p.requires_grad == freeze):
                raise AssertionError(f"freeze_clip={freeze}: the tower's {k} moved, holds a "
                                     "gradient or has the wrong requires_grad")
        trainers[f"freeze_clip={freeze}"], snaps[freeze] = t, _snapshot(t)
    diff = _differ(torch, snaps[True], snaps[False])
    if diff:
        raise AssertionError(f"freeze_clip=False changes the step: {diff[:8]}")
    print(f"freeze_clip=False vs True after {OPTION_STEPS} steps: {len(snaps[True])} "
          "parameters, buffers and Adam moments bit for bit, the tower unchanged", flush=True)
    del snaps
    # the step is host-bound and its time drifts over the first steps of a
    # Trainer: one untimed turn each, then 10 steps a turn
    for t in trainers.values():
        _step_ms(torch, t, images, masks)
    turns = _timed_turns(torch, images, masks, trainers, card,
                         f"train step ClipUnet@{PROMPT_SIZE} bf16 batch {PROMPT_BATCH}", 10)
    print(f"freeze_clip: step ms {turns['freeze_clip=False']} with the tower unfrozen, "
          f"{turns['freeze_clip=True']} frozen, on {card}", flush=True)
    del trainers
    torch.cuda.empty_cache()


def options_phase(torch, mods, card: str) -> list:
    """The options that are off in every preset (see the module doc);
    returns the launch counts of its main-path runs."""
    runs = [fused_deep_training(torch, mods, card), fused_deep_serving(torch, mods, card),
            fused_deep_training(torch, mods, card, "unet", UNET_SIZE)]
    remat_check(torch, mods, card)
    freeze_clip_check(torch, mods, card)
    return runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from image_segmentation_tpu_torch.ops import _build

    mods = kernel_modules()
    # fp32 references in full fp32 (cuDNN's TF32 default would not be)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t_start = time.perf_counter()
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

    results = kernel_phase(torch, mods, path_shapes())
    runs = [serving_phase(torch, mods, card), training_phase(torch, mods, card),
            augmentor_phase(torch, mods, card), prompt_phase(torch, mods, card),
            clip_unet_phase(torch, mods, card), fusion_phase(torch, mods, card)]
    ae, ae_unfused = autoencoder_phase(torch, mods, card)
    runs += [ae, clip_res_phase(torch, mods, card), segment_classifier_phase(torch, mods, card),
             clip_autoencoder_phase(torch, mods, card), clip_res_serving_phase(torch, mods, card),
             robustness_phase(torch, mods, card), data_phase(torch, mods, card),
             distributed_phase(torch, mods, card), export_phase(torch, mods, card),
             profiler_phase(torch, mods, card), *options_phase(torch, mods, card),
             converter_phase(torch, mods, card)]
    tp_phase(torch, mods, card)
    launched = entry_launches({w: sum(run[w] for run in runs) for w in WRAPPER_NAMES}, ae_unfused)

    kernels = []
    for entry, (name, source, replaces) in KERNEL_INFO.items():
        r = results[entry]
        if launched[entry] == 0:
            raise AssertionError(f"{entry} was never launched on the main paths")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launched[entry], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(f"wall time {time.perf_counter() - t_start!r} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
