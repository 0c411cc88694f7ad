"""Operations and bytes computed from a configuration's shapes, and the
chip's peaks: the arithmetic behind the benchmark's utilisation and
roofline metrics.

Peaks: NVIDIA's data sheet for one H100 SXM, dense, at its full 700 W
power limit: 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM.  A
card set below 700 W runs slower under load; every run prints the card's
``power.limit`` beside these shares.

A layer's forward costs 2 * pixels * cin * cout * taps FLOPs (a
ConvTranspose 2x2/2 counts its input pixels, four taps each); a training
step adds the weight gradient of every layer and the input gradient of a
layer whose input needs one, each as much again.

A 3x3 conv on the hand-written kernels is bounded per launch by
max(FLOPs / peak, bytes / bandwidth), each input byte counted once and
each output byte once: activations in bf16, weights read in bf16 and the
weight gradient written in fp32, the per-channel vectors in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
ACT, VEC, WGRAD = 2, 4, 4   # bytes per activation, per-channel vector, weight-gradient element


@dataclasses.dataclass(frozen=True)
class Layer:
    """One product of a forward: ``pixels`` output pixels of a conv (input
    pixels of a ConvTranspose), ``taps`` kernel taps.  ``input_grad``: a
    training step takes the gradient of its input; ``x_b``: channels of cin
    that come as a second operand (a decoder's skip); ``pre``: the input is
    the previous conv's raw output, taken through its BatchNorm and ReLU on
    load; ``kernel``: the program runs this 3x3 conv on its hand-written
    kernels."""

    name: str
    pixels: int
    cin: int
    cout: int
    taps: int
    input_grad: bool = True
    kernel: bool = False
    x_b: int = 0
    pre: bool = False

    @property
    def forward_flops(self) -> float:
        return 2.0 * self.pixels * self.cin * self.cout * self.taps


def model_flops(layers: Iterable[Layer], train: bool) -> float:
    """FLOPs of one forward, or of one training step (forward, weight and
    input gradients)."""
    total = 0.0
    for layer in layers:
        f = layer.forward_flops
        total += f
        if train:
            total += f * (1 + int(layer.input_grad))
    return total


def conv3x3_forms(layer: Layer, train: bool) -> List[str]:
    if not train:
        return ["eval"]
    return ["stats"] + (["dgrad"] if layer.input_grad else []) + ["wgrad"]


def conv3x3_bytes(layer: Layer, form: str) -> float:
    """Bytes a 3x3 kernel conv of ``form`` must read and write at least."""
    px, cin, co = layer.pixels, layer.cin, layer.cout
    ca = cin - layer.x_b
    weights = co * cin * 9 * ACT
    pre = 2 * ca * VEC if layer.pre else 0
    if form in ("eval", "stats"):
        stats = 2 * co * VEC if form == "stats" else 0
        return px * cin * ACT + weights + co * VEC + pre + px * co * ACT + stats
    if form == "dgrad":
        post = px * ca * ACT + 2 * ca * VEC * 2 if layer.pre else 0
        return 2 * px * co * ACT + weights + 2 * co * VEC + post + px * cin * ACT
    if form == "wgrad":
        return 2 * px * co * ACT + px * cin * ACT + 2 * co * VEC + pre + co * cin * 9 * WGRAD \
            + co * VEC
    raise ValueError(f"unknown form {form!r}")


def conv3x3_bound_s(layers: Iterable[Layer], train: bool) -> float:
    """The least device time of one step's (or forward's) kernel 3x3 convs:
    each launch's max(FLOPs / peak, bytes / bandwidth), summed."""
    total = 0.0
    for layer in layers:
        if not layer.kernel:
            continue
        for form in conv3x3_forms(layer, train):
            total += max(layer.forward_flops / BF16_FLOP_PER_S,
                         conv3x3_bytes(layer, form) / HBM_BYTES_PER_S)
    return total
