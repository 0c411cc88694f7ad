"""Plain float32 reference of the ``large_unet`` configuration: the
LargeUNet of the reference repository (``models/UNet.py:78-148``) trained
with cross-entropy on class-id masks, after the augmentation of its
training script.

NHWC in and out; NCHW inside.  The architecture comes from the
configuration's ``architecture`` block: a 1x1 stem, one down block per
encoder width (ConvBlock then 2x2 max-pool), a ConvBlock bottleneck of
twice the last width, one up block per encoder width reversed and one for
the stem (ConvTranspose 2x2/2, bilinear resize to the skip, concat [up |
skip], ConvBlock), and a 1x1 output conv.  Decoder i reads skip -i of
[stem, enc1, ...]: the encoders' outputs are after their pools, so the
first decoder's skip has the bottleneck's size and its up-conv is resized
back down.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .. import plain as P
from ..flops import Layer

def widths(arch: dict):
    enc = list(arch["encoders"])
    return arch["stem"], enc, 2 * enc[-1], enc[::-1] + [arch["stem"]]


def spec(arch: dict) -> P.Spec:
    stem, enc, bott, decs = widths(arch)
    s = P.conv_spec("input", 3, stem, 1)
    cin = stem
    for i, c in enumerate(enc, 1):
        s += P.block_spec(f"enc{i}.block.0", cin, c)
        cin = c
    s += P.block_spec("bottleneck", cin, bott)
    cin = bott
    for i, c in enumerate(decs, 1):
        s += P.convt_spec(f"dec{i}.up", cin, c) + P.block_spec(f"dec{i}.conv", 2 * c, c)
        cin = c
    return s + P.conv_spec("out", stem, arch["out_channels"], 1)


def forward(p: Dict[str, torch.Tensor], inputs, arch: dict, q: P.Precision = P.FP32,
            train: bool = True, stats=None, checkpoint: bool = False) -> torch.Tensor:
    """(images (n, h, w, 3) in [0, 1],) -> logits (n, h, w, classes)."""
    (images,) = inputs
    _, enc, _, decs = widths(arch)
    x = P.conv(p, "input", images.permute(0, 3, 1, 2), q)
    skips = [x]
    for i in range(1, len(enc) + 1):
        x = P.maybe_checkpoint(lambda t, i=i: P.down_block(p, f"enc{i}", t, q, train, stats), x,
                               enabled=checkpoint)
        skips.append(x)
    x = P.maybe_checkpoint(lambda t: P.conv_block(p, "bottleneck", t, q, train, stats), x,
                           enabled=checkpoint)
    for i in range(1, len(decs) + 1):
        x = P.maybe_checkpoint(
            lambda t, s, i=i: P.up_skip_block(p, f"dec{i}", t, s, q, train, stats), x, skips[-i],
            enabled=checkpoint)
    return P.conv(p, "out", x, q).permute(0, 2, 3, 1)


def prepare(images_u8, masks_u8, seed: int, step_key: int, cfg: dict, q: P.Precision = P.FP32):
    """The step's model inputs and targets: the augmentation draws of
    ``(seed, step_key)`` applied to the batch."""
    n = images_u8.shape[0]
    draws = P.sample_augment(n, P.step_generator(seed, step_key))
    every = cfg["augmentations_per_datapoint"] + 1
    images, masks = P.augment(images_u8, masks_u8, draws, every)
    return (q(images),), masks


def loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return P.cross_entropy(logits.permute(0, 3, 1, 2), targets)


def kernel_leaves(arch: dict, kernel_levels) -> List[str]:
    """The weights whose gradient the program's hand-written wgrad makes:
    both 3x3 convs of the encoder's and the decoder's ConvBlock at each of
    ``kernel_levels``."""
    _, _, _, decs = widths(arch)
    out = []
    for lvl in sorted(kernel_levels):
        for block in (f"enc{lvl + 1}.block.0", f"dec{len(decs) - lvl}.conv"):
            out += [f"{block}.conv.0.weight", f"{block}.conv.3.weight"]
    return out


def layers(arch: dict, kernel_levels, b: int, size: int) -> List[Layer]:
    """Every product of one forward at batch b: (name, pixels, cin,
    cout, taps, input_grad, kernel, x_b, pre).  ``kernel_levels``:
    the levels whose 3x3 convs run on the program's hand-written kernels."""
    stem, enc, bott, decs = widths(arch)
    out: List[Layer] = [Layer("input", b * size * size, 3, stem, 1, input_grad=False)]
    cin, side = stem, size
    for i, c in enumerate(enc, 1):
        lvl = i - 1
        k = lvl in kernel_levels
        out += [Layer(f"enc{i}.conv1", b * side * side, cin, c, 9, kernel=k),
                Layer(f"enc{i}.conv2", b * side * side, c, c, 9, kernel=k,
                      pre=True)]
        cin, side = c, side // 2
    out += [Layer("bottleneck.conv1", b * side * side, cin, bott, 9),
            Layer("bottleneck.conv2", b * side * side, bott, bott, 9)]
    cin = bott
    for i, c in enumerate(decs, 1):
        lvl = len(decs) - i
        up_side = side if i == 1 else side * 2
        k = lvl in kernel_levels
        out += [Layer(f"dec{i}.up", b * side * side, cin, c, 4),
                Layer(f"dec{i}.conv1", b * up_side * up_side, 2 * c, c, 9,
                      kernel=k, x_b=c),
                Layer(f"dec{i}.conv2", b * up_side * up_side, c, c, 9,
                      kernel=k, pre=True)]
        cin, side = c, up_side
    out.append(Layer("out", b * size * size, stem, arch["out_channels"], 1))
    return out
