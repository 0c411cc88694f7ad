"""The FLOP and byte counts behind ``mfu.*`` and ``conv3x3_roofline.*``,
against totals worked out by hand and against the kernel table's bounds."""

from __future__ import annotations

import pytest

from benchmark import flops as F
from benchmark import harness as H
from benchmark import trace as T
from benchmark.reference import large_unet
from benchmark.plain import trainable_names

LARGE = {"stem": 32, "encoders": [64, 128, 256, 512], "out_channels": 3}


def hand_large_unet_macs(size: int = 256) -> int:
    """LargeUNet's multiply-adds for one image, layer by layer."""
    px = [(size >> i) ** 2 for i in range(5)]   # 256², 128², 64², 32², 16²
    macs = px[0] * 3 * 32                       # the 1x1 stem
    enc = [(32, 64), (64, 128), (128, 256), (256, 512)]
    for lvl, (ci, co) in enumerate(enc):
        macs += px[lvl] * 9 * (ci * co + co * co)
    macs += px[4] * 9 * (512 * 1024 + 1024 * 1024)   # the bottleneck at 16²
    # decoders: up-conv from the previous map (4 taps per input pixel), then
    # [up | skip] -> co and co -> co at the skip's size
    ups = [(1024, 512, px[4], px[4]), (512, 256, px[4], px[3]), (256, 128, px[3], px[2]),
           (128, 64, px[2], px[1]), (64, 32, px[1], px[0])]
    for ci, co, in_px, out_px in ups:
        macs += in_px * 4 * ci * co + out_px * 9 * (2 * co * co + co * co)
    return macs + px[0] * 32 * 3                 # the 1x1 output conv


def test_large_unet_forward_is_28_25_gmac():
    layers = large_unet.layers(LARGE, {0, 1}, 1, 256)
    assert F.model_flops(layers, train=False) == 2 * hand_large_unet_macs()
    assert hand_large_unet_macs() / 1e9 == pytest.approx(28.265, abs=5e-4)


def test_training_step_adds_both_gradients():
    """Forward, weight gradient and input gradient of every layer, but no
    input gradient for the stem, which reads the image."""
    layers = large_unet.layers(LARGE, {0, 1}, 1, 256)
    fwd = F.model_flops(layers, train=False)
    stem = layers[0].forward_flops
    assert F.model_flops(layers, train=True) == pytest.approx(3 * fwd - stem)


def test_conv3x3_bounds_match_the_kernel_table():
    """At batch 16, 512x512 (the kernel table's shapes) the 8 level 0-1
    convs are bounded by 1.667 ms a forward (eval or stats form), 2.525 ms
    of dgrads and 2.236 ms of wgrads."""
    layers = [x for x in large_unet.layers(LARGE, {0, 1}, 16, 512) if x.kernel]
    assert len(layers) == 8

    def bound(form):
        return 1e3 * sum(max(x.forward_flops / F.BF16_FLOP_PER_S,
                             F.conv3x3_bytes(x, form) / F.HBM_BYTES_PER_S) for x in layers)

    assert bound("eval") == pytest.approx(1.667, abs=1e-3)
    assert bound("stats") == pytest.approx(1.667, abs=1e-3)
    assert bound("dgrad") == pytest.approx(2.525, abs=2e-3)
    assert bound("wgrad") == pytest.approx(2.236, abs=2e-3)
    assert F.conv3x3_bound_s(large_unet.layers(LARGE, {0, 1}, 16, 512), train=False) * 1e3 \
        == pytest.approx(bound("eval"))


def test_the_kernels_weights_are_the_kernel_convs():
    """``kernel_leaves`` names the weights of the 3x3 convs that ``layers``
    puts on the kernels: the ConvBlocks of enc1, enc2, dec4, dec5."""
    leaves = large_unet.kernel_leaves(LARGE, {0, 1})
    assert set(leaves) <= set(trainable_names(large_unet.spec(LARGE)))
    assert sorted(leaves) == sorted(
        f"{b}.conv.{i}.weight" for b in ("enc1.block.0", "enc2.block.0", "dec4.conv", "dec5.conv")
        for i in (0, 3))
    assert len([x for x in large_unet.layers(LARGE, {0, 1}, 1, 256) if x.kernel]) == len(leaves)


def test_the_roofline_counts_whole_kernel_names():
    """``vec_kernel`` is not ``pool_bwd_narrow_kernel``'s ``narrow_kernel``;
    the sums' second pass counts after a conv kernel only."""
    ops = [("void (anonymous namespace)::vec_kernel<0, 1, 64>(Args)", 0.0, 1.0),
           ("void imgseg::(anonymous namespace)::sum_rows_kernel<2>(float const*)", 1.0, 0.5),
           ("void (anonymous namespace)::pool_bwd_narrow_kernel<8>(float*)", 2.0, 4.0),
           ("void (anonymous namespace)::ct_bwd_kernel<2, 4>(BwdArgs)", 6.0, 8.0),
           ("void imgseg::(anonymous namespace)::sum_rows_kernel<2>(float const*)", 14.0, 16.0),
           ("void (anonymous namespace)::wgrad_vec_kernel<32>(Args)", 30.0, 32.0),
           ("void imgseg::(anonymous namespace)::sum_rows_kernel<1>(float const*)", 62.0, 64.0)]
    trace = T.Trace(1, 200.0, ops, {}, {})
    roofline = H.load_module(H.metric_file(H.BENCH, "conv3x3_roofline.train"), "roofline")
    assert trace.kernel_seconds(roofline.KERNELS, roofline.SECOND_PASS) == 1 + 0.5 + 32 + 64
    assert T.kernel_name(ops[2][0]) == "pool_bwd_narrow_kernel"
    assert T.group(ops[0][0]) == "conv3x3 (forward)"
    assert T.group(ops[2][0]) == "maxpool2x2_affine_relu_bwd (narrow)"
