"""The port's profiler spans (``image_segmentation_tpu_torch/utils/spans.py``)
on the CPU: the spans a train and an eval step record under
``torch.profiler`` at a small LargeUNet and ClipUnetPrompt size, their
names, order and closing, and that with the profiler off they leave no
range, autograd node or hook behind and the steps are bit for bit the
same either way."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from image_segmentation_tpu_torch.config import preset
from image_segmentation_tpu_torch.data.datasets import CAT_PALETTE, DOG_PALETTE
from image_segmentation_tpu_torch.engine.train import Trainer
from image_segmentation_tpu_torch.utils import spans

SIZE = 32
BATCH = 4
SMALL_UNET = dict(stem_features=8, encoder_features=(8, 16, 16, 16))
SMALL_TOWER = dict(hidden=32, layers=1, heads=2, mlp_dim=64, patch=32, proj_dim=32)
LARGE_UNET_BLOCKS = ["input", "enc1", "enc2", "enc3", "enc4", "bottleneck",
                     "dec1", "dec2", "dec3", "dec4", "dec5", "out"]
# ClipUnetPrompt: the image encoder, the prompt encoder, the decoders; the
# bottleneck's output is not read by the one-token fusion, so its block
# has no backward
PROMPT_BLOCKS = ["input", "enc1", "enc2", "enc3", "bottleneck", "prompt_encoder.enc1",
                 "prompt_encoder.enc2", "prompt_encoder.enc3", "prompt_encoder.conv",
                 "dec1", "dec2", "dec3", "dec4", "out"]
PROMPT_NO_BACKWARD = {"bottleneck"}
MARKERS = ("_ExitBackward", "_EntryBackward")


def _config(name: str, **extra):
    if name == "large_unet":
        cfg = preset("large_unet")
        args = dict(cfg.model_args, **SMALL_UNET)
    else:
        cfg = preset("prompt")
        args = dict(cfg.model_args, clip_kwargs=SMALL_TOWER)
    return dataclasses.replace(
        cfg, model_args=args, batch_size=BATCH, bf16=False, seed=3, **extra,
        data=dataclasses.replace(cfg.data, dataset="synthetic", synthetic_length=BATCH,
                                 image_size=SIZE))


def _batch(name: str, seed: int):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    if name == "large_unet":
        masks = rng.integers(0, 3, (BATCH, SIZE, SIZE), dtype=np.uint8)
    else:
        masks = rng.choice(np.array([0, CAT_PALETTE, DOG_PALETTE, 255], np.uint8),
                           (BATCH, SIZE, SIZE))
    return torch.from_numpy(images), torch.from_numpy(masks)


def _recorded(fn):
    """The program's spans that ``fn()`` records: (name without the
    prefix, start, end), in the order they open."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name[len(spans.PREFIX):], e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith(spans.PREFIX)),
                  key=lambda r: r[1])


def _names(recorded):
    return [n for n, _, _ in recorded]


@pytest.fixture(scope="module", params=["large_unet", "prompt"])
def trainer(request):
    t = Trainer(_config(request.param), device="cpu", make_artifacts=False)
    t.train_step(*_batch(request.param, 0), 0)
    return request.param, t


def test_a_train_step_records_every_block_forward_and_backward(trainer):
    name, t = trainer
    rec = _recorded(lambda: t.train_step(*_batch(name, 1), 7))
    names = _names(rec)
    blocks = LARGE_UNET_BLOCKS if name == "large_unet" else PROMPT_BLOCKS
    without = set() if name == "large_unet" else PROMPT_NO_BACKWARD
    for b in blocks:
        assert names.count("model." + b) == 1, (b, names)
        assert names.count(f"model.{b}.bwd") == (b not in without), (b, names)
    assert sorted(n for n in names if n.startswith("model.") and not n.endswith(".bwd")) == \
        sorted(["model." + b for b in blocks] + (["model.clip_tower"] if name == "prompt" else []))
    for phase in ("train_step", "prepare", "augment.geometry", "augment.colour", "loss",
                  "loss.bwd", "optimizer"):
        assert names.count(phase) == 1, (phase, names)


def test_block_backward_spans_are_disjoint_in_reverse_order_and_closed(trainer):
    """Each block's ``.bwd`` span lies after ``loss.bwd`` and before
    ``optimizer``, none overlaps another, and the main path's blocks close
    in the reverse of their forward order, the stem (whose input, the
    images, needs no gradient) last."""
    name, t = trainer
    rec = _recorded(lambda: t.train_step(*_batch(name, 2), 8))
    at = {n: (a, b) for n, a, b in rec}
    bwd = sorted((a, b, n[:-len(".bwd")]) for n, a, b in rec
                 if n.startswith("model.") and n.endswith(".bwd"))
    for (_, end, _), (start, _, _) in zip(bwd, bwd[1:]):
        assert end <= start, bwd
    assert at["loss.bwd"][1] <= bwd[0][0] and bwd[-1][1] <= at["optimizer"][0]
    order = [n for _, _, n in bwd]
    if name == "large_unet":
        assert order == ["model." + b for b in reversed(LARGE_UNET_BLOCKS)]
    else:
        main = [n for n in order if not n.startswith("model.prompt_encoder.")]
        fwd = [n for n in _names(rec) if n.startswith("model.") and not n.endswith(".bwd")
               and not n.startswith("model.prompt_encoder.") and n + ".bwd" in at]
        assert main == fwd[::-1]
    assert order[-1] == "model.input"


def test_an_eval_step_records_its_phases_and_forward_blocks(trainer):
    name, t = trainer
    rec = _recorded(lambda: t.eval_step(*_batch(name, 3)))
    names = _names(rec)
    blocks = LARGE_UNET_BLOCKS if name == "large_unet" else PROMPT_BLOCKS
    for b in blocks:
        assert names.count("model." + b) == 1, (b, names)
    assert not [n for n in names if n.endswith(".bwd")]
    for phase in ("eval_step", "prepare", "metrics"):
        assert names.count(phase) == 1, (phase, names)
    assert "loss" not in names and "optimizer" not in names


def _graph_nodes(out: torch.Tensor):
    seen, todo = set(), [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo += [n for n, _ in node.next_functions]
    return [type(n).__name__ for n in seen]


def test_with_the_profiler_off_a_train_forward_holds_no_marker(monkeypatch):
    t = Trainer(_config("large_unet"), device="cpu", make_artifacts=False)
    inputs, _ = t._prepare_batch(*_batch("large_unet", 4), augment=False)
    with profile(activities=[ProfilerActivity.CPU]):
        on = t.model(inputs, train=True)
    assert set(MARKERS) <= set(_graph_nodes(on))

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was opened with the profiler off")

    # torch.optim opens its own range whatever the profiler: only the
    # spans' entry points are refused
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.graph, "register_multi_grad_hook", refuse)
    assert not spans.recording()
    off = t.model(inputs, train=True)
    assert not set(MARKERS) & set(_graph_nodes(off))
    off.sum().backward()
    images, masks = _batch("large_unet", 5)
    t.train_step(images, masks, 9)
    t.eval_step(images, masks)
    assert all(not p._backward_hooks for p in t.model.parameters())


def _two_steps(name: str, profiled: bool, **extra):
    t = Trainer(_config(name, **extra), device="cpu", make_artifacts=False)
    losses = []
    for i in range(2):
        step = lambda i=i: losses.append(t.train_step(*_batch(name, 10 + i), 20 + i))  # noqa: E731
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                step()
        else:
            step()
    state = {k: v.clone() for k, v in t.model.state_dict().items()}
    grads = {k: p.grad.clone() for k, p in t.model.named_parameters() if p.grad is not None}
    adam = [v.clone() for s in t.optimizer.state.values() for v in s.values()]
    return losses, grads, state, adam


@pytest.mark.parametrize("name, extra", [("large_unet", {}), ("large_unet", {"remat": True}),
                                         ("prompt", {})])
def test_steps_are_bit_identical_with_the_profiler_on_and_off(name, extra):
    on, off = _two_steps(name, True, **extra), _two_steps(name, False, **extra)
    for a, b in zip(on[0], off[0]):
        assert torch.equal(a, b)
    for got, want in zip(on[1:3], off[1:3]):
        assert got.keys() == want.keys() and got
        for k in got:
            assert torch.equal(got[k], want[k]), k
    assert len(on[3]) == len(off[3]) and all(torch.equal(a, b) for a, b in zip(on[3], off[3]))


def test_a_block_span_marks_tensors_in_tuples_and_closes_without_input_gradients():
    """``spans.block`` over a tuple input passes gradients through
    untouched; a block whose inputs need no gradient closes its ``.bwd``
    span once its parameters' gradients are done, and one without
    parameters records no ``.bwd``."""
    w = torch.nn.Parameter(torch.randn(3))
    a, b = torch.randn(3, requires_grad=True), torch.randn(3, requires_grad=True)

    def run():
        y = spans.block("toy", lambda pair, s: (pair[0] * pair[1] * w).sum() * s, (a, b), 2.0)
        z = spans.block("stem", lambda x: x * w, torch.ones(3), params=[w])
        c = spans.block("constant", lambda x: x * 2, torch.ones(3))
        (y + z.sum() + c.sum()).backward()

    run()
    plain = [t.grad.clone() for t in (w, a, b)]
    for t in (w, a, b):
        t.grad = None
    rec = _recorded(run)
    assert all(torch.equal(t.grad, g) for t, g in zip((w, a, b), plain))
    assert sorted(_names(rec)) == ["constant", "stem", "stem.bwd", "toy", "toy.bwd"]
    assert not w._backward_hooks
