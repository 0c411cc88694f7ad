"""Profiler spans at the port's layer boundaries.

A span is a ``torch.profiler`` range named ``PREFIX + name``, e.g.
``"imgseg: model.enc3"``.  The session that records the device's
operations records the ranges too, on the same clock, so a trace gives
each span the device time of the operations launched inside it.  The
spans:

- ``train_step`` and ``eval_step`` (``engine/train.py``), with the step
  key as the range's argument, so that one step's spans group in a Chrome
  trace; inside them ``prepare`` (the draws, their copy to the device and
  the augmentor), the block span ``loss`` (training), ``optimizer`` (the
  zero-fill of missing gradients, the gradients' average over ranks and
  Adam) and ``metrics`` (evaluation: the loss, IoU, accuracy and Dice);
- ``augment.geometry`` (flip, quarter turn, shears) and ``augment.colour``
  (jitter and blur, either backend), in both augmentors;
- one block span per U-Net block, stem and output conv, named by the
  block's key prefix in the model's state dict (``model.input``,
  ``model.enc1``, ``model.bottleneck``, ``model.dec5``, ``model.out``,
  ``model.prompt_encoder.enc1``): :func:`name_blocks` names them when the
  registry builds a model, and ``models.fused.block_forward`` and
  ``conv1x1`` open them;
- ``model.clip_tower`` and ``model.resnet34``, the frozen feature
  extractors' forwards.

A block span is a forward range and, where autograd records the block, a
second range ``<name>.bwd`` around the block's backward.  The backward
runs on autograd's device thread, where a range opened by the caller is
not seen, so an identity pair of autograd nodes brackets it: the exit
marker on the block's output opens ``<name>.bwd`` in its backward, the
block's first; the entry marker on the block's differentiable inputs
closes it in its backward, once their gradients are all done.  A block
whose inputs need no gradient (the stem reads the images) closes the span
once its parameters' gradients are done.

With no profiler recording, a span costs one test of the profiler's flag:
no range, no autograd node, no tensor and no launch.  There is no other
switch.  The markers pass tensors and gradients through untouched, so a
step's numbers are the same with the profiler on and off.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional

import torch
from torch import nn
from torch.autograd import profiler as _profiler

PREFIX = "imgseg: "
BACKWARD = ".bwd"
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a profiler is recording: the flag ``torch.profiler`` sets."""
    return _profiler._is_profiler_enabled


def span(name: str, arg: Optional[str] = None):
    """The forward span ``name`` as a context manager; ``arg`` is the
    range's argument in the trace."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(PREFIX + name, arg)


def name_blocks(model: nn.Module, prefix: str = "model") -> nn.Module:
    """Give every submodule of ``model`` its block span's name,
    ``prefix.<key prefix in the state dict>``; returns ``model``."""
    for key, module in model.named_modules():
        if key:
            module.span_name = f"{prefix}.{key}"
    return model


class _Backward:
    """The ``.bwd`` range of one call of a block."""

    __slots__ = ("name", "handle", "hook")

    def __init__(self, name: str):
        self.name, self.handle, self.hook = name, None, None

    def open(self) -> None:
        self.handle = torch.ops.profiler._record_function_enter_new(
            PREFIX + self.name + BACKWARD, None)

    def close(self, *_) -> None:
        if self.hook is not None:
            self.hook.remove()
            self.hook = None
        if self.handle is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(self.handle)
            self.handle = None


class _Exit(torch.autograd.Function):
    """Identity on a block's output; its backward opens the block's
    ``.bwd`` range."""

    @staticmethod
    def forward(ctx, bwd: _Backward, out: torch.Tensor) -> torch.Tensor:
        ctx.bwd = bwd
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        ctx.bwd.open()
        return None, grad


class _Entry(torch.autograd.Function):
    """Identity on a block's differentiable inputs; its backward closes
    the block's ``.bwd`` range."""

    @staticmethod
    def forward(ctx, bwd: _Backward, *inputs: torch.Tensor):
        ctx.bwd = bwd
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in inputs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.bwd.close()
        return (None, *grads)


def _differentiable(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.requires_grad


def _enter(bwd: _Backward, inputs: tuple) -> tuple:
    """``inputs`` with every tensor that requires grad, also inside a
    tuple, passed through one entry marker; unchanged where none does."""
    out = [list(x) if isinstance(x, tuple) else x for x in inputs]
    slots = [(out, i) for i, x in enumerate(out) if _differentiable(x)]
    slots += [(x, j) for x in out if isinstance(x, list)
              for j, t in enumerate(x) if _differentiable(t)]
    if not slots:
        return inputs
    for (seq, k), t in zip(slots, _Entry.apply(bwd, *(seq[k] for seq, k in slots))):
        seq[k] = t
    return tuple(tuple(x) if isinstance(x, list) else x for x in out)


def block(name: Optional[str], fn: Callable, *inputs, params=(), **kwargs):
    """``fn(*inputs, **kwargs)`` inside the block span ``name`` (none where
    ``name`` is None): a forward range and, where autograd records, the
    ``.bwd`` range of its backward.  ``params``: the block's parameters,
    whose gradients close the backward range of a block whose inputs need
    no gradient."""
    if name is None or not _profiler._is_profiler_enabled:
        return fn(*inputs, **kwargs)
    with torch.profiler.record_function(PREFIX + name):
        if not torch.is_grad_enabled():
            return fn(*inputs, **kwargs)
        bwd = _Backward(name)
        marked = _enter(bwd, inputs)
        out = fn(*marked, **kwargs)
        if not _differentiable(out):
            return out
        if marked is inputs:
            weights = [p for p in params if p.requires_grad]
            if not weights:
                return out
            bwd.hook = torch.autograd.graph.register_multi_grad_hook(weights, bwd.close)
        return _Exit.apply(bwd, out)


def module_block(module: nn.Module, fn: Callable, *inputs, **kwargs):
    """:func:`block` named by ``module``'s :func:`name_blocks` name, its
    parameters closing the backward range where needed."""
    if not _profiler._is_profiler_enabled:
        return fn(*inputs, **kwargs)
    return block(getattr(module, "span_name", None), fn, *inputs,
                 params=module.parameters(), **kwargs)
