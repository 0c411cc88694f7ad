"""Training checkpoints in the JAX package's flat ``.npz`` layout, both
ways; counterpart of ``image_segmentation_tpu/utils/checkpoint.py``
(save_checkpoint :45, load_checkpoint_flat :57, restore_into :63,
latest_checkpoint :89).

A checkpoint holds the JAX Trainer's state (``engine/train.py:213-218``)
flattened under ``/``-joined keys (``_flatten`` :27): ``params/...``,
``batch_stats/...``, ``opt_state/...`` and ``step``, so a file written by
either package restores in the other.  The model's tensors go through
``utils/convert.py``.  Adam's state maps as follows:

- optax ``scale_by_adam``'s ``mu`` / ``nu`` / ``count`` are torch Adam's
  ``exp_avg`` / ``exp_avg_sq`` / ``step``, each moment in the layout of
  its parameter (the same conversion as the weights);
- the chain's ``add_decayed_weights`` and ``scale`` slots (0 and 2) hold
  nothing, so the Adam slot is ``opt_state/1/...``;
- a model with frozen parts (the CLIP tower, the ClipRes ResNet-34) gets
  JAX's ``multi_transform`` nesting, ``opt_state/inner_states/train/
  inner_state/1/...``, whose moments cover the trainable parameters only
  (``engine/train.py:62-81``; the frozen ``set_to_zero`` holds nothing).

tests/test_torch_port_artifacts.py holds the key set to a JAX Trainer's.
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from . import convert

Tree = Dict[str, Any]
ADAM_SLOT = "1"  # optax.chain(add_decayed_weights, scale_by_adam, scale)
FROZEN_NEST = ("inner_states", "train", "inner_state")


def save_checkpoint(path: str, tree: Mapping[str, Any]) -> None:
    """Save nested dicts of arrays to ``path`` (.npz, ``/``-joined keys):
    written to ``path + ".tmp"``, then renamed over ``path``."""
    convert.write_flat_npz(path, tree)


def load_checkpoint_flat(path: str) -> Dict[str, np.ndarray]:
    """The flat ``{key: array}`` dict of a checkpoint file."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def restore_into(template: Mapping[str, Any], path: str) -> Tree:
    """A checkpoint in the structure of ``template`` (nested dicts of
    arrays): arrays matched by flattened key, cast to the template's
    dtype.  A key of the template missing from the file raises
    ``KeyError``; a shape that differs raises ``ValueError``."""
    flat = load_checkpoint_flat(path)

    def fill(node, prefix):
        out = {}
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, Mapping):
                out[k] = fill(v, key)
                continue
            if key not in flat:
                raise KeyError(f"checkpoint {path} missing key {key!r}")
            arr = flat[key]
            if tuple(arr.shape) != tuple(np.shape(v)):
                raise ValueError(f"shape mismatch for {key!r}: checkpoint {arr.shape} vs "
                                 f"template {np.shape(v)}")
            out[k] = arr.astype(np.asarray(v).dtype)
        return out

    return fill(template, "")


def latest_checkpoint(run_dir: str, prefix: str = "model_") -> Optional[str]:
    """The newest ``model_<epoch>.npz`` in a run folder, or None."""
    if not os.path.isdir(run_dir):
        return None
    best, best_epoch = None, -1
    pat = re.compile(re.escape(prefix) + r"(\d+)\.npz$")
    for name in os.listdir(run_dir):
        m = pat.match(name)
        if m and int(m.group(1)) > best_epoch:
            best, best_epoch = os.path.join(run_dir, name), int(m.group(1))
    return best


# ---- the Trainer's state <-> the JAX state tree ----------------------------

def _adam_slot(opt_state: Mapping[str, Any], frozen: bool) -> Mapping[str, Any]:
    node = opt_state
    for k in (FROZEN_NEST if frozen else ()) + (ADAM_SLOT,):
        node = node[k]
    return node


Values = Callable[[Mapping[str, torch.Tensor]], Mapping[str, torch.Tensor]]


def state_tree(model: nn.Module, optimizer: torch.optim.Optimizer, step: int,
               frozen: bool, whole: Optional[Values] = None) -> Tree:
    """The JAX Trainer state of ``model`` and its Adam ``optimizer`` after
    ``step`` steps, as nested numpy dicts; ``frozen``: the model has frozen
    parts (JAX's ``multi_transform`` nesting).  A parameter without Adam
    state yet (before the first step) has zero moments, as optax's
    ``init``.  ``whole`` maps the state dict, and each moment keyed like
    it, to the whole tensors (a tensor-parallel model's,
    ``parallel.tensor.full_state``)."""
    whole = whole or (lambda values: values)
    params, batch_stats = convert.jax_from_state_dict(whole(model.state_dict()))
    names = {p: n for n, p in model.named_parameters()}
    moments = {"exp_avg": {}, "exp_avg_sq": {}}
    count = 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            for m in moments:
                moments[m][names[p]] = st.get(m, torch.zeros_like(p))
            if "step" in st:
                count = int(st["step"])
    adam = {"count": np.asarray(count, np.int32),
            "mu": convert.jax_from_state_dict(whole(moments["exp_avg"]))[0],
            "nu": convert.jax_from_state_dict(whole(moments["exp_avg_sq"]))[0]}
    opt_state: Tree = {ADAM_SLOT: adam}
    for k in reversed(FROZEN_NEST if frozen else ()):
        opt_state = {k: opt_state}
    return {"params": params, "batch_stats": batch_stats, "opt_state": opt_state,
            "step": np.asarray(step, np.int32)}


def load_state_tree(tree: Mapping[str, Any], model: nn.Module,
                    optimizer: torch.optim.Optimizer, frozen: bool,
                    local: Optional[Values] = None) -> int:
    """Load a JAX Trainer state (``state_tree``'s layout) into ``model``
    (strictly) and its Adam ``optimizer``; returns the step.  ``local``
    maps whole tensors keyed like the state dict to this rank's parts (a
    tensor-parallel model's, ``parallel.tensor.local_state``)."""
    local = local or (lambda values: values)
    sd = local(convert.state_dict_from_jax(tree["params"], tree.get("batch_stats", {})))
    model.load_state_dict(sd, strict=True)
    adam = _adam_slot(tree["opt_state"], frozen)
    mu = local(convert.state_dict_from_jax(adam["mu"], {}))
    nu = local(convert.state_dict_from_jax(adam["nu"], {}))
    count = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    names = {p: n for n, p in model.named_parameters()}
    opt = optimizer.state_dict()
    index = 0
    state = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            state[index] = {"step": count.clone(), "exp_avg": mu[names[p]],
                            "exp_avg_sq": nu[names[p]]}
            index += 1
    opt["state"] = state
    optimizer.load_state_dict(opt)  # casts the moments to each parameter's device
    return int(np.asarray(tree["step"]))

