"""JAX parameter trees <-> the port's state dicts, and the flat-npz artifact.

Counterpart of the U-Net parts of ``image_segmentation_tpu/utils/
torch_export.py`` (``unet_state_dict`` :143, JAX -> torch) and
``utils/torch_convert.py`` (block helpers :53-104, torch -> JAX), and of
``utils/checkpoint.py``'s flat ``.npz`` format (:27-60) for the inference
artifact.  Ported rather than imported, so the port and ``chip_smoke.py``
load nothing of the JAX package; tests/test_torch_port_slice.py holds both
directions to those modules.

The port's modules use the reference torch key layout (``input``,
``enc{i}.block.0.conv.{0,1,3,4}``, ``bottleneck.conv.*``, ``dec{i}.up``,
``dec{i}.conv.conv.*``, ``out``), so a JAX tree loads with
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]

# A ConvBlock's layers (JAX names) <-> the reference nn.Sequential indices.
_LAYER = {"conv1": "0", "bn1": "1", "conv2": "3", "bn2": "4"}
_LAYER_INV = {v: k for k, v in _LAYER.items()}
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def read_flat_npz(path: str) -> Dict[str, Tree]:
    """Read a JAX flat ``.npz`` (keys ``params/...``, ``batch_stats/...``)
    into nested dicts of numpy arrays."""
    tree: Tree = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def write_flat_npz(path: str, tree: Mapping[str, Any]) -> None:
    """Write nested dicts of arrays as the JAX flat ``.npz`` (``/``-joined
    keys), atomically like ``checkpoint.save_checkpoint``."""
    flat = {"/".join(p): np.asarray(v) for p, v in _leaves(tree)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def _leaves(node: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in node.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_key(path: Tuple[str, ...]) -> str:
    """JAX leaf path (below ``params``/``batch_stats``) -> torch key."""
    top, *mid, leaf = path
    if mid[:1] == ["conv_block"]:  # enc{i} / dec{i}: the block's ConvBlock
        mid = ["block.0.conv" if top.startswith("enc") else "conv.conv", _LAYER[mid[1]]]
    elif top == "bottleneck":
        mid = ["conv", _LAYER[mid[0]]]
    return ".".join([top, *mid, _LEAF[leaf]])


def _jax_path(key: str) -> Tuple[str, List[str]]:
    """Torch key -> (collection, JAX leaf path); inverse of ``_torch_key``."""
    top, *mid, leaf = key.split(".")
    path = [top]
    if mid and mid != ["up"]:  # <block>.conv.{0,1,3,4}
        path += ([] if top == "bottleneck" else ["conv_block"]) + [_LAYER_INV[mid[-1]]]
    else:
        path += mid
    if leaf == "weight":
        leaf = "scale" if path[-1].startswith("bn") else "kernel"
    else:
        leaf = {"running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
    return ("batch_stats" if leaf in ("mean", "var") else "params"), path + [leaf]


def state_dict_from_jax(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any]
) -> Dict[str, torch.Tensor]:
    """JAX UNet/LargeUNet ``params``/``batch_stats`` -> the port's strict
    state dict (fp32 CPU tensors).  Kernels go from flax ``(kH, kW, I, O)``
    to torch ``(O, I, kH, kW)``; ConvTranspose kernels to ``(I, O, kH, kW)``
    with flax's spatial flip undone (torch_export.py:45-48)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, v in [*_leaves(params), *_leaves(batch_stats)]:
        t = torch.from_numpy(np.array(v, dtype=np.float32))
        if path[-1] == "kernel":
            t = t.permute(2, 3, 0, 1).flip(2, 3) if "up" in path else t.permute(3, 2, 0, 1)
        sd[_torch_key(path)] = t.contiguous()
    for key in [k for k in sd if k.endswith(".running_mean")]:
        # torch counts batches; eval never reads it.
        sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return sd


def jax_from_state_dict(
    state_dict: Mapping[str, torch.Tensor]
) -> Tuple[Tree, Tree]:
    """The port's UNet/LargeUNet state dict -> JAX ``(params, batch_stats)``
    as nested numpy dicts (fp32), the tree ``models/unet.py`` declares."""
    trees: Dict[str, Tree] = {"params": {}, "batch_stats": {}}
    for key, v in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        coll, path = _jax_path(key)
        t = v.detach().to("cpu", torch.float32)
        if path[-1] == "kernel":
            t = t.flip(2, 3).permute(2, 3, 0, 1) if "up" in path else t.permute(2, 3, 1, 0)
        node = trees[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(t.numpy())
    return trees["params"], trees["batch_stats"]
