"""JAX parameter trees <-> the port's state dicts, and the flat-npz artifact.

Counterpart of ``image_segmentation_tpu/utils/torch_export.py`` (JAX ->
torch: ``unet_state_dict`` :143, ``clip_tower_to_torch`` :163,
``clip_unet_state_dict`` :196, ``resnet34_children_to_torch`` :213,
``clip_res_state_dict`` :240, ``clip_autoencoder_state_dict`` :257,
``clip_unet_prompt_state_dict`` :272), of ``utils/torch_convert.py``
(block helpers :53-104, ``strip_compile_prefix`` :76, torch -> JAX),
``models/clip.py`` (``clip_params_from_torch`` :157) and
``models/resnet.py`` (``resnet34_params_from_torch`` :107), and of
``utils/checkpoint.py``'s flat ``.npz`` format (:27-60) for the inference
artifact.  Ported rather than imported, so the port and ``chip_smoke.py``
load nothing of the JAX package; tests/test_torch_port_slice.py and
tests/test_torch_port_clip.py and tests/test_torch_port_models.py hold both
directions to those modules.

The port's modules use the reference torch key layout, so a JAX tree loads
with ``load_state_dict(strict=True)``:

- U-Net: ``input``, ``enc{i}.block.0.conv.{0,1,3,4}``,
  ``bottleneck.conv.*``, ``dec{i}.up``, ``dec{i}.conv.conv.*``, ``out``;
- the autoencoder: the same block keys below ``encoder.`` (``input``,
  ``enc{1-3}``, ``bottleneck``) and ``decoder.`` (``dec{1-3}``, whose
  ConvBlockUpsample exports as ``up`` and ``conv.conv.*`` like the
  reference's ``_upsample``, torch_export.py:133; ``out``), the JAX tree's
  two submodules;
- the CLIP models add ``clip_feature_extractor.clip_model.*`` (the
  transformers CLIP vision keys, from the JAX ``clip_tower``),
  ``cross_attention_fusion.cross_attn.*`` (``nn.MultiheadAttention``'s
  layout; q_proj and k_proj, which the JAX models never create, are
  zero-filled), ``prompt_encoder.enc{i}.block.0.conv.*``,
  ``prompt_encoder.conv.conv.*`` and ``prompt_fusion``;
- the ClipRes models: the JAX ``resnet_backbone`` under ``encoder.model.``
  in the reference's ``nn.Sequential(*resnet34.children()[:-2])`` indices
  (``0`` conv1, ``1`` bn1, ``4``-``7`` the stages, each block ``conv1``,
  ``bn1``, ``conv2``, ``bn2``, ``downsample.{0,1}``), ``dec{1-5}``, and
  ``out`` (a ConvBlock: ``out.conv.*``) or ``mask_out`` and ``class_head``;
  the ClipAutoencoder: ``input``, ``coupler``, ``dec{1-4}``, ``out``
  (Dense kernels ``(I, O)`` <-> ``nn.Linear`` ``(O, I)``);
- ``prompt_fusion``: ``image_encoder.*`` and ``decoder.*`` (the
  autoencoder's halves), ``prompt_encoder.*``, ``fusion_conv``.

:func:`tp_plan` is ``parallel/mesh.py``'s ``shard_params_tp`` (:105-130)
on the port's parameters: it decides each leaf on the shape it has in the
JAX tree, through the same name map.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

from ..ops.cross_attention import mha_params_from_torch, mha_state_dict_from_params

Tree = Dict[str, Any]

# A ConvBlock's layers (JAX names) <-> the reference nn.Sequential indices.
_LAYER = {"conv1": "0", "bn1": "1", "conv2": "3", "bn2": "4"}
_LAYER_INV = {v: k for k, v in _LAYER.items()}
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}
# JAX submodules whose subtree keeps its name as a torch key prefix
_NESTED = ("prompt_encoder", "encoder", "decoder", "image_encoder")
CLIP = "clip_feature_extractor.clip_model."
FUSION = "cross_attention_fusion.cross_attn"
# the ClipRes models' ResNet-34: the JAX subtree and the torch prefix
RESNET_JAX = "resnet_backbone"
RESNET = "encoder.model."
# ResNet block layers whose torch name differs from the JAX one
_RESNET_LAYER = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}
_RESNET_LAYER_INV = {v: k for k, v in _RESNET_LAYER.items()}


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
    keys): to ``path + ".tmp"``, then renamed over ``path`` (JAX
    ``checkpoint.save_checkpoint``)."""
    flat = {"/".join(p): np.asarray(v) for p, v in leaves(tree)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def leaves(node: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    """(path, leaf) of every leaf of nested dicts, in insertion order."""
    for k, v in node.items():
        if isinstance(v, Mapping):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ---- the U-Net blocks (and the prompt encoder, prompt_fusion) -------------

def _torch_key(path: Tuple[str, ...]) -> str:
    """JAX leaf path (below ``params``/``batch_stats``) -> torch key."""
    top, *mid, leaf = path
    if top in _NESTED:
        return f"{top}." + _torch_key(tuple(path[1:]))
    if mid[:1] == ["conv_block"]:  # enc{i} / dec{i}: the block's ConvBlock
        mid = ["block.0.conv" if top.startswith("enc") else "conv.conv", _LAYER[mid[1]]]
    elif mid[:1] and mid[0] in _LAYER:  # a ConvBlock itself: bottleneck, the prompt conv
        mid = ["conv", _LAYER[mid[0]]]
    return ".".join([top, *mid, _LEAF[leaf]])


def _jax_leaf(path: List[str], leaf: str) -> Tuple[str, List[str]]:
    """(collection, ``path`` + the JAX name of the torch ``leaf``)."""
    if leaf == "weight":
        bn = path[-1].startswith("bn") or path[-1].endswith("_bn")
        leaf = "scale" if bn else "kernel"
    else:
        leaf = {"running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
    return ("batch_stats" if leaf in ("mean", "var") else "params"), path + [leaf]


def _jax_path(key: str) -> Tuple[str, List[str]]:
    """Torch key -> (collection, JAX leaf path); inverse of ``_torch_key``."""
    if key.startswith(RESNET):
        return _resnet_jax_path(key[len(RESNET):])
    top, *mid, leaf = key.split(".")
    if top in _NESTED:
        coll, path = _jax_path(key[len(top) + 1:])
        return coll, [top, *path]
    path = [top]
    if mid[:2] in (["block", "0"], ["conv", "conv"]):  # <enc>.block.0.conv.i, <dec>.conv.conv.i
        path += ["conv_block", _LAYER_INV[mid[-1]]]
    elif mid[:1] == ["conv"]:  # <ConvBlock>.conv.i
        path += [_LAYER_INV[mid[-1]]]
    else:  # <dec>.up, or a bare conv or Dense (input, out, prompt_fusion, coupler, ...)
        path += mid
    return _jax_leaf(path, leaf)


# ---- the ResNet-34 backbone -------------------------------------------------

def _resnet_torch_key(path: Tuple[str, ...]) -> str:
    """Leaf path below the JAX ``resnet_backbone`` -> torch key
    (``resnet34_children_to_torch`` :213)."""
    top, *mid, leaf = path
    if top in ("conv1", "bn1"):
        return f"{RESNET}{0 if top == 'conv1' else 1}.{_LEAF[leaf]}"
    stage, block = re.fullmatch(r"layer(\d)_(\d+)", top).groups()
    layer = _RESNET_LAYER.get(mid[0], mid[0])
    return f"{RESNET}{int(stage) + 3}.{block}.{layer}.{_LEAF[leaf]}"


def _resnet_jax_path(key: str) -> Tuple[str, List[str]]:
    """Torch key below ``encoder.model.`` -> (collection, JAX leaf path);
    inverse of ``_resnet_torch_key``."""
    parts = key.split(".")
    if parts[0] in ("0", "1"):
        return _jax_leaf([RESNET_JAX, "conv1" if parts[0] == "0" else "bn1"], parts[1])
    layer = ".".join(parts[2:-1])
    return _jax_leaf([RESNET_JAX, f"layer{int(parts[0]) - 3}_{parts[1]}",
                      _RESNET_LAYER_INV.get(layer, layer)], parts[-1])


# ---- the CLIP tower ---------------------------------------------------------

def _clip_torch_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """Leaf path in the JAX ``clip_tower`` -> (torch key below
    ``clip_feature_extractor.clip_model.``, kind of the kernel layout:
    "conv", "dense" or "raw"); ``clip_tower_to_torch`` :163."""
    top, rest = path[0], path[1:]
    if top == "patch_embedding":
        return "vision_model.embeddings.patch_embedding.weight", "conv"
    if top == "class_embedding":
        return "vision_model.embeddings.class_embedding", "raw"
    if top == "position_embedding":
        return "vision_model.embeddings.position_embedding.weight", "raw"
    if top == "visual_projection":
        return "visual_projection.weight", "dense"
    leaf = _LEAF[rest[-1]]
    if top in ("pre_layernorm", "post_layernorm"):
        name = "pre_layrnorm" if top == "pre_layernorm" else "post_layernorm"
        return f"vision_model.{name}.{leaf}", "raw"
    i = int(top[len("layer_"):])
    mod = {"fc1": "mlp.fc1", "fc2": "mlp.fc2"}.get(rest[0], ".".join(rest[:-1]))
    return f"vision_model.encoder.layers.{i}.{mod}.{leaf}", (
        "dense" if rest[-1] == "kernel" else "raw")


def _clip_jax_path(key: str) -> List[str]:
    """Inverse of ``_clip_torch_key``: torch key below the CLIP prefix ->
    the leaf path in the JAX ``clip_tower``."""
    fixed = {
        "vision_model.embeddings.patch_embedding.weight": ["patch_embedding", "kernel"],
        "vision_model.embeddings.class_embedding": ["class_embedding"],
        "vision_model.embeddings.position_embedding.weight": ["position_embedding"],
        "visual_projection.weight": ["visual_projection", "kernel"],
    }
    if key in fixed:
        return fixed[key]
    parts = key.split(".")
    m = re.fullmatch(r"vision_model\.encoder\.layers\.(\d+)\.(.+)", key)
    if m is None:  # vision_model.{pre_layrnorm,post_layernorm}.{weight,bias}
        ln = "pre_layernorm" if parts[1] == "pre_layrnorm" else parts[1]
        return [ln, "scale" if parts[2] == "weight" else "bias"]
    *mod, leaf = m.group(2).split(".")
    if mod[0] == "mlp":
        mod = mod[1:]
    is_ln = mod[-1].startswith("layer_norm")
    return [f"layer_{m.group(1)}", *mod,
            ("scale" if is_ln else "kernel") if leaf == "weight" else "bias"]


def _clip_kind(path: List[str]) -> str:
    """The kernel layout of the JAX ``clip_tower`` leaf at ``path``."""
    if path[0] == "patch_embedding":
        return "conv"
    return "dense" if path[-1] == "kernel" else "raw"


def _to_torch_layout(t: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "conv":  # flax (kH, kW, I, O) -> torch (O, I, kH, kW)
        return t.permute(3, 2, 0, 1)
    if kind == "dense":  # flax (I, O) -> torch Linear (O, I)
        return t.t()
    return t


def _to_jax_layout(t: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "conv":
        return t.permute(2, 3, 1, 0)
    if kind == "dense":
        return t.t()
    return t


# ---- pretrained towers in their torch checkpoints' own layouts -------------

_TORCHVISION = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6",
                "layer4": "7"}
_TORCHVISION_INV = {v: k for k, v in _TORCHVISION.items()}


def strip_compile_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """``sd`` without ``torch.compile``'s ``_orig_mod.`` key prefix."""
    return {(k[len("_orig_mod."):] if k.startswith("_orig_mod.") else k): v
            for k, v in sd.items()}


def _put(tree: Tree, path: List[str], t: torch.Tensor) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = np.ascontiguousarray(t.detach().cpu().numpy())


def clip_tree_from_torch(sd: Mapping[str, torch.Tensor]) -> Tree:
    """A transformers CLIP state dict -> the JAX ``clip_tower`` params, in
    the tensors' dtype: a ``CLIPVisionModelWithProjection``'s or a whole
    ``CLIPModel``'s (the same ``vision_model.*`` and ``visual_projection``
    keys; ``text_model.*``, ``text_projection``, ``logit_scale`` and the
    ``position_ids`` buffer are not the tower's)."""
    tree: Tree = {}
    for key, v in sd.items():
        if key.startswith(("vision_model.", "visual_projection.")) and \
                not key.endswith("position_ids"):
            path = _clip_jax_path(key)
            _put(tree, path, _to_jax_layout(v, _clip_kind(path)))
    return tree


def resnet34_tree_from_torch(sd: Mapping[str, torch.Tensor]) -> Tuple[Tree, Tree]:
    """A torchvision ResNet-34 state dict (``conv1``, ``bn1``,
    ``layer{1-4}.{b}.{conv1,bn1,conv2,bn2,downsample.{0,1}}``) -> the JAX
    ``ResNet34Features`` ``(params, batch_stats)``, in the tensors' dtype;
    ``fc`` and ``num_batches_tracked`` are not the features'."""
    trees: Dict[str, Tree] = {"params": {}, "batch_stats": {}}
    for key, v in sd.items():
        top, _, rest = key.partition(".")
        if top not in _TORCHVISION or key.endswith("num_batches_tracked"):
            continue
        coll, path = _resnet_jax_path(f"{_TORCHVISION[top]}.{rest}")
        _put(trees[coll], path[1:], _to_jax_layout(v, "conv") if path[-1] == "kernel" else v)
    return trees["params"], trees["batch_stats"]


def torchvision_resnet34_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's ``ResNet34Features`` state dict (``model.{0,1,4-7}``) in
    torchvision's key layout (``conv1``, ``bn1``, ``layer{1-4}``)."""
    out = {}
    for key, v in sd.items():
        idx, _, rest = key[len("model."):].partition(".")
        out[f"{_TORCHVISION_INV[idx]}.{rest}"] = v
    return out


# ---- whole models -----------------------------------------------------------

def state_dict_from_jax(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any]
) -> Dict[str, torch.Tensor]:
    """``params``/``batch_stats`` of any JAX registry model -> the port's
    strict state dict (fp32 CPU tensors).  Conv kernels go from flax
    ``(kH, kW, I, O)`` to torch ``(O, I, kH, kW)``, Dense kernels from
    ``(I, O)`` to ``(O, I)``; ConvTranspose kernels to ``(I, O, kH, kW)``
    with flax's spatial flip undone (torch_export.py:45-48)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, v in [*leaves(params), *leaves(batch_stats)]:
        t = torch.from_numpy(np.array(v, dtype=np.float32))
        if path[0] == "cross_attention_fusion":
            continue  # below, as one packed module
        if path[0] == "clip_tower":
            key, kind = _clip_torch_key(path[1:])
            sd[CLIP + key] = _to_torch_layout(t, kind).contiguous()
            continue
        if path[-1] == "kernel" and t.dim() == 2:  # Dense
            t = t.t()
        elif path[-1] == "kernel":
            t = t.permute(2, 3, 0, 1).flip(2, 3) if "up" in path else t.permute(3, 2, 0, 1)
        key = _resnet_torch_key(path[1:]) if path[0] == RESNET_JAX else _torch_key(path)
        sd[key] = t.contiguous()
    if "cross_attention_fusion" in params:
        sd.update(mha_state_dict_from_params(params["cross_attention_fusion"], FUSION))
    for key in [k for k in sd if k.endswith(".running_mean")]:
        # torch counts batches; eval never reads it.
        sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return sd


# ``shard_params_tp``'s smallest sharded leaf (its ``min_size``)
TP_MIN_SIZE = 1 << 12


def jax_out_axis(key: str, shape: Tuple[int, ...]):
    """``(JAX shape, dim, start, length)`` of the torch parameter ``key``
    of shape ``shape``: its leaf's shape in the JAX tree, and the torch dim
    that holds the JAX leaf's LAST axis, as the region ``[start, start +
    length)`` of that dim; None for a parameter the JAX tree lacks (the
    fusion's q_proj and k_proj).  Conv kernels ``(O, I, kH, kW)``: dim 0;
    ConvTranspose ``(I, O, kH, kW)``: dim 1; Dense ``(O, I)``: dim 0; the
    fusion's v_proj: its rows of the packed ``in_proj_weight``."""
    rev = tuple(reversed(shape))
    if key.startswith(FUSION + "."):
        leaf = key[len(FUSION) + 1:]
        if leaf == "in_proj_weight":  # [q; k; v] rows, (3C, C): v_proj is (C, C) in JAX
            c = shape[1]
            return (c, c), 0, 2 * c, c
        if leaf in ("v_proj_weight", "out_proj.weight"):
            return rev, 0, 0, shape[0]
        if leaf == "in_proj_bias":
            return (shape[0] // 3,), 0, 0, shape[0] // 3
        return (shape, 0, 0, shape[0]) if leaf == "out_proj.bias" else None
    if key.startswith(CLIP):
        path = _clip_jax_path(key[len(CLIP):])
        if path[0] == "patch_embedding":  # (O, I, kH, kW) -> (kH, kW, I, O)
            return (shape[2], shape[3], shape[1], shape[0]), 0, 0, shape[0]
        if path[-1] == "kernel":  # Dense
            return rev, 0, 0, shape[0]
        return shape, len(shape) - 1, 0, shape[-1]  # raw: the embeddings, LayerNorms
    _, path = _jax_path(key)
    if path[-1] != "kernel" or len(shape) == 1:
        return shape, 0, 0, shape[0]
    if len(shape) == 2:  # Dense
        return rev, 0, 0, shape[0]
    if "up" in path:  # (I, O, kH, kW) -> (kH, kW, I, O)
        return (shape[2], shape[3], shape[0], shape[1]), 1, 0, shape[1]
    return (shape[2], shape[3], shape[1], shape[0]), 0, 0, shape[0]


def tp_plan(params: Mapping[str, Tuple[int, ...]], n_model: int,
            min_size: int = TP_MIN_SIZE) -> Dict[str, Tuple[int, int, int]]:
    """The parameters that JAX's ``shard_params_tp`` shards over a model
    axis of ``n_model``: ``{key: (dim, start, length)}`` for each torch
    parameter (``params``: key -> shape) whose JAX leaf has ``ndim >= 2``, a
    last axis that ``n_model`` divides and at least ``min_size`` elements
    (see :func:`jax_out_axis`); every other leaf stays whole, as JAX
    replicates it.  Empty for ``n_model <= 1``."""
    plan = {}
    if n_model <= 1:
        return plan
    for key, shape in params.items():
        axis = jax_out_axis(key, tuple(shape))
        if axis is None:
            continue
        jshape, dim, start, length = axis
        if len(jshape) >= 2 and jshape[-1] % n_model == 0 and int(np.prod(jshape)) >= min_size:
            plan[key] = (dim, start, length)
    return plan


def jax_from_state_dict(
    state_dict: Mapping[str, torch.Tensor], *, fusion_qk: bool = False
) -> Tuple[Tree, Tree]:
    """The port's state dict -> JAX ``(params, batch_stats)`` as nested
    numpy dicts (fp32), the tree the JAX models declare.  The fusion's
    q_proj and k_proj are left out (the models call it with one context
    token, where flax never creates them) unless ``fusion_qk``."""
    trees: Dict[str, Tree] = {"params": {}, "batch_stats": {}}

    def put(coll, path, t):
        node = trees[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(t.numpy(), order="C")  # a copy: t may be the live tensor

    fusion = {}
    for key, v in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        t = v.detach().to("cpu", torch.float32)
        if key.startswith(FUSION + "."):
            fusion[key] = v
        elif key.startswith(CLIP):
            path = _clip_jax_path(key[len(CLIP):])
            put("params", ["clip_tower", *path], _to_jax_layout(t, _clip_kind(path)))
        else:
            coll, path = _jax_path(key)
            if path[-1] == "kernel" and t.dim() == 2:  # nn.Linear
                t = t.t()
            elif path[-1] == "kernel":
                t = t.flip(2, 3).permute(2, 3, 0, 1) if "up" in path else t.permute(2, 3, 1, 0)
            put(coll, path, t)
    if fusion:
        trees["params"]["cross_attention_fusion"] = mha_params_from_torch(
            fusion, FUSION, with_qk=fusion_qk)
    return trees["params"], trees["batch_stats"]
