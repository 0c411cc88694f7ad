"""Tensor parallelism over the model axis of ``parallel.mesh``'s grid; the
counterpart of ``image_segmentation_tpu/parallel/mesh.py``'s
``shard_params_tp`` (:105-130) placement and of the collectives that GSPMD
inserts around it.

JAX shards a weight over the ``model`` axis along its last (output-feature)
dimension and lets the compiler place the collectives.  Here each layer
whose weight is sharded is column-parallel: the M ranks of a data row hold
the same rows and the full input activation, each computes the output
channels of its contiguous 1/M slice of the weight, and the slices are
gathered over the model group.  Everything after the gather (BatchNorm,
pools, resizes, the loss) runs the same on every model rank, so the
replicated parameters there get identical gradients on every model rank.
The backward of the gather takes the rank's slice of the cotangent; the
input's gradient from a sharded layer is a partial sum over its output
channels, so the input passes :func:`copy_to_model` (identity forward, sum
over the model group backward); so does a replicated vector, such as a
bias, of which the layer reads only its slice (:func:`take`).

A sharded parameter is replaced by its local part (:func:`shard_module_`)
and its :class:`Shard` is kept on its module (``module._tp[name]``, which a
deep copy keeps), so the optimizer's moments are the slice's.  The layer
code asks :func:`shard` and runs :func:`column`; with no shard every
function here is the identity and launches nothing, so an unsharded model
is the path without this module bit for bit.

The collectives run in fp32 for bf16 tensors (exact for the gathers).  Gloo
gathers and reduce-scatters CPU tensors natively; for CUDA tensors it has
only ``all_reduce`` and ``broadcast``, so there the gather is the sum of
zero-padded slices and the reduce-scatter the sum, sliced.  A collective
the backend lacks raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

from . import mesh


@dataclass(frozen=True)
class Shard:
    """The slice of a parameter that one model rank holds: along torch dim
    ``dim``, the region ``[start, start + length)`` of the full tensor is
    split in ``size`` contiguous parts and this rank holds part ``rank``;
    what lies outside the region (the packed q and k rows of the
    cross-attention fusion's ``in_proj_weight``) is held whole."""

    dim: int
    start: int
    length: int
    rank: int
    size: int

    @property
    def local(self) -> int:
        return self.length // self.size

    @property
    def offset(self) -> int:
        """This rank's first index within the region."""
        return self.rank * self.local


def _dist():
    import torch.distributed as dist

    return dist


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the collectives' dtype: fp32 for the 16-bit floats."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


def _native(t: torch.Tensor) -> bool:
    """Whether the backend gathers and reduce-scatters ``t`` itself."""
    return t.device.type == "cpu" or _dist().get_backend(mesh.model_group()) == "nccl"


def gather(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The model group's slices of ``t`` concatenated along ``dim`` in
    model-rank order (no autograd)."""
    m, r, group = mesh.model_size(), mesh.model_rank(), mesh.model_group()
    src = _wide(t.detach()).contiguous()
    if _native(t):  # the slices concatenated along dim 0
        out = src.new_empty((m * src.shape[0], *src.shape[1:]))
        _dist().all_gather_into_tensor(out, src, group=group)
        out = out.view(m, *src.shape)
    else:
        out = src.new_zeros((m, *src.shape))
        out[r] = src
        _dist().all_reduce(out, group=group)
    dim = dim % t.dim()
    shape = list(t.shape)
    shape[dim] *= m
    return out.movedim(0, dim).reshape(shape).to(t.dtype)


def reduce_scatter(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``t`` summed over the model group, and this rank's 1/M slice of the
    sum along ``dim`` (no autograd)."""
    m, r, group = mesh.model_size(), mesh.model_rank(), mesh.model_group()
    dim = dim % t.dim()
    local = t.shape[dim] // m
    src = _wide(t.detach())
    if _native(t):
        parts = src.unflatten(dim, (m, local)).movedim(dim, 0).contiguous()
        out = parts.new_empty(parts.shape[1:])
        _dist().reduce_scatter_tensor(out, parts.flatten(0, 1), group=group)
        return out.to(t.dtype)
    src = src.clone()
    _dist().all_reduce(src, group=group)
    return src.narrow(dim, r * local, local).contiguous().to(t.dtype)


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the model group (no autograd), as a new tensor."""
    out = _wide(t.detach()).clone()
    _dist().all_reduce(out, group=mesh.model_group())
    return out.to(t.dtype)


class _Gather(torch.autograd.Function):
    """:func:`gather`; the backward takes the rank's slice of the cotangent."""

    @staticmethod
    def forward(ctx, t, dim):
        ctx.dim, ctx.local = dim, t.shape[dim]
        return gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        start = mesh.model_rank() * ctx.local
        return g.narrow(ctx.dim, start, ctx.local).contiguous(), None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the model
    group (each rank's is a partial of the input's gradient)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g)


def gather_model(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """:func:`gather`, differentiable."""
    return _Gather.apply(t, dim % t.dim())


def copy_to_model(t: torch.Tensor) -> torch.Tensor:
    """``t``, whose gradient is summed over the model group."""
    return _CopyToModel.apply(t)


# ---- sharded parameters -----------------------------------------------------

def shard(module: nn.Module, name: str = "weight") -> Optional[Shard]:
    """The :class:`Shard` of ``module``'s parameter ``name``, or None."""
    return getattr(module, "_tp", {}).get(name)


def take(t: Optional[torch.Tensor], s: Optional[Shard], dim: int = 0):
    """This rank's slice along ``dim`` of a replicated ``t`` that holds the
    region of ``s`` whole (a bias of the output channels), its gradient
    summed over the model group; ``t`` itself without ``s``."""
    if s is None or t is None:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        t = copy_to_model(t)
    return t.narrow(dim, s.offset, s.local)


def column(op: Callable, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           s: Optional[Shard]) -> torch.Tensor:
    """``op(x, w, b)`` of a layer whose output channels are the last dim:
    with ``s`` (``w`` this rank's slice, ``b`` the whole bias or None) on
    the slice, the input's gradient summed over the model group, and the
    output gathered (with grad mode off, as the frozen ResNet-34 runs,
    the gather records no autograd node); ``op(x, w, b)`` without."""
    if s is None:
        return op(x, w, b)
    if torch.is_grad_enabled() and x.requires_grad:
        x = copy_to_model(x)
    return gather_model(op(x, w, take(b, s)), -1)


def shards(model: nn.Module) -> Dict[str, Shard]:
    """Every sharded parameter of ``model`` by its state-dict key."""
    out = {}
    for prefix, m in model.named_modules():
        for name, s in getattr(m, "_tp", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = s
    return out


def local_part(full: torch.Tensor, s: Shard) -> torch.Tensor:
    """The part of the whole tensor ``full`` that the rank of ``s`` holds."""
    n = full.shape[s.dim]
    parts = [full.narrow(s.dim, 0, s.start),
             full.narrow(s.dim, s.start + s.offset, s.local),
             full.narrow(s.dim, s.start + s.length, n - s.start - s.length)]
    return torch.cat([p for p in parts if p.shape[s.dim]], s.dim).contiguous()


def full_tensor(t: torch.Tensor, s: Shard) -> torch.Tensor:
    """The whole tensor of a rank's part ``t`` (no autograd): its region
    gathered over the model group; every model rank must call."""
    n = t.shape[s.dim]
    parts = [t.narrow(s.dim, 0, s.start), gather(t.narrow(s.dim, s.start, s.local), s.dim),
             t.narrow(s.dim, s.start + s.local, n - s.start - s.local)]
    return torch.cat([p for p in parts if p.shape[s.dim]], s.dim)


def shard_module_(model: nn.Module, plan: Mapping[str, tuple], rank: int, size: int) -> None:
    """Replace each parameter that ``plan`` names (``{key: (dim, start,
    length)}``, ``utils.convert.tp_plan``) with this rank's part of it, as a
    new ``Parameter`` with the same ``requires_grad``, and record its
    :class:`Shard` on its module.  Call before the optimizer is built."""
    for key, (dim, start, length) in plan.items():
        path, name = key.rsplit(".", 1) if "." in key else ("", key)
        module = model.get_submodule(path)
        s = Shard(dim, start, length, rank, size)
        old = getattr(module, name)
        with torch.no_grad():
            new = nn.Parameter(local_part(old.detach(), s), requires_grad=old.requires_grad)
        setattr(module, name, new)
        if "_tp" not in module.__dict__:
            module._tp = {}
        module._tp[name] = s


def full_state(model: nn.Module, values: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``values`` (a state dict, or tensors keyed like it: Adam's moments)
    with every sharded entry made whole; every model rank must call."""
    sh = shards(model)
    return {k: full_tensor(v, sh[k]) if k in sh else v for k, v in values.items()}


def local_state(model: nn.Module, values: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Whole ``values`` keyed like the state dict -> this rank's parts."""
    sh = shards(model)
    return {k: local_part(v, sh[k]) if k in sh else v for k, v in values.items()}
