"""Cross-attention of a spatial feature map on a context, and the fusion
module of the CLIP models; counterpart of
``image_segmentation_tpu/ops/cross_attention.py`` (pallas_cross_attention
:82, reference_cross_attention :140, CrossAttentionFusion :159,
mha_params_from_torch :204).

Wrapper (``WRAPPERS``), the TPU kernel it replaces, and its source:

- :func:`cross_attention` — ``pallas_cross_attention`` :82 (body
  ``_attn_kernel`` :45); ``csrc/cross_attention.cu``.

A CPU tensor takes the plain version, :func:`cross_attention_plain`; a
CUDA tensor launches the kernel (bf16 in and out) and raises if the build
or the launch fails.  The wrapper counts its launches in
``cross_attention.launches``.  JAX defines no gradient for the kernel, so on
a CUDA tensor an input that requires grad while grad mode is on raises.

:class:`CrossAttentionFusion` reaches the kernel only with a multi-token
context ``(B, S, D)``, S > 1.  Every model of the repo passes the pooled
CLIP embedding, one token, and a softmax over one key is 1: the output is
``out_proj(v_proj(context))`` broadcast over all positions, for any query
and any number of heads (:186-195), two small matmuls and no kernel.
Under tensor parallelism (``parallel/tensor.py``) the projections whose
weights are sharded (v_proj, out_proj) are column-parallel, each output
gathered.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tensor as tp
from ._build import launch, on_cpu, ptr


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.linear(x, w.to(x.dtype), b.to(x.dtype))


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, d = t.shape
    return t.reshape(b, n, heads, d // heads).transpose(1, 2)


def cross_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """``reference_cross_attention`` :140 in the kernel's op order: fp32
    scores times the scale, fp32 softmax, the weights rounded to v's dtype,
    an fp32 product with v, the result in q's dtype."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d // num_heads)
    qh, kh, vh = (_split_heads(t, num_heads).float() for t in (q, k, v))
    scores = torch.einsum("bhld,bhsd->bhls", qh, kh) * scale
    w = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhls,bhsd->bhld", w, vh)
    return out.transpose(1, 2).reshape(q.shape).to(q.dtype)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """Multi-head ``softmax(q k^T / sqrt(dh)) v``: q (B, L, D), k and v (B,
    S, D), any S >= 1, ``num_heads`` dividing D; returns (B, L, D) in q's
    dtype."""
    name = "cross_attention"
    b, length, d = q.shape
    if k.dim() != 3 or k.shape[0] != b or k.shape[2] != d or v.shape != k.shape:
        raise ValueError(f"{name}: k and v must be (B, S, {d}) for q {tuple(q.shape)}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if num_heads <= 0 or d % num_heads:
        raise ValueError(f"{name}: embed dim {d} not divisible by num_heads {num_heads}")
    if k.shape[1] == 0:
        raise ValueError(f"{name}: the context has no tokens")
    if on_cpu(q):
        return cross_attention_plain(q, k, v, num_heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(f"{name}: the kernel has no gradient; call it under torch.no_grad()")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"{name}: {what} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {what} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if d // num_heads > 1024:
        raise ValueError(f"{name}: head dim {d // num_heads} above the kernel's 1024")
    out = torch.empty_like(q)
    launch(cross_attention, "imgseg_cross_attention", ptr(q), ptr(k), ptr(v), ptr(out),
           b, length, k.shape[1], d, num_heads, 1.0 / math.sqrt(d // num_heads))
    return out


WRAPPERS = (cross_attention,)
for _w in WRAPPERS:
    _w.launches = 0


class CrossAttentionFusion(nn.Module):
    """The reference CrossAttentionFusion (processing_blocks.py:287-322):
    ``forward(spatial (B, H, W, C), context (B, S, Dk) or (B, Dk)) -> (B,
    H, W, C)`` in the module's dtype.

    The parameters live in ``cross_attn``, an ``nn.MultiheadAttention``
    used as the container of torch's layout: ``in_proj_weight`` (3C, C)
    when the context width ``kv_dim`` equals C, else ``q_proj_weight`` (C,
    C), ``k_proj_weight`` and ``v_proj_weight`` (C, kv_dim); then
    ``in_proj_bias`` (3C,) and ``out_proj``.  ``kv_dim`` is the width of
    the context, which ``v_proj`` (and ``k_proj``) read: a tower with
    ``proj_dim`` 32 under a 512-wide fusion has kv_dim 32."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int = 4,
        dtype: torch.dtype = torch.bfloat16,
        kv_dim: Optional[int] = None,
        *,
        device=None,
    ):
        super().__init__()
        self.embed_dim, self.num_heads, self.dtype = embed_dim, num_heads, dtype
        self.kv_dim = kv_dim or embed_dim
        self.cross_attn = nn.MultiheadAttention(
            embed_dim, num_heads, kdim=self.kv_dim, vdim=self.kv_dim, batch_first=True,
            device=device)

    def proj_weight(self, i: int) -> torch.Tensor:
        """The (C, in) weight of q_proj (0), k_proj (1) or v_proj (2)."""
        mha = self.cross_attn
        if mha.in_proj_weight is not None:
            c = self.embed_dim
            return mha.in_proj_weight[i * c:(i + 1) * c]
        return (mha.q_proj_weight, mha.k_proj_weight, mha.v_proj_weight)[i]

    def _proj_shard(self, i: int) -> Optional[tp.Shard]:
        """The shard of projection i's weight: the packed weight's holds v's
        rows (q and k, absent from the JAX tree, are never sharded)."""
        mha = self.cross_attn
        if mha.in_proj_weight is not None:
            s = tp.shard(mha, "in_proj_weight")
            return s if s is not None and s.start == i * self.embed_dim else None
        return tp.shard(mha, f"{'qkv'[i]}_proj_weight")

    def _proj(self, x: torch.Tensor, i: int) -> torch.Tensor:
        c = self.embed_dim
        b = self.cross_attn.in_proj_bias[i * c:(i + 1) * c]
        return tp.column(_linear, x, self.proj_weight(i), b, self._proj_shard(i))

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        o = self.cross_attn.out_proj
        return tp.column(_linear, x, o.weight, o.bias, tp.shard(o))

    def forward(self, spatial: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, h, w, c = spatial.shape
        if c != self.embed_dim:
            raise ValueError(f"spatial channels {c} != embed_dim {self.embed_dim}")
        if context.dim() == 2:
            context = context[:, None, :]
        ctx = context.to(self.dtype)
        if ctx.shape[1] == 1:
            fused = self._out(self._proj(ctx, 2))  # (B, 1, C), query-independent
            return fused[:, None].expand(b, h, w, c)
        q = self._proj(spatial.reshape(b, h * w, c).to(self.dtype), 0)
        k, v = self._proj(ctx, 1), self._proj(ctx, 2)
        attn = cross_attention(q.contiguous(), k.contiguous(), v.contiguous(), self.num_heads)
        return self._out(attn).reshape(b, h, w, c)


def mha_params_from_torch(sd: Mapping[str, torch.Tensor], prefix: str = "cross_attn",
                          *, with_qk: bool = True) -> Dict[str, Dict[str, np.ndarray]]:
    """The fusion's torch parameters (packed ``in_proj_weight`` or separate
    ``{q,k,v}_proj_weight``) -> the JAX ``CrossAttentionFusion`` params, as
    fp32 numpy: flax kernels are (in, out).  ``with_qk=False`` leaves out
    q_proj and k_proj, which the JAX models never create at S = 1."""
    p = f"{prefix}." if prefix else ""

    def np32(t):
        return t.detach().to("cpu", torch.float32).numpy()

    bias = np32(sd[p + "in_proj_bias"])
    c = bias.shape[0] // 3
    if p + "in_proj_weight" in sd:
        w = np32(sd[p + "in_proj_weight"])
        weights = [w[:c], w[c:2 * c], w[2 * c:]]
    else:
        weights = [np32(sd[p + f"{n}_proj_weight"]) for n in "qkv"]
    names = ("q_proj", "k_proj", "v_proj") if with_qk else ("v_proj",)
    out = {n: {"kernel": np.ascontiguousarray(weights[i].T), "bias": bias[i * c:(i + 1) * c]}
           for i, n in zip(range(3) if with_qk else (2,), names)}
    out["out_proj"] = {"kernel": np.ascontiguousarray(np32(sd[p + "out_proj.weight"]).T),
                       "bias": np32(sd[p + "out_proj.bias"])}
    return out


def mha_state_dict_from_params(params: Mapping[str, Mapping[str, np.ndarray]],
                               prefix: str = "cross_attn") -> Dict[str, torch.Tensor]:
    """JAX ``CrossAttentionFusion`` params -> the fusion's torch parameters
    (inverse of :func:`mha_params_from_torch`).  q_proj and k_proj, absent
    from a tree made at S = 1, are zero-filled (``utils/torch_export.py:
    90-103``); their values cannot reach the output there.  The weights
    are packed when the context width equals the embed width."""
    p = f"{prefix}." if prefix else ""
    out_k = np.asarray(params["out_proj"]["kernel"], np.float32)
    c = out_k.shape[1]
    kv = np.asarray(params["v_proj"]["kernel"]).shape[0]

    def part(name, fan_in):
        if name in params:
            return (np.asarray(params[name]["kernel"], np.float32).T,
                    np.asarray(params[name]["bias"], np.float32))
        return np.zeros((c, fan_in), np.float32), np.zeros((c,), np.float32)

    (qw, qb), (kw, kb), (vw, vb) = part("q_proj", c), part("k_proj", kv), part("v_proj", kv)
    sd = {p + "in_proj_bias": np.concatenate([qb, kb, vb])}
    if kv == c:
        sd[p + "in_proj_weight"] = np.concatenate([qw, kw, vw])
    else:
        sd.update({p + "q_proj_weight": qw, p + "k_proj_weight": kw, p + "v_proj_weight": vw})
    sd[p + "out_proj.weight"] = out_k.T
    sd[p + "out_proj.bias"] = np.asarray(params["out_proj"]["bias"], np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
