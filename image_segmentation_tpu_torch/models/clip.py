"""The CLIP ViT vision tower, NHWC input; counterpart of
``image_segmentation_tpu/models/clip.py`` (clip_preprocess :38, quick_gelu
:56, ClipAttention :60, ClipEncoderLayer :86, ClipVisionTower :106).

The tower returns the pooled (class token, post-LayerNorm), projected
embedding ``(B, proj_dim)``, as ``CLIPModel.get_image_features``.  Its
modules use the transformers ``CLIPVisionModelWithProjection`` key layout
(``vision_model.embeddings.*``, ``vision_model.pre_layrnorm``,
``vision_model.encoder.layers.{i}.{self_attn,mlp,layer_norm1,layer_norm2}``,
``vision_model.post_layernorm``, ``visual_projection``), under
``clip_feature_extractor.clip_model`` in the CLIP models, so
``utils.convert.state_dict_from_jax`` loads the JAX tree strictly.

Parameters stay fp32; the weights are used in the compute dtype, as
flax's ``dtype=`` modules cast them at each use.  The frozen tower makes
that cast once (``ClipFeatureExtractor.compute_tower``) instead of at
every forward.  The op order is JAX's: q is scaled before the product, the
softmax runs in fp32 and is cast back, and LayerNorm takes fp32 statistics.
The attention, MLP and LayerNorms are stock PyTorch ops: in JAX they are
plain XLA, not Pallas kernels.

Under tensor parallelism (``parallel/tensor.py``) each Dense and the patch
conv whose weight is sharded is column-parallel, its output gathered; the
embeddings are added on the patch conv's channel slice before the gather.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.precision import wide
from ..parallel import tensor as tp

CLIP_IMAGE_SIZE = 224
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
LN_EPS = 1e-5


def clip_preprocess(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] NHWC images of any size -> (B, 224, 224, 3) normalised with
    the CLIP mean and std, in the images' dtype.  The resize is bilinear
    and antialiased when it shrinks, as ``jax.image.resize`` is (within
    3e-7 on [0, 1] images); it runs in fp32, or in float64 for float64
    images."""
    dt = images.dtype
    if images.shape[1:3] != (CLIP_IMAGE_SIZE, CLIP_IMAGE_SIZE):
        images = F.interpolate(
            wide(images).permute(0, 3, 1, 2), size=(CLIP_IMAGE_SIZE, CLIP_IMAGE_SIZE),
            mode="bilinear", align_corners=False, antialias=True,
        ).permute(0, 2, 3, 1).to(dt)
    mean = torch.tensor(CLIP_MEAN, dtype=dt, device=images.device)
    std = torch.tensor(CLIP_STD, dtype=dt, device=images.device)
    return (images - mean) / std


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax ``LayerNorm``: fp32 statistics and affine (float64 for a
    float64 x), the result in x's dtype.  torch takes the variance in two
    passes where flax takes ``E[x^2] - E[x]^2``; the two differ by
    rounding."""
    xf = wide(x)
    return F.layer_norm(xf, ln.normalized_shape, ln.weight.to(xf.dtype), ln.bias.to(xf.dtype),
                        LN_EPS).to(x.dtype)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` in x's dtype (flax ``Dense(dtype=...)`` on fp32 params),
    column-parallel when its weight is sharded."""
    def op(x, w, b):
        return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))

    return tp.column(op, x, layer.weight, layer.bias, tp.shard(layer))


class ClipAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, *, device=None):
        super().__init__()
        self.heads = heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, nn.Linear(hidden, hidden, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, d = x.shape
        dh = d // self.heads

        def split(t):
            return t.view(b, length, self.heads, dh).transpose(1, 2)

        q = linear(x, self.q_proj) * (dh ** -0.5)
        scores = torch.einsum("bhld,bhmd->bhlm", split(q), split(linear(x, self.k_proj)))
        w = torch.softmax(wide(scores), dim=-1).to(x.dtype)
        out = torch.einsum("bhlm,bhmd->bhld", w, split(linear(x, self.v_proj)))
        return linear(out.transpose(1, 2).reshape(b, length, d), self.out_proj)


class ClipMLP(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, *, device=None):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp_dim, device=device)
        self.fc2 = nn.Linear(mlp_dim, hidden, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(quick_gelu(linear(x, self.fc1)), self.fc2)


class ClipEncoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int, *, device=None):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.self_attn = ClipAttention(hidden, heads, device=device)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.mlp = ClipMLP(hidden, mlp_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(layer_norm(x, self.layer_norm1))
        return x + self.mlp(layer_norm(x, self.layer_norm2))


class ClipEmbeddings(nn.Module):
    """Patch conv (no bias), class token and position embeddings."""

    def __init__(self, hidden: int, patch: int, *, device=None):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, hidden, patch, stride=patch, bias=False,
                                         device=device)
        self.class_embedding = nn.Parameter(torch.zeros(hidden, device=device))
        tokens = (CLIP_IMAGE_SIZE // patch) ** 2 + 1
        self.position_embedding = nn.Embedding(tokens, hidden, device=device)

    def forward(self, pixels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """With the patch conv sharded, its hidden channels are this rank's
        slice, the class and position embeddings are taken on the same
        slice, and the sum is gathered."""
        b = pixels.shape[0]
        s = tp.shard(self.patch_embedding)
        w = self.patch_embedding.weight.to(dtype)
        x = F.conv2d(pixels.to(dtype).permute(0, 3, 1, 2), w, stride=self.patch_embedding.stride)
        x = x.flatten(2).transpose(1, 2)  # (B, patches, hidden) in row-major patch order
        cls = tp.take(self.class_embedding, s).to(dtype).expand(b, 1, -1)
        pos = self.position_embedding.weight
        pos_s = tp.shard(self.position_embedding)
        if pos_s is None:
            pos = tp.take(pos, s, dim=1)
        elif s is None:
            pos = tp.full_tensor(pos, pos_s)
        x = torch.cat([cls, x], dim=1) + pos.to(dtype)
        return x if s is None else tp.gather_model(x, -1)


class ClipVisionModel(nn.Module):
    def __init__(self, hidden, layers, heads, mlp_dim, patch, *, device=None):
        super().__init__()
        self.embeddings = ClipEmbeddings(hidden, patch, device=device)
        self.pre_layrnorm = nn.LayerNorm(hidden, eps=LN_EPS, device=device)  # transformers' spelling
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            [ClipEncoderLayer(hidden, heads, mlp_dim, device=device) for _ in range(layers)])
        self.post_layernorm = nn.LayerNorm(hidden, eps=LN_EPS, device=device)


class ClipVisionTower(nn.Module):
    """ViT vision encoder + visual projection: normalised (B, 224, 224, 3)
    pixels -> (B, proj_dim) fp32 embeddings.  The defaults are ViT-B/32's."""

    def __init__(
        self,
        hidden: int = 768,
        layers: int = 12,
        heads: int = 12,
        mlp_dim: int = 3072,
        patch: int = 32,
        proj_dim: int = 512,
        dtype: torch.dtype = torch.float32,
        *,
        device=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.proj_dim = proj_dim
        self.vision_model = ClipVisionModel(hidden, layers, heads, mlp_dim, patch, device=device)
        self.visual_projection = nn.Linear(hidden, proj_dim, bias=False, device=device)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        x = layer_norm(vm.embeddings(pixels, self.dtype), vm.pre_layrnorm)
        for layer in vm.encoder.layers:
            x = layer(x)
        pooled = layer_norm(x[:, 0], vm.post_layernorm)
        return wide(linear(pooled, self.visual_projection))


class ClipFeatureExtractor(nn.Module):
    """The tower behind ``clip_preprocess`` (the reference's
    ClipFeatureExtractor).

    ``freeze`` (the models' ``freeze_clip``, the default): its parameters
    do not require grad and it runs without autograd, on the cached cast
    of :meth:`compute_tower`, as JAX wraps its output in ``stop_gradient``.
    ``freeze=False`` drops the ``stop_gradient``: where grad mode is on,
    the fp32 tower runs with its casts to the compute dtype in the graph, so
    its parameters get the gradient ``jax.grad`` gives them; the values are
    the cached cast's.  Either way the Trainer leaves the tower out of the
    optimizer, as JAX masks its updates (``FROZEN_PREFIXES``)."""

    def __init__(self, dtype: torch.dtype, clip_kwargs=None, freeze: bool = True, *,
                 device=None):
        super().__init__()
        self.clip_model = ClipVisionTower(dtype=dtype, device=device, **(clip_kwargs or {}))
        self.freeze = freeze
        if freeze:
            self.requires_grad_(False)
        self._cast = {}  # {"key": ..., "tower": ...}, see compute_tower

    def compute_tower(self) -> ClipVisionTower:
        """The tower with its conv, Dense and embedding weights in the
        compute dtype (the LayerNorms keep fp32), made once and again only
        when a parameter changes: a forward then launches no casts, which
        kept a batch-32 forward of the ViT-B/32 waiting on the host."""
        tower = self.clip_model
        if tower.dtype == torch.float32:
            return tower
        key = tuple((p.data_ptr(), p._version) for p in tower.parameters())
        if self._cast.get("key") != key:
            cast = copy.deepcopy(tower).requires_grad_(False)
            for m in cast.modules():
                if not isinstance(m, nn.LayerNorm):
                    for p in m.parameters(recurse=False):
                        p.data = p.data.to(tower.dtype)
            self._cast = {"key": key, "tower": cast}
        return self._cast["tower"]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pixels = clip_preprocess(x)
        if not self.freeze and torch.is_grad_enabled():
            return self.clip_model(pixels)
        with torch.no_grad():
            return self.compute_tower()(pixels)
