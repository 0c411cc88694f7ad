"""Plain PyTorch building blocks of the benchmark's references.

Everything here is written from the published semantics of the models and
of their training step, in float32, with no kernel, cache or batching of
the program under test; it imports neither JAX nor the program.  The
sampling arithmetic (the augmentation draws made from the seed and the
step key) is a frozen copy of what the program derives, so that the
reference sees the same draws as the program without reading them from it.

Precision: ``Precision("fp32")`` is the reference.  ``Precision("fp8")`` is
the control: the same arithmetic with every convolution's and matrix
product's operands rounded to float8 e4m3 (per-tensor scale) on the way in
and their cotangents to float8 e5m2 on the way back, the usual recipe of
fp8 training, one step below the bfloat16 the configurations state.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN while the
    reference runs, restored after."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


# --------------------------------------------------------------------------
# precision
# --------------------------------------------------------------------------

def _round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """How a product's operands are rounded: not at all ("fp32"), or to
    float8 ("fp8", the control)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "fp32" else _Fp8.apply(x)


FP32 = Precision("fp32")


# --------------------------------------------------------------------------
# layers (NCHW inside; parameters in a flat dict keyed by the published
# torch layout's names)
# --------------------------------------------------------------------------

def conv(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor, q: Precision,
         stride: int = 1, padding: int = 0) -> torch.Tensor:
    b = p.get(name + ".bias")
    return F.conv2d(q(x), q(p[name + ".weight"]), b, stride=stride, padding=padding)


def conv_transpose2x2(p, name: str, x: torch.Tensor, q: Precision) -> torch.Tensor:
    return F.conv_transpose2d(q(x), q(p[name + ".weight"]), p[name + ".bias"], stride=2)


def batch_norm(p, name: str, x: torch.Tensor, train: bool,
               stats: Optional[dict] = None) -> torch.Tensor:
    """BatchNorm over (N, H, W): in training the batch mean and biased
    variance normalise; in eval the running ones.  ``stats`` collects the
    batch statistics by name (to set running statistics from a batch)."""
    if train:
        if stats is not None:
            stats[name] = (x.mean((0, 2, 3)).detach(), x.var((0, 2, 3), unbiased=False).detach())
        return F.batch_norm(x, None, None, p[name + ".weight"], p[name + ".bias"], True, 0.0,
                            BN_EPS)
    return F.batch_norm(x, p[name + ".running_mean"], p[name + ".running_var"],
                        p[name + ".weight"], p[name + ".bias"], False, 0.0, BN_EPS)


def conv_block(p, name: str, x: torch.Tensor, q: Precision, train: bool, stats=None):
    """[Conv3x3 (SAME) -> BatchNorm -> ReLU] x 2; ``name`` holds ``conv.{0,1,3,4}``."""
    x = F.relu(batch_norm(p, f"{name}.conv.1", conv(p, f"{name}.conv.0", x, q, padding=1),
                          train, stats))
    return F.relu(batch_norm(p, f"{name}.conv.4", conv(p, f"{name}.conv.3", x, q, padding=1),
                             train, stats))


def down_block(p, name: str, x, q, train, stats=None):
    """ConvBlock -> 2x2 max-pool; parameters under ``name.block.0``."""
    return F.max_pool2d(conv_block(p, f"{name}.block.0", x, q, train, stats), 2)


def up_skip_block(p, name: str, x, skip, q, train, stats=None):
    """ConvTranspose 2x2/2 -> bilinear resize (align corners) to the skip's
    size -> concat [up | skip] -> ConvBlock."""
    up = conv_transpose2x2(p, f"{name}.up", x, q)
    if up.shape[2:] != skip.shape[2:]:
        up = F.interpolate(up, size=skip.shape[2:], mode="bilinear", align_corners=True)
    return conv_block(p, f"{name}.conv", torch.cat([up, skip], 1), q, train, stats)


def maybe_checkpoint(fn, *args, enabled: bool):
    """``fn(*args)``, recomputed in the backward where ``enabled`` (the
    reference at full batch keeps only the blocks' outputs)."""
    if not enabled:
        return fn(*args)
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False)


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------
# (name, shape, init, fan_in, trainable); init: "lecun" (normal,
# 1/sqrt(fan_in)), "zeros", "ones", "count"

Spec = List[Tuple[str, Tuple[int, ...], str, int, bool]]


def conv_spec(name: str, cin: int, cout: int, k: int) -> Spec:
    return [(f"{name}.weight", (cout, cin, k, k), "lecun", cin * k * k, True),
            (f"{name}.bias", (cout,), "zeros", 0, True)]


def convt_spec(name: str, cin: int, cout: int) -> Spec:
    return [(f"{name}.weight", (cin, cout, 2, 2), "lecun", cin * 4, True),
            (f"{name}.bias", (cout,), "zeros", 0, True)]


def bn_spec(name: str, c: int) -> Spec:
    return [(f"{name}.weight", (c,), "ones", 0, True), (f"{name}.bias", (c,), "zeros", 0, True),
            (f"{name}.running_mean", (c,), "zeros", 0, False),
            (f"{name}.running_var", (c,), "ones", 0, False),
            (f"{name}.num_batches_tracked", (), "count", 0, False)]


def block_spec(name: str, cin: int, c: int) -> Spec:
    return (conv_spec(f"{name}.conv.0", cin, c, 3) + bn_spec(f"{name}.conv.1", c)
            + conv_spec(f"{name}.conv.3", c, c, 3) + bn_spec(f"{name}.conv.4", c))


def make_weights(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``spec`` from ``seed``, on ``device``, in fp32: one
    normal draw for every random leaf together, cut and scaled."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    random = [s for s in spec if s[2] == "lecun"]
    total = sum(math.prod(s[1]) for s in random)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, init, fan_in, _ in spec:
        n = math.prod(shape)
        if init == "lecun":
            out[name] = flat[at:at + n].view(shape) / math.sqrt(fan_in)
            at += n
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
    return out


def trainable_names(spec: Spec) -> List[str]:
    return [s[0] for s in spec if s[4]]


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def cross_entropy(logits_nchw: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits_nchw, targets.long())


# --------------------------------------------------------------------------
# Adam with L2 added to the gradient (torch.optim.Adam(weight_decay=...))
# --------------------------------------------------------------------------

class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], names: Sequence[str], opt: dict):
        self.params, self.names = params, list(names)
        self.lr, self.wd, self.eps = opt["learning_rate"], opt["weight_decay"], opt["eps"]
        self.b1, self.b2 = opt["b1"], opt["b2"]
        self.m = {n: torch.zeros_like(params[n]) for n in self.names}
        self.v = {n: torch.zeros_like(params[n]) for n in self.names}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update; returns the gradients as the moments took them (L2
        included)."""
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        taken = {}
        for n in self.names:
            p = self.params[n]
            g = grads[n] + self.wd * p
            taken[n] = g
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (self.m[n] / c1) / ((self.v[n] / c2).sqrt() + self.eps))
        return taken


# --------------------------------------------------------------------------
# the draws of a step: a frozen copy of the program's sampling arithmetic
# --------------------------------------------------------------------------

def step_generator(seed: int, step_key: int) -> torch.Generator:
    """The host generator of one step's augmentation draws: seeded by
    ``SeedSequence([seed, step_key])``."""
    words = [int(seed), int(step_key)]
    return torch.Generator().manual_seed(int(np.random.SeedSequence(words).generate_state(1)[0]))


def _uniform(gen, n: int, lo: float, hi: float) -> torch.Tensor:
    return (torch.rand(n, generator=gen) * (hi - lo) + lo).clamp(min=lo)


def sample_augment(n: int, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Per sample: flip (p 0.5), angle ~ U(-90, 90) degrees, jitter factors
    brightness U(0.6, 1.4), contrast U(0.7, 1.3), saturation U(0.8, 1.2),
    hue U(-0.2, 0.2), then blur sigma ~ U(0.1, 2) as 5 normalised taps, in
    that order of draws."""
    flip = torch.rand(n, generator=gen) < 0.5
    angles = _uniform(gen, n, -90.0, 90.0)
    jitter = torch.stack([_uniform(gen, n, max(0.0, 1.0 - x), 1.0 + x) for x in (0.4, 0.3, 0.2)]
                         + [_uniform(gen, n, -0.2, 0.2)], 1)
    sigma = _uniform(gen, n, 0.1, 2.0)
    x = torch.arange(-2, 3, dtype=torch.float32)
    k = torch.exp(-0.5 * (x[None] / sigma[:, None]) ** 2)
    return {"flip": flip, "angles": angles, "jitter": jitter, "blur": k / k.sum(1, keepdim=True)}


# --------------------------------------------------------------------------
# augmentation, written from its description
# --------------------------------------------------------------------------

def _shift_rows(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """out[n, i, j] = x[n, i, j - s[n, i]], zero outside; x (n, h, w, ...)."""
    n, h, w = x.shape[:3]
    src = torch.arange(w, device=x.device)[None, None, :] - s[:, :, None].long()
    valid = (src >= 0) & (src < w)
    idx = src.clamp(0, w - 1)
    idx = idx.view(n, h, w, *([1] * (x.dim() - 3))).expand(x.shape)
    out = torch.gather(x, 2, idx)
    return out * valid.view(n, h, w, *([1] * (x.dim() - 3))).to(x.dtype)


def rotate_shear3(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Nearest rotation of square (n, h, w, c) maps by ``angles`` degrees:
    the nearest quarter turn, then the rest (|phi| <= 45 degrees) as three
    shears, x by a = -tan(phi/2), y by b = sin(phi), x by a again, each
    moving whole pixels by round(a * (row - centre)) (half to even), zero
    fill.  A quarter turn +1 turns the displayed image counter-clockwise."""
    n, h, w = x.shape[:3]
    quarter = torch.round(angles / 90.0)
    phi = (angles - quarter * 90.0) * (math.pi / 180.0)
    a = -torch.tan(phi / 2.0)
    b = torch.sin(phi)
    c = (h - 1) / 2.0
    pos = torch.arange(h, dtype=torch.float32, device=x.device)[None, :] - c
    sx = -torch.round(a[:, None] * pos)
    sy = -torch.round(b[:, None] * pos)
    t = x.transpose(1, 2)
    q = quarter.view(-1, *([1] * (x.dim() - 1)))
    x = torch.where(q == 1, t.flip(1), torch.where(q == -1, t.flip(2), x))
    x = _shift_rows(x, sx)
    x = _shift_rows(x.transpose(1, 2), sy).transpose(1, 2)
    return _shift_rows(x, sx)


def _gray(img):
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def colour_jitter(img: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """torchvision's brightness, contrast, saturation, hue in that order,
    each clamped to [0, 1]; hue through HSV with the sextant taken by order
    comparisons."""
    fb, fc, fs = (f[:, k].view(-1, 1, 1, 1) for k in range(3))
    img = (img * fb).clamp(0, 1)
    mean = _gray(img).mean((1, 2)).view(-1, 1, 1, 1)
    img = (fc * img + (1 - fc) * mean).clamp(0, 1)
    img = (fs * img + (1 - fs) * _gray(img)[..., None]).clamp(0, 1)
    r, g, bl = img[..., 0], img[..., 1], img[..., 2]
    mx, mn = img.amax(-1), img.amin(-1)
    d = mx - mn
    s = torch.where(mx > 0, d / mx.clamp(min=1e-12), torch.zeros_like(mx))
    sd = d.clamp(min=1e-12)
    rc, gc, bc = (mx - r) / sd, (mx - g) / sd, (mx - bl) / sd
    is_r = (r >= g) & (r >= bl)
    is_g = ~is_r & (g >= bl)
    hue = torch.where(is_r, bc - gc, torch.where(is_g, 2.0 + rc - bc, 4.0 + gc - rc))
    hue = torch.where(d > 0, (hue / 6.0) % 1.0, torch.zeros_like(hue))
    hue = (hue + f[:, 3].view(-1, 1, 1)) % 1.0
    i = torch.floor(hue * 6.0)
    fr = hue * 6.0 - i
    v = mx
    p_, q_, t_ = v * (1 - s), v * (1 - s * fr), v * (1 - s * (1 - fr))
    i = i.long() % 6
    table = torch.stack([torch.stack(c, -1) for c in (
        (v, t_, p_), (q_, v, p_), (p_, v, t_), (p_, q_, v), (t_, p_, v), (v, p_, q_))], 0)
    out = torch.gather(table, 0, i[None, ..., None].expand(1, *i.shape, 3))[0]
    return out.clamp(0, 1)


def blur5(img: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap blur with per-sample taps, reflect padding, rows
    first, then columns."""
    x = img.permute(0, 3, 1, 2)
    x = F.pad(x, (0, 0, 2, 2), mode="reflect")
    x = sum(x[:, :, k:k + img.shape[1]] * taps[:, k].view(-1, 1, 1, 1) for k in range(5))
    x = F.pad(x, (2, 2, 0, 0), mode="reflect")
    x = sum(x[:, :, :, k:k + img.shape[2]] * taps[:, k].view(-1, 1, 1, 1) for k in range(5))
    return x.permute(0, 2, 3, 1)


def augment(images_u8: torch.Tensor, masks: torch.Tensor, draws: Dict[str, torch.Tensor],
            every: int):
    """The augmented batch: per sample a horizontal flip and the rotation
    on image and mask together, then colour jitter and blur on the image;
    positions 0, every, 2*every, ... keep their clean values.  Returns
    ([0, 1] fp32 images, int64 masks)."""
    dev = images_u8.device
    d = {k: v.to(dev) for k, v in draws.items()}
    clean_img = images_u8.float() / 255.0
    x = torch.cat([clean_img, masks.float()[..., None]], -1)
    x = torch.where(d["flip"].view(-1, 1, 1, 1), x.flip(2), x)
    x = rotate_shear3(x, d["angles"])
    img = blur5(colour_jitter(x[..., :3], d["jitter"]), d["blur"])
    keep = (torch.arange(images_u8.shape[0], device=dev) % every == 0)
    out_img = torch.where(keep.view(-1, 1, 1, 1), clean_img, img)
    out_mask = torch.where(keep.view(-1, 1, 1), masks.long(), x[..., 3].round().long())
    return out_img, out_mask


# --------------------------------------------------------------------------
# reference training steps
# --------------------------------------------------------------------------

def leaf_norms(tensors: Dict[str, torch.Tensor], names: Sequence[str]) -> torch.Tensor:
    return torch.stack([tensors[n].double().norm() for n in names])


def train_steps(params: Dict[str, torch.Tensor], names: Sequence[str], opt: dict,
                steps: Sequence, loss_fn) -> dict:
    """Run ``len(steps)`` Adam steps of ``loss_fn(params, step)`` from
    ``params`` (updated in place).  Returns the losses, the norm of each
    leaf's first gradient as the optimizer took it, and the norm of each
    leaf's change after the last step, in ``names`` order."""
    start = {n: params[n].clone() for n in names}
    adam = Adam(params, names, opt)
    losses, first = [], None
    for step in steps:
        leaves = [params[n].requires_grad_(True) for n in names]
        loss = loss_fn(params, step)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for t in leaves:
            t.requires_grad_(False)
        g = {n: (torch.zeros_like(params[n]) if gr is None else gr)
             for n, gr in zip(names, grads)}
        taken = adam.step(g)
        if first is None:
            first = leaf_norms(taken, names)
        losses.append(float(loss.detach()))
        del loss, grads, g, taken
    change = torch.stack([(params[n] - start[n]).double().norm() for n in names])
    return {"losses": losses, "grad_norms": first.cpu(), "change_norms": change.cpu()}
