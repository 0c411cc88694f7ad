"""The training loss and the eval metrics, fp32; counterpart of
``image_segmentation_tpu/ops/losses.py`` (cross_entropy :33, dice_score
:92, hybrid_loss :140, iou :180, pixel_accuracy :216).

Logits are NHWC ``(B, H, W, C)``, targets ``(B, H, W)`` integer class ids.
The dice score keeps the reference's smp double softmax (the published
numbers pass softmax probabilities into smp's DiceLoss, which applies
softmax again).  The other losses of the JAX module wait for the models
that train with them (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_SMP_EPS = 1e-7


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over all pixels (``nn.CrossEntropyLoss``)."""
    logz = F.log_softmax(logits.float(), dim=-1)
    return -logz.gather(-1, targets.long().unsqueeze(-1)).mean()


def hybrid_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The multiclass training loss: plain CE (the reference HybridLoss)."""
    return cross_entropy(logits, targets)


def _one_hot(targets: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(targets.long(), num_classes).float()


def dice_score(
    logits: torch.Tensor, targets: torch.Tensor, *, smp_parity: bool = True
) -> torch.Tensor:
    """1 - smp ``DiceLoss(mode='multiclass')`` of ``softmax(logits)``:
    per-class dice over (batch, pixels), smooth 0, eps 1e-7, classes absent
    from the target count as a loss of 0, mean over all classes."""
    num_classes = logits.shape[-1]
    probs = F.softmax(logits.float(), dim=-1)
    if smp_parity:
        probs = F.softmax(probs, dim=-1)
    p = probs.reshape(probs.shape[0], -1, num_classes)
    onehot = _one_hot(targets.reshape(targets.shape[0], -1), num_classes)
    inter = (p * onehot).sum((0, 1))
    card = p.sum((0, 1)) + onehot.sum((0, 1))
    loss = 1.0 - 2.0 * inter / card.clamp_min(_SMP_EPS)
    present = onehot.sum((0, 1)) > 0
    return 1.0 - torch.where(present, loss, torch.zeros_like(loss)).mean()


def iou(logits: torch.Tensor, targets: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Mean over classes of the batch-wide IoU of the argmax prediction;
    absent classes give ~1 through the eps smoothing."""
    num_classes = logits.shape[-1]
    pred = _one_hot(logits.float().argmax(-1), num_classes)
    tgt = _one_hot(targets, num_classes)
    inter = (pred * tgt).sum((0, 1, 2))
    union = pred.sum((0, 1, 2)) + tgt.sum((0, 1, 2)) - inter
    return ((inter + eps) / (union + eps)).mean()


def pixel_accuracy(
    logits: torch.Tensor, targets: torch.Tensor, *, num_classes: int = 3
) -> torch.Tensor:
    """Mean of the per-class accuracies over the classes present in the
    target."""
    correct = (logits.float().argmax(-1) == targets).float()
    tgt = _one_hot(targets, num_classes)
    total = tgt.sum((0, 1, 2))
    accs = (correct.unsqueeze(-1) * tgt).sum((0, 1, 2)) / total.clamp_min(1.0)
    present = (total > 0).float()
    return (accs * present).sum() / present.sum().clamp_min(1.0)
