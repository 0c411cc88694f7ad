"""The training losses and the eval metrics, fp32; counterpart of
``image_segmentation_tpu/ops/losses.py`` (cross_entropy :33,
bce_with_logits :50, dice_score :92, dice_score_binary :116, hybrid_loss
:140, dice_ce_loss :145, hybrid_loss_binary :162, iou :180, iou_binary
:197, pixel_accuracy :216, pixel_accuracy_binary :239,
combined_confusion_loss :252, dice_from_iou :280): all of it.

Multiclass: logits NHWC ``(B, H, W, C)``, targets ``(B, H, W)`` integer
class ids.

Every batch-wide mean and sum is taken over the GLOBAL batch, as JAX takes
it over its batch-sharded array: through ``parallel.mesh.global_mean`` /
``global_sum``, which sum over ranks (differentiably) when several
processes hold a batch's rows, and are the plain ``mean`` / ``sum`` at
world size 1.  Binary: logits ``(B, H, W, 1)`` or ``(B, H, W)``, targets
``(B, H, W)`` in {0, 1}.  The dice terms keep the reference's smp double
activation (the published numbers pass softmax or sigmoid probabilities
into smp's DiceLoss, which applies it again); ``dice_ce_loss``, the
intended Dice + CE, takes one softmax, as its JAX original does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.mesh import global_mean, global_sum
from .precision import wide

_SMP_EPS = 1e-7


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over all pixels (``nn.CrossEntropyLoss``)."""
    logz = F.log_softmax(wide(logits), dim=-1)
    return global_mean(-logz.gather(-1, targets.long().unsqueeze(-1)))


def hybrid_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The multiclass training loss: plain CE (the reference HybridLoss)."""
    return cross_entropy(logits, targets)


def _one_hot(targets: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(targets.long(), num_classes).float()


def _dice_loss_of_probs(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """smp multiclass DiceLoss of ``probs`` (B, H, W, C) as given: per-class
    dice over (batch, pixels), smooth 0, eps 1e-7, classes absent from the
    target count as a loss of 0, mean over all classes."""
    num_classes = probs.shape[-1]
    p = probs.reshape(probs.shape[0], -1, num_classes)
    onehot = _one_hot(targets.reshape(targets.shape[0], -1), num_classes)
    inter = global_sum(p * onehot, (0, 1))
    count = global_sum(onehot, (0, 1))
    card = global_sum(p, (0, 1)) + count
    loss = 1.0 - 2.0 * inter / card.clamp_min(_SMP_EPS)
    present = count > 0
    return torch.where(present, loss, torch.zeros_like(loss)).mean()


def dice_ce_loss(logits: torch.Tensor, targets: torch.Tensor, *,
                 dice_weight: float = 1.0) -> torch.Tensor:
    """CE + ``dice_weight`` x the multiclass soft-dice loss of ONE softmax
    (the loss the reference's HybridLoss builds but never returns)."""
    logits = wide(logits)
    dice = _dice_loss_of_probs(F.softmax(logits, dim=-1), targets)
    return cross_entropy(logits, targets) + dice_weight * dice


def combined_confusion_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    incorrect_penalty: float = 2.0,
    confusion_pairs: tuple = ((1, 2),),
    confusion_penalty: float = 2.0,
) -> torch.Tensor:
    """Mean per-pixel CE, times ``incorrect_penalty`` where the argmax is
    wrong and times ``confusion_penalty`` more where it swaps a pair of
    ``confusion_pairs`` (cat <-> dog)."""
    logits = wide(logits)
    targets = targets.long()
    loss = -F.log_softmax(logits, dim=-1).gather(-1, targets.unsqueeze(-1))[..., 0]
    preds = logits.argmax(-1)
    loss = torch.where(preds != targets, loss * incorrect_penalty, loss)
    for c1, c2 in confusion_pairs:
        confused = ((preds == c1) & (targets == c2)) | ((preds == c2) & (targets == c1))
        loss = torch.where(confused, loss * confusion_penalty, loss)
    return global_mean(loss)


def dice_from_iou(iou_value: torch.Tensor) -> torch.Tensor:
    """The dice the reference logs, recomputed from IoU: 2 IoU / (1 + IoU)."""
    return 2.0 * iou_value / (1.0 + iou_value)


def dice_score(
    logits: torch.Tensor, targets: torch.Tensor, *, smp_parity: bool = True
) -> torch.Tensor:
    """1 - smp ``DiceLoss(mode='multiclass')`` of ``softmax(logits)``:
    per-class dice over (batch, pixels), smooth 0, eps 1e-7, classes absent
    from the target count as a loss of 0, mean over all classes."""
    probs = F.softmax(logits.float(), dim=-1)
    if smp_parity:
        probs = F.softmax(probs, dim=-1)
    return 1.0 - _dice_loss_of_probs(probs, targets)


def iou(logits: torch.Tensor, targets: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Mean over classes of the batch-wide IoU of the argmax prediction;
    absent classes give ~1 through the eps smoothing."""
    num_classes = logits.shape[-1]
    pred = _one_hot(logits.float().argmax(-1), num_classes)
    tgt = _one_hot(targets, num_classes)
    inter = global_sum(pred * tgt, (0, 1, 2))
    union = global_sum(pred, (0, 1, 2)) + global_sum(tgt, (0, 1, 2)) - inter
    return ((inter + eps) / (union + eps)).mean()


def _squeeze_channel(t: torch.Tensor) -> torch.Tensor:
    return t.squeeze(-1) if t.dim() == 4 else t


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits (``BCEWithLogitsLoss``), in the
    stable form ``max(x, 0) - x*t + log1p(exp(-|x|))``."""
    x = wide(logits)
    t = targets.to(x.dtype)
    return global_mean(torch.clamp(x, min=0.0) - x * t + torch.log1p(torch.exp(-x.abs())))


def _binary_dice_loss(probs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """smp binary DiceLoss of ``probs`` over (batch, pixels): smooth 0, eps
    1e-7, 0 when the target has no positive pixel."""
    p = probs.reshape(probs.shape[0], -1)
    o = t.reshape(t.shape[0], -1)
    inter = global_sum(p * o)
    count = global_sum(o)
    card = global_sum(p) + count
    loss = 1.0 - 2.0 * inter / card.clamp_min(_SMP_EPS)
    return torch.where(count > 0, loss, torch.zeros_like(loss))


def dice_score_binary(
    logits: torch.Tensor, targets: torch.Tensor, *, smp_parity: bool = True
) -> torch.Tensor:
    """1 - smp binary ``DiceLoss`` of ``sigmoid(logits)``, which takes the
    sigmoid again (``smp_parity``)."""
    probs = torch.sigmoid(_squeeze_channel(logits).float())
    if smp_parity:
        probs = torch.sigmoid(probs)
    return 1.0 - _binary_dice_loss(probs, targets.float())


def hybrid_loss_binary(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The binary training loss: BCE on logits + smp binary DiceLoss of
    ``sigmoid(logits)`` (double sigmoid)."""
    x = wide(_squeeze_channel(logits))
    t = targets.to(x.dtype)
    return bce_with_logits(x, t) + _binary_dice_loss(torch.sigmoid(torch.sigmoid(x)), t)


def iou_binary(logits: torch.Tensor, targets: torch.Tensor, *, eps: float = 1e-6,
               threshold: float = 0.5) -> torch.Tensor:
    """Per-sample IoU of ``sigmoid(logits) > threshold``, averaged over the
    batch."""
    preds = (torch.sigmoid(_squeeze_channel(logits).float()) > threshold).float()
    t = _squeeze_channel(targets.float())
    inter = (preds * t).sum((1, 2))
    union = preds.sum((1, 2)) + t.sum((1, 2)) - inter
    return global_mean((inter + eps) / (union + eps))


def pixel_accuracy_binary(logits: torch.Tensor, targets: torch.Tensor, *,
                          threshold: float = 0.5) -> torch.Tensor:
    """The share of pixels where ``sigmoid(logits) > threshold`` equals the
    target."""
    preds = (torch.sigmoid(_squeeze_channel(logits).float()) > threshold).float()
    return global_mean((preds == _squeeze_channel(targets.float())).float())


def pixel_accuracy(
    logits: torch.Tensor, targets: torch.Tensor, *, num_classes: int = 3
) -> torch.Tensor:
    """Mean of the per-class accuracies over the classes present in the
    target."""
    correct = (logits.float().argmax(-1) == targets).float()
    tgt = _one_hot(targets, num_classes)
    total = global_sum(tgt, (0, 1, 2))
    accs = global_sum(correct.unsqueeze(-1) * tgt, (0, 1, 2)) / total.clamp_min(1.0)
    present = (total > 0).float()
    return (accs * present).sum() / present.sum().clamp_min(1.0)
