"""Classification losses (counterpart of the JAX package's
``ops/losses.py``): focal loss, weighted and label-smoothed cross
entropy on logits ``[B, C]`` and integer labels ``[B]``, with a stable
log-softmax and f32 sums whatever the logits' dtype."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


def cross_entropy(logits, labels, *, label_smoothing: float = 0.0,
                  class_weights=None, reduction: str = "mean"):
    """CE with optional label smoothing and per-class weights, with
    ``torch.nn.functional.cross_entropy``'s semantics: the smoothed target
    is ``(1 - s) onehot + s / C``, each class term is weighted by its
    class weight, and with weights the 'mean' divides by the sum of the
    labels' weights, not by the batch size."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"invalid reduction {reduction!r} "
                         "(mean | sum | none)")
    logp = _log_softmax(logits)
    c = logits.shape[-1]
    target = F.one_hot(labels.long(), c).float()
    if label_smoothing > 0.0:
        target = target * (1.0 - label_smoothing) + label_smoothing / c
    if class_weights is not None:
        wc = torch.as_tensor(class_weights, dtype=torch.float32,
                             device=logp.device)
        per_sample = -(target * wc * logp).sum(-1)
        if reduction == "mean":
            return per_sample.sum() / wc[labels.long()].sum()
    else:
        per_sample = -(target * logp).sum(-1)
    if reduction == "mean":
        return per_sample.mean()
    if reduction == "sum":
        return per_sample.sum()
    return per_sample


def focal_loss(logits, labels, *, alpha: float = 0.25, gamma: float = 2.0,
               reduction: str = "mean"):
    """``alpha (1 - pt)^gamma CE`` per sample, ``pt = exp(-CE)``."""
    ce = cross_entropy(logits, labels, reduction="none")
    fl = alpha * (1.0 - torch.exp(-ce)) ** gamma * ce
    if reduction == "mean":
        return fl.mean()
    if reduction == "sum":
        return fl.sum()
    return fl


def class_weights_from_counts(counts) -> torch.Tensor:
    """``total / (num_classes * count_c)``, counts of 0 taken as 1."""
    counts = torch.as_tensor(counts, dtype=torch.float32)
    return counts.sum() / (counts.shape[0] * counts.clamp(min=1.0))


def make_loss_fn(loss_type: str, *, focal_alpha: float = 0.25,
                 focal_gamma: float = 2.0, label_smoothing: float = 0.0,
                 class_weights=None):
    """``(logits, labels) -> scalar`` for 'focal' | 'weighted_ce' | 'ce'."""
    if loss_type == "focal":
        return lambda logits, labels: focal_loss(
            logits, labels, alpha=focal_alpha, gamma=focal_gamma)
    if loss_type == "weighted_ce":
        if class_weights is None:
            raise ValueError("weighted_ce requires class_weights")
        w = torch.as_tensor(class_weights, dtype=torch.float32)
        return lambda logits, labels: cross_entropy(
            logits, labels, class_weights=w)
    if loss_type == "ce":
        return lambda logits, labels: cross_entropy(
            logits, labels, label_smoothing=label_smoothing)
    raise ValueError(f"unknown loss_type: {loss_type!r}")
