"""Multi-label losses of the port.

Port of ``protnote_tpu/train/losses.py`` (the reference's
``protnote/utils/losses.py``).  Every function is ``(logits, targets, ...) ->
scalar`` over (B, L) float32, with an optional elementwise ``mask`` so that
padded rows and label columns never contribute (the masked mean
``sum(x * m) / max(sum(m), 1)``).  These are plain PyTorch: at (32, 32,102)
they are a few elementwise passes over 4 MB, next to a step that moves
hundreds of GB.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


def _bce_elementwise(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE-with-logits: ``max(x, 0) - x * y +
    log1p(exp(-|x|))``."""
    return torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype)
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = -1.0,
               gamma: float = 2.0, label_smoothing: float = 0.0,
               mask: Optional[torch.Tensor] = None, reduction: str = "mean") -> torch.Tensor:
    targets = targets.float()
    if label_smoothing > 0:
        targets = targets * (1.0 - label_smoothing) + (1.0 - targets) * label_smoothing
    bce = _bce_elementwise(logits.float(), targets)
    pt = torch.exp(-bce)
    loss = ((1.0 - pt) ** gamma) * bce
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    if reduction == "mean":
        return _masked_mean(loss, mask)
    if reduction == "sum":
        if mask is not None:
            loss = loss * mask.to(loss.dtype)
        return loss.sum()
    return loss


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, pos_weight=None,
                    weight: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    targets = targets.float()
    x = logits.float()
    if pos_weight is not None:
        # torch semantics: -[pw * y * log(s) + (1 - y) * log(1 - s)]
        loss = -(pos_weight * targets * F.logsigmoid(x) + (1.0 - targets) * F.logsigmoid(-x))
    else:
        loss = _bce_elementwise(x, targets)
    if weight is not None:
        loss = loss * weight
    return _masked_mean(loss, mask)


def _batch_weights_from_label_weights(label_weights: torch.Tensor,
                                      targets: torch.Tensor) -> torch.Tensor:
    """Per-sample weight = the sum of its positive labels' weights,
    broadcast across the label axis (reference get_batch_weights_v2)."""
    w = (label_weights[None, :] * targets).sum(dim=1, keepdim=True)
    return w.expand_as(targets)


def weighted_bce(logits, targets, label_weights, mask=None):
    targets = targets.float()
    w = _batch_weights_from_label_weights(label_weights.float(), targets)
    return bce_with_logits(logits, targets, weight=w, mask=mask)


def cb_loss(logits, targets, label_counts, beta: float = 0.9999, mask=None):
    """Class-balanced loss; ``label_counts`` are per-label sample counts."""
    targets = targets.float()
    n = label_counts.shape[0]
    effective_num = 1.0 - torch.pow(torch.tensor(beta, dtype=torch.float32),
                                    label_counts.float())
    effective_num = torch.where(effective_num == 0, torch.inf, effective_num)
    weights = (1.0 - beta) / effective_num
    weights = weights / weights.sum() * n
    w = _batch_weights_from_label_weights(weights.to(targets.device), targets)
    return bce_with_logits(logits, targets, weight=w, mask=mask)


def batch_weighted_bce(logits, targets, epsilon: float = 1e-10, mask=None):
    targets = targets.float()
    num_pos = targets.sum() + epsilon
    num_neg = targets.numel() - num_pos + epsilon
    total = num_pos + num_neg
    w_pos = (1.0 / num_pos) * (total / 2.0)
    w_neg = (1.0 / num_neg) * (total / 2.0)
    w = targets * w_pos + (1.0 - targets) * w_neg
    return bce_with_logits(logits, targets, weight=w, mask=mask)


def batch_label_weighted_bce(logits, targets, epsilon: float = 1e-10, mask=None):
    targets = targets.float()
    total = targets.sum() + epsilon
    freq = targets.sum(dim=0) / total
    safe = torch.where(freq == 0, 1.0, freq)
    inv = torch.where(freq == 0, 1.0, 1.0 / safe)
    weights = inv / inv.sum()
    return bce_with_logits(logits, targets, weight=weights[None, :], mask=mask)


def rgd_bce(logits, targets, temperature: float, mask=None):
    """Exp-reweighted BCE with the reference's numerics: the factor comes
    from the scalar mean BCE (its legacy ``reduce="none"`` argument meant
    ``reduction="mean"``), detached."""
    targets = targets.float()
    loss = _masked_mean(_bce_elementwise(logits.float(), targets), mask)
    scale = torch.exp(torch.clamp(loss.detach(), max=temperature) / (temperature + 1.0))
    return loss * scale


def supcon_loss(logits, targets, dim: int = 1):
    """One-way supervised contrastive loss (reference losses.py:35-55)."""
    targets = targets.float()
    logits = logits.float()
    shifted = logits - logits.max(dim=dim, keepdim=True).values.detach()
    log_prob = shifted - torch.log(torch.exp(shifted).sum(dim=dim, keepdim=True))
    norm = targets.sum(dim=dim)
    mean_log_prob_pos = (targets * log_prob).sum(dim=dim) / norm
    return -torch.nan_to_num(mean_log_prob_pos, nan=0.0).mean()


def get_loss_fn(params: Dict, label_weights=None, label_counts=None,
                bce_pos_weight=None) -> Callable:
    """``(logits, targets, mask=None) -> loss``, keyed by ``LOSS_FN`` (the
    JAX ``get_loss_fn``).  ``label_weights``/``label_counts`` are tensors on
    the logits' device (WeightedBCE, CBLoss)."""
    name = params["LOSS_FN"]
    if name == "BCE":
        return lambda lg, tg, mask=None: bce_with_logits(lg, tg, pos_weight=bce_pos_weight,
                                                         mask=mask)
    if name == "FocalLoss":
        return lambda lg, tg, mask=None: focal_loss(
            lg, tg, alpha=params.get("FOCAL_LOSS_ALPHA", -1),
            gamma=params.get("FOCAL_LOSS_GAMMA", 2),
            label_smoothing=params.get("LABEL_SMOOTHING", 0.0), mask=mask)
    if name == "WeightedBCE":
        if label_weights is None:
            raise ValueError("WeightedBCE needs label_weights")
        return lambda lg, tg, mask=None: weighted_bce(lg, tg, label_weights, mask=mask)
    if name == "CBLoss":
        if label_counts is None:
            raise ValueError("CBLoss needs label_counts")
        return lambda lg, tg, mask=None: cb_loss(lg, tg, label_counts, mask=mask)
    if name == "BatchWeightedBCE":
        return lambda lg, tg, mask=None: batch_weighted_bce(lg, tg, mask=mask)
    if name == "BatchLabelWeightedBCE":
        return lambda lg, tg, mask=None: batch_label_weighted_bce(lg, tg, mask=mask)
    if name == "RGDBCE":
        return lambda lg, tg, mask=None: rgd_bce(lg, tg, params["RGDBCE_TEMP"], mask=mask)
    if name == "SupCon":
        return lambda lg, tg, mask=None: supcon_loss(lg, tg)
    raise ValueError(f"Unknown loss function {name}")
