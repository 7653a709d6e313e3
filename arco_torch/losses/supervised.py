"""Supervised losses (counterpart of arco_tpu/losses/supervised.py).

Channels-last as in JAX: logits/probs are [..., K], labels integer [...].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Float one-hot over a new trailing dim; negative labels give zeros."""
    oh = F.one_hot(labels.clamp(min=0).long(), num_classes).float()
    return oh * (labels >= 0)[..., None]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -1, reduction: str = "mean"):
    """torch F.cross_entropy semantics with ``ignore_index``."""
    valid = labels != ignore_index
    safe = labels.clamp(min=0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = nll * valid
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    return nll.sum() / valid.sum().clamp(min=1)


def dice_loss(probs: torch.Tensor, labels: torch.Tensor, num_classes: int,
              weight=None, smooth: float = 1e-5):
    """Per-class soft dice with whole-batch sums, averaged over classes."""
    target = one_hot(labels, num_classes)
    probs = probs.float()
    dims = tuple(range(probs.ndim - 1))
    intersect = (probs * target).sum(dims)
    y_sum = (target * target).sum(dims)
    z_sum = (probs * probs).sum(dims)
    loss = 1.0 - (2.0 * intersect + smooth) / (z_sum + y_sum + smooth)
    if weight is not None:
        loss = loss * torch.as_tensor(weight, device=loss.device)
    return loss.mean()


def kld_batchmean(student_logits: torch.Tensor,
                  teacher_logits: torch.Tensor):
    """KL(softmax(teacher) || softmax(student)) with reduction='batchmean'
    (pretrain_2D.py:99-103): in f32, summed over every element and divided
    by the row count."""
    logp = torch.log_softmax(student_logits.float(), dim=-1)
    logq = torch.log_softmax(teacher_logits.float(), dim=-1)
    q = torch.softmax(teacher_logits.float(), dim=-1)
    return (q * (logq - logp)).sum() / student_logits.shape[0]
