"""Supervised losses (counterpart of arco_tpu/losses/supervised.py;
reference: code/utils/losses.py, pretrain_2D.py:99).

Channels-last as in JAX: logits/probs are [..., K], labels integer [...].
The consistency losses after ``kld_batchmean`` are library leftovers that
no trainer of either package calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from arco_torch.ops.collectives import all_reduce_sum


class DiceLossState:
    """Placeholder kept for the JAX package's import surface; dice_loss is
    functional."""


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Float one-hot over a new trailing dim; negative labels give zeros."""
    oh = F.one_hot(labels.clamp(min=0).long(), num_classes).float()
    return oh * (labels >= 0)[..., None]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -1, reduction: str = "mean",
                  group=None):
    """torch F.cross_entropy semantics with ``ignore_index`` (which may lie
    outside [0, K), as 255 does: the masked entries read a clamped index,
    as JAX's gather clamps). ``group``: a process group whose ranks hold
    the rest of the batch; the mean is then taken over all of it."""
    valid = labels != ignore_index
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = nll * valid
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    total, count = nll.sum(), valid.sum()
    if group is not None:
        total, count = all_reduce_sum(
            torch.stack([total, count.to(total.dtype)]), group)
    return total / count.clamp(min=1)


def dice_loss(probs: torch.Tensor, labels: torch.Tensor, num_classes: int,
              weight=None, smooth: float = 1e-5, group=None):
    """Per-class soft dice with whole-batch sums, averaged over classes.
    ``group``: a process group whose ranks hold the rest of the batch; the
    sums then run over all of it."""
    target = one_hot(labels, num_classes)
    probs = probs.float()
    dims = tuple(range(probs.ndim - 1))
    intersect = (probs * target).sum(dims)
    y_sum = (target * target).sum(dims)
    z_sum = (probs * probs).sum(dims)
    if group is not None:
        intersect, y_sum, z_sum = all_reduce_sum(
            torch.stack([intersect, y_sum, z_sum]), group)
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


def softmax_mse_loss(input_logits, target_logits):
    """utils/losses.py:85-100, as the elementwise mean."""
    p = torch.softmax(input_logits.float(), dim=-1)
    q = torch.softmax(target_logits.float(), dim=-1)
    return torch.mean((p - q) ** 2)


def softmax_kl_loss(input_logits, target_logits):
    """utils/losses.py:104-121: KL(softmax(target) || softmax(input)),
    summed over classes and averaged over the rest."""
    logp = torch.log_softmax(input_logits.float(), dim=-1)
    q = torch.softmax(target_logits.float(), dim=-1)
    logq = torch.log_softmax(target_logits.float(), dim=-1)
    return torch.mean(torch.sum(q * (logq - logp), dim=-1))


def symmetric_mse_loss(input1, input2):
    """utils/losses.py:125-133: the gradient reaches both inputs."""
    return torch.mean((input1 - input2) ** 2)


def entropy_loss(probs, eps: float = 1e-6):
    """Mean pixel entropy (utils/losses.py:7-14)."""
    return torch.mean(-torch.sum(probs * torch.log(probs + eps), dim=-1))


def focal_loss(logits, labels, gamma: float = 2.0, alpha: float = 0.25,
               ignore_index: int = -1):
    """utils/losses.py:136-170."""
    valid = labels != ignore_index
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    logpt = torch.gather(torch.log_softmax(logits.float(), dim=-1), -1,
                         safe[..., None])[..., 0]
    loss = -alpha * (1 - torch.exp(logpt)) ** gamma * logpt * valid
    return loss.sum() / valid.sum().clamp(min=1)
