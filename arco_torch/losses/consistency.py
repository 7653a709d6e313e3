"""Consistency / pseudo-label losses of the ARCO stage (counterpart of
arco_tpu/losses/consistency.py). Channels-last class maps as in JAX."""

from __future__ import annotations

import torch

from arco_torch.kernels.pool_sims import pool_similarities
from arco_torch.losses.supervised import cross_entropy
from arco_torch.ops.collectives import all_reduce_sum
from arco_torch.ops.normalize import feature_axes, l2_normalize


def compute_unsupervised_loss(predict, target, logits, strong_threshold,
                              conf_mask: bool = False, group=None):
    """Confidence-weighted CE on pseudo-labels (train_arco_2d.py:482-489).

    predict [B, ..., K] logits; target [B, ...] int (-1 = void); logits
    [B, ...] pseudo-label confidences. ``group``: a process group whose
    ranks hold the rest of the batch; the numerator and the count of
    positive pixels are then summed over all of it."""
    b = predict.shape[0]
    valid_mask = (target >= 0).float()
    strong = (logits.reshape(b, -1) >= strong_threshold).sum(-1)
    weighting = strong / valid_mask.reshape(b, -1).sum(-1).clamp(min=1e-12)
    loss = cross_entropy(predict, target, ignore_index=-1, reduction="none")
    if conf_mask:
        loss = loss * (logits >= strong_threshold).to(loss.dtype)
    w = weighting.reshape((b,) + (1,) * (loss.ndim - 1))
    pos = (loss > 0).float()
    num, count = (w * loss * pos).sum(), pos.sum()
    if group is not None:
        num, count = all_reduce_sum(torch.stack([num, count]), group)
    return num / count.clamp(min=1)


def revisiting_loss(random_pool, rep_u, rep_u_teacher, topk: int = 5,
                    group=None):
    """Nearest-neighbour 'revisiting' loss (train_arco_2d.py:126-136).

    random_pool [K, *feat] with rows L2-normalized over the feature dims;
    rep_u / rep_u_teacher [B, *feat] in the same layout. The student picks
    its topk nearest pool rows (d = 2 - 2<a, b>); the loss is the teacher's
    mean distance to those rows. Gradient-free by reference semantics. The
    [2B, K] similarities come from the pool_sims kernel on CUDA. With a
    ``group`` each rank holds B of the unlabeled samples, and the mean runs
    over every rank's."""
    b = rep_u.shape[0]
    dims = feature_axes(rep_u)
    with torch.no_grad():
        st = torch.cat([l2_normalize(rep_u, dims),
                        l2_normalize(rep_u_teacher, dims)], dim=0)
        # JAX reads the pool in the reps' dtype. Narrowing (an f32 pool
        # against bf16 reps) rounds as JAX does, so it stays; widening (a
        # bf16 pool against f32 reps) is exact, so the kernel widens each
        # element in registers and no f32 copy of the pool is made.
        pool = random_pool.reshape(random_pool.shape[0], -1)
        if pool.element_size() > st.element_size():
            pool = pool.to(st.dtype)
        sims = pool_similarities(st.reshape(2 * b, -1).contiguous(), pool)
    dist_t = 2.0 - 2.0 * sims[:b]
    dist_q = 2.0 - 2.0 * sims[b:]
    nn_index = torch.topk(-dist_t, topk, dim=1).indices
    nn_dist_q = torch.gather(dist_q, 1, nn_index)
    if group is None:
        return (nn_dist_q.sum(1) / topk).mean()
    return _global_mean(nn_dist_q.sum(1) / topk, group)


def equivariance_loss(pred_tps, pred_tps_org, mask_tps, group=None):
    """Masked KL between predictions on TPS-warped images and TPS-warped
    predictions (train_arco_2d.py:417-423). [B, ..., K] logits and a
    [B, ..., 1] mask. With a ``group`` the per-sample ratios are averaged
    over every rank's samples."""
    logp = torch.log_softmax(pred_tps.float(), dim=-1)
    q = torch.softmax(pred_tps_org.float(), dim=-1)
    logq = torch.log(q.clamp(1e-30, 1.0))
    kl = q * (logq - logp) * mask_tps.float()
    b = kl.shape[0]
    num = kl.reshape(b, -1).sum(1)
    den = mask_tps.reshape(b, -1).float().sum(1) + 1e-7
    if group is None:
        return (num / den).mean()
    return _global_mean(num / den, group)


def _global_mean(per_sample, group):
    """The mean of a [b] vector over every rank's samples."""
    total, count = all_reduce_sum(torch.stack([
        per_sample.sum(), per_sample.new_full((), per_sample.shape[0])]),
        group)
    return total / count
