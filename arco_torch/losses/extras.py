"""Secondary loss library (counterpart of arco_tpu/losses/extras.py): the
ReCo baseline, OHEM CE, SoftDice, the SupCon family, weighted MSE, InfoNCE
with in-batch negatives and the Criterion wrappers. No trainer of either
package calls them; they are the reference's loss library.

Parity targets (loss_helper_3d.py, loss_helper.py): compute_reco_loss
(:516-596), OhemCrossEntropy2d (:721-807), SoftDiceLoss (:931-988),
SupConLoss (:1121-1192), LocalConLoss (:1194-1269), weighted_mse_loss
(:904-907), Criterion / CriterionOhem (:616-719), SupConSegLoss
(:1035-1119), InfoNCE (loss_helper.py:27-60).

Channels-last as in JAX: logits and reps [..., K] / [..., C]. The draws of
``compute_reco_loss`` and ``sup_con_seg_loss`` are explicit arguments
(uniforms / indices); without them they come from ``generator``.
"""

from __future__ import annotations

import torch

from arco_torch.losses.supervised import cross_entropy
from arco_torch.ops import sampling


def _l2n(x, dim=-1, eps=1e-12):
    x = x.float()
    return x * torch.rsqrt(torch.sum(torch.square(x), dim=dim, keepdim=True)
                           + eps)


def info_nce(query, positive_key, temperature: float = 0.1):
    """InfoNCE with in-batch negatives (loss_helper.py:27-60)."""
    q, k = _l2n(query), _l2n(positive_key)
    logp = torch.log_softmax(q @ k.t() / temperature, dim=1)
    return -torch.mean(torch.diagonal(logp))


def compute_reco_loss(rep, valid_mask, prob, label_onehot,
                      strong_threshold: float = 1.0, temp: float = 0.5,
                      num_queries: int = 256, num_negatives: int = 256,
                      draws=None, generator=None):
    """ReCo regional contrastive loss, static shapes.

    rep [B, *S, C], valid_mask [B, *S], prob and label_onehot [B, *S, K].
    ``draws``: {"anchor": [K, num_queries] uniforms of each class's
    stratified anchor draw, "neg": [K, num_queries * num_negatives]
    uniforms of its inverse-CDF negative draw}."""
    num_classes = label_onehot.shape[-1]
    c = rep.shape[-1]
    dev = rep.device
    rep_flat = rep.reshape(-1, c)
    valid = (label_onehot > 0) & (valid_mask[..., None] > 0)
    valid_flat = valid.reshape(-1, num_classes)
    counts = valid_flat.to(torch.int32).sum(0)
    protos = torch.einsum("nc,nk->kc", rep_flat.float(), valid_flat.float())
    protos = protos / torch.clamp(counts, min=1)[:, None]
    protos_n = _l2n(protos)
    prob_flat = prob.reshape(-1, num_classes)
    class_valid = counts > 0
    n_valid = class_valid.float().sum()
    if draws is None:
        draws = {"anchor": torch.rand((num_classes, num_queries),
                                      generator=generator, device=dev),
                 "neg": torch.rand((num_classes,
                                    num_queries * num_negatives),
                                   generator=generator, device=dev)}
    arange = torch.arange(num_classes, device=dev)
    total = torch.zeros((), device=dev)
    for i in range(num_classes):
        hard = (prob_flat[:, i] < strong_threshold) & valid_flat[:, i]
        a_idx, n_hard = sampling.sample_from_mask(
            hard, num_queries, func="smc", u=draws["anchor"][i])
        anchors = _l2n(rep_flat[a_idx])
        # negative class distribution ~ softmax(proto similarity / temp)
        sim = protos_n @ protos_n[i]
        sim = torch.where(class_valid & (arange != i), sim, -torch.inf)
        class_prob = torch.softmax(sim / temp, dim=0)
        # per-pixel weight class_prob[k] / count[k] over the valid pixels
        # of the other classes -> inverse-CDF draw of Q * N pixels
        w = torch.where(class_valid, class_prob / torch.clamp(counts, min=1),
                        0.0)
        w = torch.where(arange == i, 0.0, w)
        cdf = torch.cumsum(valid_flat.float() @ w, 0)
        tot = cdf[-1]
        u = draws["neg"][i].to(dev).float() * torch.clamp(tot, min=1e-12)
        neg_idx = torch.searchsorted(cdf, u).clamp(0, cdf.shape[0] - 1)
        negatives = _l2n(rep_flat[neg_idx]).reshape(num_queries,
                                                    num_negatives, c)
        pos_logit = anchors @ protos_n[i] / temp
        neg_logits = torch.einsum("qc,qnc->qn", anchors, negatives) / temp
        logits = torch.cat([pos_logit[:, None], neg_logits], dim=1)
        ce = torch.logsumexp(logits, dim=1) - pos_logit
        ok = (class_valid[i] & (n_hard > 0) & (tot > 0)).float()
        total = total + ce.mean() * ok
    return torch.where(n_valid > 1, total / torch.clamp(n_valid, min=1.0),
                       0.0)


def ohem_cross_entropy(logits, labels, ignore_index: int = 255,
                       thresh: float = 0.7, min_kept: int = 100000):
    """OHEM CE (OhemCrossEntropy2dTensor, loss_helper_3d.py:809-890): keep
    the pixels whose target-class probability is at most a threshold,
    raised so that at least min_kept pixels are kept."""
    k = logits.shape[-1]
    valid = labels != ignore_index
    safe = labels.clamp(0, k - 1).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt_prob = torch.gather(torch.softmax(logits.float(), dim=-1), -1,
                            safe[..., None])[..., 0]
    tgt_prob = torch.where(valid, tgt_prob, torch.inf)
    flat = tgt_prob.reshape(-1)
    kept = min(min_kept, flat.shape[0])
    kth = torch.topk(flat, kept, largest=False).values[-1] if kept > 0 \
        else torch.zeros((), device=flat.device)
    keep = (tgt_prob <= torch.clamp(kth, min=thresh)) & valid
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0] * keep
    return nll.sum() / keep.sum().clamp(min=1)


def soft_dice_loss(logits, target_onehot, smooth: float = 1.0,
                   do_bg: bool = True, batch_dice: bool = False):
    """SoftDiceLoss (loss_helper_3d.py:931-988): minus the mean dice over
    classes."""
    probs = torch.softmax(logits.float(), dim=-1)
    target_onehot = target_onehot.float()
    if not do_bg:
        probs, target_onehot = probs[..., 1:], target_onehot[..., 1:]
    dims = tuple(range(0 if batch_dice else 1, probs.ndim - 1))
    intersect = (probs * target_onehot).sum(dims)
    denom = probs.sum(dims) + target_onehot.sum(dims)
    return -torch.mean((2.0 * intersect + smooth) / (denom + smooth))


def sup_con_loss(features, labels=None, temperature: float = 0.07,
                 base_temperature: float = 0.07, contrast_mode: str = "all"):
    """Supervised contrastive loss (Khosla et al.; loss_helper_3d.py:1121).

    features [B, n_views, C] (L2-normalized inside); labels [B] or None
    (SimCLR: the positives are the other views of the same sample)."""
    b, v, c = features.shape
    dev = features.device
    # view-major rows (torch.cat(torch.unbind(features, 1))): view * B + b
    feats = _l2n(features).transpose(0, 1).reshape(v * b, c)
    if labels is None:
        mask = torch.eye(b, device=dev)
    else:
        labels = labels.reshape(b, 1)
        mask = (labels == labels.t()).float()
    mask = mask.repeat(v, v)
    anchor = feats if contrast_mode == "all" else feats[:b]
    logits = anchor @ feats.t() / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    n = anchor.shape[0]
    self_mask = 1.0 - torch.eye(b * v, device=dev)[:n]
    mask = mask[:n] * self_mask
    exp_logits = torch.exp(logits) * self_mask
    log_prob = logits - torch.log(exp_logits.sum(1, keepdim=True) + 1e-12)
    denom = torch.clamp(mask.sum(1), min=1e-12)
    mean_log_prob_pos = (mask * log_prob).sum(1) / denom
    return torch.mean(-(temperature / base_temperature) * mean_log_prob_pos)


def local_con_loss(features, labels, temperature: float = 0.7,
                   stride: int = 4):
    """LocalConLoss (loss_helper_3d.py:1194-1269): the spatial grid
    subsampled by ``stride``, then pixel-wise supervised contrast.
    features [B, n_views, C, *S]; labels [B, *S]."""
    sl = (slice(None),) * 3 + tuple(
        slice(None, None, stride) for _ in features.shape[3:])
    f = features[sl]
    lab = labels[(slice(None),) + tuple(slice(None, None, stride)
                                        for _ in labels.shape[1:])]
    b, v, c = f.shape[:3]
    # each (sample, pixel) is one instance
    f = f.reshape(b, v, c, -1).permute(0, 3, 1, 2).reshape(-1, v, c)
    return sup_con_loss(f, lab.reshape(-1), temperature=temperature,
                        base_temperature=temperature)


def weighted_mse_loss(input, target, weight):
    """loss_helper_3d.py:904-907."""
    return torch.sum(weight * (input - target) ** 2)


def criterion(preds, target, aux_weight: float = 0.0,
              ignore_index: int = 255):
    """Criterion (loss_helper_3d.py:616-679): CE of the main head plus the
    weighted CE of an optional aux head; ``preds`` is logits or a
    (main, aux) tuple."""
    if isinstance(preds, (tuple, list)) and aux_weight > 0:
        return (cross_entropy(preds[0], target, ignore_index=ignore_index)
                + aux_weight * cross_entropy(preds[1], target,
                                             ignore_index=ignore_index))
    main = preds[0] if isinstance(preds, (tuple, list)) else preds
    return cross_entropy(main, target, ignore_index=ignore_index)


def criterion_ohem(preds, target, aux_weight: float = 0.0,
                   thresh: float = 0.7, min_kept: int = 100000,
                   ignore_index: int = 255):
    """CriterionOhem (loss_helper_3d.py:681-719)."""
    if isinstance(preds, (tuple, list)) and aux_weight > 0:
        return (ohem_cross_entropy(preds[0], target, ignore_index, thresh,
                                   min_kept)
                + aux_weight * ohem_cross_entropy(preds[1], target,
                                                  ignore_index, thresh,
                                                  min_kept))
    main = preds[0] if isinstance(preds, (tuple, list)) else preds
    return ohem_cross_entropy(main, target, ignore_index, thresh, min_kept)


def sup_con_seg_loss(features, labels, temperature: float = 0.7,
                     num_samples: int = 256, idx=None, generator=None):
    """SupConSegLoss (loss_helper_3d.py:1035-1119): pixel-level supervised
    contrast within a batch, over ``num_samples`` pixels drawn per image
    (``idx`` [B, num_samples], else drawn from ``generator``).
    features [B, *S, C]; labels [B, *S] int."""
    b, c = features.shape[0], features.shape[-1]
    f = features.reshape(b, -1, c)
    lab = labels.reshape(b, -1)
    if idx is None:
        idx = torch.randint(0, f.shape[1], (b, num_samples),
                            generator=generator, device=f.device)
    idx = idx.to(f.device).long()
    fs = _l2n(torch.gather(f, 1, idx[..., None].expand(-1, -1, c))
              .reshape(-1, c))
    ls = torch.gather(lab, 1, idx).reshape(-1)
    logits = fs @ fs.t() / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    n = fs.shape[0]
    not_self = ~torch.eye(n, dtype=torch.bool, device=fs.device)
    pos_mask = ((ls[:, None] == ls[None, :]) & (ls[:, None] >= 0)
                & not_self).float()
    exp_logits = torch.exp(logits) * not_self
    log_prob = logits - torch.log(exp_logits.sum(1, keepdim=True) + 1e-12)
    denom = torch.clamp(pos_mask.sum(1), min=1e-12)
    mean_log_prob = (pos_mask * log_prob).sum(1) / denom
    valid = pos_mask.sum(1) > 0
    return -(mean_log_prob * valid).sum() / valid.sum().clamp(min=1)
