"""Memory-bank pixel contrastive loss with stratified Monte-Carlo sampling
(counterpart of arco_tpu/losses/contrastive.py; the semantics are set out
in that module's docstring).

Layout: reps are channels-last [B, H, W, C] and contiguous, so the raster
flatten (b, h, w) to [rows, C] that the sampled indices address is a view.
Every per-class quantity is batched over a leading class dim, as the JAX
version vmaps over classes. Random draws (``draws``) are optional explicit
uniforms; missing ones come from ``generator``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from arco_torch.kernels.infonce import fused_sampled_infonce
from arco_torch.ops import sampling
from arco_torch.ops.normalize import l2_normalize


def _l2_normalize(x, dim=-1):
    """losses/contrastive.py's normalization: eps 1e-12 (ops/normalize's
    default is 1e-24); f32 norms, the input dtype kept."""
    return l2_normalize(x, dim, eps=1e-12)


@dataclass
class MemoBank:
    """Per-class negative-key bank; class 0 (background) gets the larger
    capacity (train_arco_2d.py:147-154)."""
    data: torch.Tensor       # [num_classes, max_capacity, feat]
    ptr: torch.Tensor        # [num_classes] int32
    count: torch.Tensor      # [num_classes] int32
    capacities: tuple
    caps: torch.Tensor = None   # the capacities on the bank's device, int64

    @property
    def num_classes(self):
        return self.data.shape[0]


def create_memobank(num_classes: int, feat: int, capacity: int = 30000,
                    capacity_bg: int = 50000, dtype=torch.float32,
                    init: str = "zeros", generator=None,
                    device="cpu") -> MemoBank:
    """One init row per class at slot 0 with ptr = count = 1: zeros (2D
    trainer) or an L2-normalized randn row (3D trainer)."""
    caps = tuple([capacity_bg] + [capacity] * (num_classes - 1))
    data = torch.zeros((num_classes, max(caps), feat), dtype=dtype,
                       device=device)
    if init == "randn":
        row = torch.randn((num_classes, feat), generator=generator,
                          device=device)
        data[:, 0] = _l2_normalize(row).to(dtype)
    elif init != "zeros":
        raise ValueError(f"unknown memobank init {init!r}")
    ones = torch.ones((num_classes,), dtype=torch.int32, device=device)
    return MemoBank(data=data, ptr=ones.clone(), count=ones.clone(),
                    capacities=caps,
                    caps=torch.tensor(caps, dtype=torch.int64, device=device))


@torch.no_grad()
def _bank_enqueue_all(bank: MemoBank, keys: torch.Tensor, enable):
    """Enqueue [K, b, feat] keys, b per class, IN PLACE (the bank is the
    step's largest state after the pool); classes with ``enable`` False
    are left untouched, as JAX drops their writes: they write their own
    rows back, so no shape depends on the data and the host never waits
    for the device."""
    k, b = keys.shape[0], keys.shape[1]
    dev = bank.data.device
    caps = bank.caps
    slot = (bank.ptr.long()[:, None]
            + torch.arange(b, device=dev)[None, :]) % caps[:, None]
    cls = torch.arange(k, device=dev)[:, None].expand(k, b)
    bank.data[cls, slot] = torch.where(enable[:, None, None],
                                       keys.to(bank.data.dtype),
                                       bank.data[cls, slot])
    caps32 = caps.to(torch.int32)
    bank.ptr = torch.where(enable, (bank.ptr + b) % caps32, bank.ptr)
    bank.count = torch.where(enable, torch.minimum(bank.count + b, caps32),
                             bank.count)
    return bank


def sampled_infonce(anchor, proto, bank_rows, neg_idx, temp: float,
                    bank_normalized: bool = False):
    """Plain per-class CE over cosine similarities, batched over classes:
    anchor [K, Q, C], proto [K, C], bank_rows [K, cap, C], neg_idx
    [K, Q, N] -> [K]. A gather of the sampled rows and a logsumexp with the
    positive at index 0 (loss_helper_3d.py:497-506), differentiable by
    autograd; the fused kernel pair computes the same function."""
    a_n = _l2_normalize(anchor).float()
    p_n = _l2_normalize(proto).float()
    bank_n = bank_rows if bank_normalized else _l2_normalize(bank_rows)
    k = torch.arange(anchor.shape[0], device=anchor.device)[:, None, None]
    rows = bank_n[k, neg_idx.long()].float()              # [K, Q, N, C]
    pos = (a_n * p_n[:, None, :]).sum(-1) / temp          # [K, Q]
    neg = torch.einsum("kqc,kqnc->kqn", a_n, rows) / temp
    logits = torch.cat([pos[..., None], neg], dim=-1)
    return (torch.logsumexp(logits, dim=-1) - pos).mean(-1)


def compute_contra_memobank_loss(
        rep, label_onehot_all, prob_all, rank_all, is_labeled,
        label_l_onehot, low_mask, high_mask, rep_teacher,
        memobank: MemoBank, *, delta_n: float = 1.0, func: str = "smc",
        num_queries: int = 256, num_negatives: int = 512, temp: float = 0.5,
        low_rank: int = 3, high_rank: int = 20,
        current_class_threshold: float = 0.3, enqueue_per_class: int = 256,
        draws=None, generator=None, shard=None):
    """Returns (memobank, reco_loss); the bank is updated in place.

    ``draws`` may hold the sampler uniforms ``enq`` [K, enqueue_per_class]
    (always 'smc'), ``anchor`` [K, num_queries] and ``neg``
    [K, num_queries * num_negatives] (half as many for 'asmc').
    The InfoNCE term goes through the fused kernel pair
    (``kernels.infonce``).

    ``shard`` (an ``ops.collectives.BatchShard``): the inputs are this
    rank's labeled and unlabeled samples, and the loss is the global
    batch's, every rank's bank the one process's. The pixel masks are
    gathered to every rank, so every rank samples the same flat indices
    of the global batch; the prototypes are all-reduced partial sums; the
    sampled keys and anchors are read by the rank that owns each row and
    all-reduced (``BatchShard.take_rows``). Every rank then runs the
    InfoNCE pair on the same global anchors."""
    draws = draws or {}
    num_classes = label_onehot_all.shape[-1]
    feat = rep.shape[-1]
    b = rep.shape[0]

    rep_flat = rep.reshape(-1, feat)
    rep_t_flat = rep_teacher.reshape(-1, feat)
    lab = is_labeled.reshape((b,) + (1,) * (rep.ndim - 2)).bool()

    onehot_all = label_onehot_all > 0
    low_valid_all = onehot_all & (low_mask > 0)[..., None]
    high_valid_all = onehot_all & (high_mask > 0)[..., None]
    anchor_mask = (prob_all > current_class_threshold) & low_valid_all
    high_entropy_mask = (prob_all < delta_n) & high_valid_all
    cm_u = (rank_all >= low_rank) & (rank_all < high_rank) & (~lab)[..., None]
    cm_l = (rank_all < low_rank) & (label_l_onehot == 0) & lab[..., None]
    negative_mask = high_entropy_mask & (cm_u | cm_l)

    # all-class prototypes in one pass over the teacher reps, f32 sums
    low_valid_flat = low_valid_all.reshape(-1, num_classes)
    protos_all = low_valid_flat.float().t() @ rep_t_flat.float()
    if shard is None:
        take = lambda flat, idx: flat[idx]
    else:
        per_sample = rep_flat.shape[0] // b
        take = lambda flat, idx: shard.take_rows(flat, idx, per_sample)
        protos_all = shard.sum(protos_all)
        low_valid_flat = shard.gather_lu(low_valid_all).reshape(
            -1, num_classes)
        anchor_mask = shard.gather_lu(anchor_mask)
        negative_mask = shard.gather_lu(negative_mask)
    n_low_all = low_valid_flat.to(torch.int32).sum(0)                 # [K]
    protos_all = protos_all / n_low_all.clamp(min=1)[:, None]

    # enqueue a stratified sample of each class's negatives, normalized
    neg_flat = negative_mask.reshape(-1, num_classes).t()            # [K, M]
    enq_idx, n_neg_pix = sampling.sample_from_mask(
        neg_flat, enqueue_per_class, func="smc", u=draws.get("enq"),
        generator=generator)
    keys = _l2_normalize(take(rep_t_flat, enq_idx))            # [K, enq, C]
    _bank_enqueue_all(memobank, keys, enable=n_neg_pix > 0)

    anchor_flat = anchor_mask.reshape(-1, num_classes).t()
    a_idx, n_anchor = sampling.sample_from_mask(
        anchor_flat, num_queries, func=func, u=draws.get("anchor"),
        generator=generator)
    anchor_feat = take(rep_flat, a_idx)                        # [K, Q, C]

    bank_count = memobank.count
    neg_ranks = sampling.draw_indices(
        bank_count, num_queries * num_negatives, func=func,
        u=draws.get("neg"), generator=generator)
    neg_idx = neg_ranks.reshape(num_classes, num_negatives,
                                num_queries).transpose(1, 2)

    losses = fused_sampled_infonce(anchor_feat, protos_all,
                                   memobank.data.detach(), neg_idx, temp,
                                   bank_normalized=True)           # [K]

    valid_v = n_low_all > 0
    contrib = (n_anchor > 0) & (bank_count > 0) & valid_v
    valid_seg = valid_v.float().sum()
    total = (losses * contrib.float()).sum()
    reco = torch.where(valid_seg > 1, total / valid_seg.clamp(min=1.0),
                       torch.zeros((), device=total.device))
    return memobank, reco


def descending_rank(prob: torch.Tensor) -> torch.Tensor:
    """rank[..., i] = position of class i in the descending sort of the
    class dim, ties broken by ascending index (torch.sort(descending,
    stable) parity). K <= 32 uses a K^2 comparison count, larger K two
    stable argsorts; both give the same ranks."""
    k = prob.shape[-1]
    if k <= 32:
        a = prob[..., :, None]
        b = prob[..., None, :]
        idx = torch.arange(k, device=prob.device)
        earlier = idx[None, :] < idx[:, None]
        wins = (b > a) | ((b == a) & earlier)
        return wins.to(torch.int32).sum(-1)
    order = torch.argsort(-prob, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True).to(torch.int32)
