"""Cutout / CutMix / ClassMix as mask arithmetic (counterpart of
arco_tpu/augment/mixing.py).

Images are NCHW or NCDHW ([B, C, X, Y, Z] on the 3D path); targets and
confidences [B, *spatial]. The random draws are explicit: cutout/cutmix
take ``boxes`` [B, 3] int (rw, x0, y0) per sample in 2D, [B, 5] (rw, x0,
y0, zl, z0) in 3D, where the 2D rectangle spans the first two spatial dims
and a slab of depth zl from z0 the third (augment_3d.py:182-207); classmix
takes ``scores`` [B, num_classes] uniforms. When not given they are drawn
from ``generator`` with the JAX version's ranges.
"""

from __future__ import annotations

import torch


def _slab_depths(d: int):
    """The z-slab depth range [lo, hi) of the 3D cutout: depth//8 ..
    depth//4 (the reference's 10 .. 20 at depth 80)."""
    return max(d // 8, 1), max(d // 4, 2)


def draw_cutout_boxes(b: int, img_size, ratio: float = 2.0, generator=None,
                      device="cpu"):
    """[B, 3] (rw, x0, y0): rw ~ U{int(w/ratio)+1 .. w-1}, the rectangle's
    height rh = min(round(h*w/ratio / rw), h), x0 ~ U{0 .. w-rw}, y0 ~
    U{0 .. h-rh} (augment.py:230-244). For a 3-D ``img_size`` (h, w, d),
    [B, 5] with the slab's zl ~ U{d//8 .. d//4 - 1} and z0 ~ U{0 .. d-zl}
    appended."""
    h, w = img_size[:2]
    lo = int(w / ratio) + 1
    rw = torch.randint(lo, w, (b,), generator=generator, device=device)
    rh = _cutout_height(rw, h, w, ratio)
    u = lambda: torch.rand(b, generator=generator, device=device)
    x0 = (u() * (w - rw + 1)).long()
    y0 = (u() * (h - rh + 1)).long()
    cols = [rw, x0, y0]
    if len(img_size) == 3:
        d = img_size[2]
        zl = torch.randint(*_slab_depths(d), (b,), generator=generator,
                           device=device)
        cols += [zl, (u() * (d - zl + 1)).long()]
    return torch.stack(cols, dim=1)


def _cutout_height(rw, h, w, ratio):
    return torch.round((h * w / ratio) / rw.float()).long().clamp(max=h)


def generate_cutout_mask(boxes, img_size, ratio: float = 2.0):
    """[B, *img_size] float masks: 0 inside each sample's rectangle (and,
    in 3D, its z-slab), 1 outside."""
    h, w = img_size[:2]
    nd = len(img_size)
    col = lambda i: boxes[:, i].reshape((-1,) + (1,) * nd)
    axis = lambda n, dim: torch.arange(n, device=boxes.device).reshape(
        [1] + [n if k == dim else 1 for k in range(nd)])
    rw, x0, y0 = col(0), col(1), col(2)
    rh = _cutout_height(rw, h, w, ratio)
    ys, xs = axis(h, 0), axis(w, 1)
    inside = (ys >= y0) & (ys < y0 + rh) & (xs >= x0) & (xs < x0 + rw)
    if nd == 3:
        zl, z0, zs = col(3), col(4), axis(img_size[2], 2)
        inside = inside & (zs >= z0) & (zs < z0 + zl)
    return torch.where(inside, 0.0, 1.0)


def generate_class_mask(scores, pseudo_labels, num_classes: int):
    """Select floor(n_present / 2) of the classes present in each label
    map, the ones with the highest ``scores`` [B, num_classes]."""
    b = pseudo_labels.shape[0]
    lab = pseudo_labels.clamp(0, num_classes - 1).long().reshape(b, -1)
    present = torch.zeros((b, num_classes), dtype=torch.bool,
                          device=lab.device)
    present.scatter_(1, lab, True)
    s = torch.where(present, scores.float(), -1.0)
    k = present.sum(1, keepdim=True) // 2
    order = torch.argsort(-s, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    selected = present & (ranks < k)
    mask = torch.gather(selected, 1, lab).reshape(pseudo_labels.shape)
    return mask.float() * (pseudo_labels >= 0)


def generate_unsup_data(data, target, logits, mode: str = "cutmix",
                        num_classes: int = 4, boxes=None, scores=None,
                        generator=None, shard=None):
    """Batch mixing (augment.py:284-313). cutout zeroes the rectangle and
    voids (-1) its labels; cutmix/classmix paste from sample (i+1) % B.
    ``shard`` (an ``ops.collectives.BatchShard``): the inputs are this
    rank's unlabeled samples of a batch split over its group, and sample
    i + 1 is the global batch's: the last local sample pastes from the
    next rank's first."""
    b = data.shape[0]
    spatial = tuple(data.shape[2:])
    if mode in ("cutout", "cutmix"):
        if boxes is None:
            boxes = draw_cutout_boxes(b, spatial, generator=generator,
                                      device=data.device)
        masks = generate_cutout_mask(boxes.to(data.device), spatial)
        if mode == "cutout":
            new_target = torch.where(masks > 0, target, -1)
            return (data * masks[:, None], new_target.to(torch.int32),
                    logits * masks)
    elif mode == "classmix":
        if scores is None:
            scores = torch.rand((b, num_classes), generator=generator,
                                device=data.device)
        masks = generate_class_mask(scores.to(data.device), target,
                                    num_classes)
    else:
        masks = torch.ones_like(logits)

    if shard is None:
        rolled = lambda x: torch.roll(x, -1, dims=0)
    else:
        def rolled(x):
            nxt = shard.gather(x[:1])[(shard.rank + 1) % shard.world]
            return torch.cat([x[1:], nxt[None]], dim=0)
    m = masks[:, None]
    new_data = data * m + rolled(data) * (1 - m)
    new_target = target * masks + rolled(target) * (1 - masks)
    new_logits = logits * masks + rolled(logits) * (1 - masks)
    return new_data, new_target.to(torch.int32), new_logits
