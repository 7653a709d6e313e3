"""Miscellaneous training utilities (counterpart of arco_tpu/utils/misc.py,
copied: numpy and scipy only; reference: code/utils/util.py,
code/dataloaders/utils.py).
"""

from __future__ import annotations

import numpy as np


class AverageMeter:
    """Running average (utils/util.py AverageMeter)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class UnifLabelSampler:
    """Uniform-over-pseudolabel-class sampling (utils/util.py:48,
    DeepCluster): epoch indices drawn so every cluster contributes
    equally."""

    def __init__(self, n: int, images_lists, seed: int = 0):
        self.n = n
        self.images_lists = [l for l in images_lists if len(l)]
        self.rng = np.random.RandomState(seed)

    def indexes(self):
        per = self.n // max(len(self.images_lists), 1)
        res = []
        for lst in self.images_lists:
            res.append(self.rng.choice(lst, per,
                                       replace=len(lst) <= per))
        idx = np.concatenate(res)
        self.rng.shuffle(idx)
        return idx[:self.n].astype(np.int64)


def learning_rate_decay(base_lr: float, step: int, decay: float = 1e-5):
    """utils/util.py learning_rate_decay: lr / sqrt(1 + decay*step)."""
    return base_lr / np.sqrt(1.0 + decay * step)


def get_iou(pred: np.ndarray, gt: np.ndarray, num_classes: int):
    """Per-class IoU (dataloaders/utils.py:145-171)."""
    ious = []
    for c in range(num_classes):
        p = pred == c
        g = gt == c
        union = np.logical_or(p, g).sum()
        ious.append(np.logical_and(p, g).sum() / union if union else np.nan)
    return ious


def get_dice(pred: np.ndarray, gt: np.ndarray, num_classes: int):
    """Per-class Dice (dataloaders/utils.py:173-197)."""
    dices = []
    for c in range(num_classes):
        p = pred == c
        g = gt == c
        denom = p.sum() + g.sum()
        dices.append(2 * np.logical_and(p, g).sum() / denom if denom
                     else np.nan)
    return dices


def post_processing(prediction: np.ndarray) -> np.ndarray:
    """Largest-component cleanup per foreground class
    (dataloaders/utils.py:199-209)."""
    from scipy import ndimage
    out = np.zeros_like(prediction)
    for c in np.unique(prediction):
        if c == 0:
            continue
        mask = prediction == c
        labels, n = ndimage.label(mask)
        if n == 0:
            continue
        largest = np.argmax(np.bincount(labels.flat)[1:]) + 1
        out[labels == largest] = c
    return out
