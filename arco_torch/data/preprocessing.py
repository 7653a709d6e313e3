"""Offline preprocessing recipes (counterpart of
arco_tpu/data/preprocessing.py, copied: numpy and scipy only).

Parity targets:
- cityscapes_preprocessing.py: resize images to 1024x512 (bilinear) and
  labels (nearest) into <root>/images,labels trees;
- pascal_preprocessing.py:36-56: partial-label masks grown by iterative
  dilation from one random seed pixel per instance ('p0.x' label regimes);
- med_preprocessing.py:4-32: CT window clipping + normalization and MRI
  percentile clipping.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from scipy import ndimage


def ct_window_normalize(volume: np.ndarray, wl: float = 50.0,
                        ww: float = 400.0) -> np.ndarray:
    """CT windowing (med_preprocessing.py:4-15): clip to [wl-ww/2, wl+ww/2]
    then scale to [0, 1]."""
    lo, hi = wl - ww / 2.0, wl + ww / 2.0
    v = np.clip(volume.astype(np.float32), lo, hi)
    return (v - lo) / (hi - lo)


def mri_percentile_clip(volume: np.ndarray, low: float = 0.5,
                        high: float = 99.5) -> np.ndarray:
    """MRI percentile clipping + z-score (med_preprocessing.py:17-32)."""
    lo, hi = np.percentile(volume, [low, high])
    v = np.clip(volume.astype(np.float32), lo, hi)
    return (v - v.mean()) / (v.std() + 1e-8)


# the reference grows with cv2.dilate(mask, np.ones([5, 5]))
_DILATE_5x5 = np.ones((5, 5), bool)


def partial_label_mask(label: np.ndarray, fraction: float,
                       void_classes: Sequence[int] = (255,),
                       fill_value: int = 255,
                       rng: np.random.RandomState = None) -> np.ndarray:
    """The reference's 'p0.x' partial-label regime
    (pascal_preprocessing.py:36-56, cityscapes_preprocessing.py:90-107):
    per valid class, seed ONE random in-class pixel, then repeatedly dilate
    the UNGATED mask by a 5x5 kernel (the growth front crosses non-class
    pixels, so disconnected parts of the class are reached) and stop once
    the class-gated intersection covers >= int(fraction * area) pixels.
    fraction=0 is the reference's separate p0 loop: exactly the one seed
    pixel per class (pascal_preprocessing.py:58-73)."""
    rng = rng or np.random
    out = np.full_like(label, fill_value)
    valid = [c for c in np.unique(label).tolist() if c not in void_classes]
    for cls in valid:
        region = label == cls
        idx = np.transpose(np.nonzero(region))
        pick = idx[rng.choice(idx.shape[0], 1, replace=False)[0]]
        grown = np.zeros(label.shape, bool)
        grown[pick[0], pick[1]] = True
        if fraction == 0.0:
            out[pick[0], pick[1]] = cls
            continue
        target = int(fraction * region.sum())
        gated = grown & region
        while gated.sum() < target:
            grown = ndimage.binary_dilation(grown, _DILATE_5x5)
            gated = grown & region
        out[gated] = cls
    return out


def resize_cityscapes_pair(image: np.ndarray, label: np.ndarray,
                           size: Tuple[int, int] = (512, 1024)):
    """Bilinear image / nearest label resize
    (cityscapes_preprocessing.py)."""
    h, w = label.shape
    zh, zw = size[0] / h, size[1] / w
    img = np.stack([ndimage.zoom(image[..., c], (zh, zw), order=1)
                    for c in range(image.shape[-1])], axis=-1)
    lab = ndimage.zoom(label, (zh, zw), order=0)
    return img, lab
