"""Segmentation metrics: Dice, Jaccard, HD95, ASD (counterpart of
arco_tpu/utils/metrics.py).

The host metrics are the JAX package's numpy/scipy copy of medpy.metric.
binary (test_2D.py:50-63), on scipy.ndimage.distance_transform_edt:

- dc   = 2|A∩B| / (|A|+|B|)
- jc   = |A∩B| / |A∪B|
- hd95 = 95th percentile of the symmetric surface distances
- asd  = mean surface distance from `result` border to `reference` border

``dice_coefficient`` is the on-device overlap metric, in torch.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage


# ---------------------------------------------------------------- host side

def _surface_voxels(binary: np.ndarray) -> np.ndarray:
    """Border voxels of a binary mask (cross-structuring-element erosion)."""
    binary = binary.astype(bool)
    conn = ndimage.generate_binary_structure(binary.ndim, 1)
    eroded = ndimage.binary_erosion(binary, structure=conn, iterations=1)
    return binary & ~eroded


def _surface_distances(result: np.ndarray, reference: np.ndarray,
                       voxelspacing=None) -> np.ndarray:
    """Distances from result-border voxels to the reference border."""
    result_border = _surface_voxels(result)
    reference_border = _surface_voxels(reference)
    if not result_border.any() or not reference_border.any():
        raise RuntimeError("empty mask passed to surface distance")
    dt = ndimage.distance_transform_edt(~reference_border,
                                        sampling=voxelspacing)
    return dt[result_border]


def dc(result: np.ndarray, reference: np.ndarray) -> float:
    result = np.asarray(result).astype(bool)
    reference = np.asarray(reference).astype(bool)
    intersection = np.count_nonzero(result & reference)
    size = np.count_nonzero(result) + np.count_nonzero(reference)
    if size == 0:
        return 0.0
    return 2.0 * intersection / size


def jc(result: np.ndarray, reference: np.ndarray) -> float:
    result = np.asarray(result).astype(bool)
    reference = np.asarray(reference).astype(bool)
    intersection = np.count_nonzero(result & reference)
    union = np.count_nonzero(result | reference)
    if union == 0:
        return 0.0
    return intersection / union


def hd95(result: np.ndarray, reference: np.ndarray,
         voxelspacing=None) -> float:
    d1 = _surface_distances(result, reference, voxelspacing)
    d2 = _surface_distances(reference, result, voxelspacing)
    return float(np.percentile(np.hstack((d1, d2)), 95))


def asd(result: np.ndarray, reference: np.ndarray,
        voxelspacing=None) -> float:
    return float(_surface_distances(result, reference, voxelspacing).mean())


def calculate_metric_percase(pred: np.ndarray, gt: np.ndarray,
                             voxelspacing=None):
    """Per-class (dice, jaccard, hd95, asd), medpy-compatible
    (test_2D.py:50-63); zeros when either mask is empty, as the reference
    guards ``pred.sum() > 0``."""
    pred = np.asarray(pred).astype(bool)
    gt = np.asarray(gt).astype(bool)
    if pred.sum() > 0 and gt.sum() > 0:
        return (dc(pred, gt), jc(pred, gt),
                hd95(pred, gt, voxelspacing), asd(pred, gt, voxelspacing))
    return 0.0, 0.0, 0.0, 0.0


# -------------------------------------------------------------- device side

def dice_coefficient(pred_onehot: torch.Tensor, target_onehot: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Soft/hard per-class dice over all but the last (class) axis."""
    dims = tuple(range(pred_onehot.ndim - 1))
    intersect = (pred_onehot * target_onehot).sum(dims)
    denom = pred_onehot.sum(dims) + target_onehot.sum(dims)
    return (2.0 * intersect + eps) / (denom + eps)
