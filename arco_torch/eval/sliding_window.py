"""3D sliding-window evaluation with batched windows (counterpart of
arco_tpu/eval/sliding_window.py).

Parity target: test_util.py:139-220. Pad the volume to at least the patch,
lay a window grid with strides (xy=18, z=4 for LA, test_3D.py:31-33),
average the softmax scores over the overlaps, argmax, unpad, optionally
keep the largest connected component. Windows go through the model
``window_batch`` at a time; here the scores are summed on the host in
numpy, as in the JAX version's host path (eval/sliding_window_device.py
keeps them on the device).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
from scipy import ndimage

from arco_torch.utils.metrics import calculate_metric_percase


def model_predictor(model: torch.nn.Module, device) -> Callable:
    """predict_fn for ``model`` in eval mode, f32, without autograd:
    windows [B, 1, *patch] (numpy or a tensor) -> softmax [B, K, *patch]
    f32 on ``device``."""
    model.eval()

    @torch.no_grad()
    def predict(x):
        logits, _, _ = model(torch.as_tensor(x, device=device))
        return torch.softmax(logits.float(), dim=1)
    return predict


def window_starts(size: int, patch: int, stride: int) -> Sequence[int]:
    s = math.ceil((size - patch) / stride) + 1 if size > patch else 1
    return [min(stride * i, size - patch) for i in range(s)]


def case_geometry(shape, patch_size, stride_xy: int, stride_z: int):
    """(pads [(before, after)] per dim, padded shape, window corners) of a
    [W, H, D] volume (test_util.py:145-172)."""
    pads = []
    for n, p in zip(shape, patch_size):
        extra = max(p - n, 0)
        pads.append((extra // 2, extra - extra // 2))
    padded = tuple(n + a + b for n, (a, b) in zip(shape, pads))
    strides = (stride_xy, stride_xy, stride_z)
    xs, ys, zs = (window_starts(n, p, s)
                  for n, p, s in zip(padded, patch_size, strides))
    coords = [(x, y, z) for x in xs for y in ys for z in zs]
    return pads, padded, coords


def test_single_case_3d(predict_fn: Callable, image: np.ndarray,
                        stride_xy: int, stride_z: int, patch_size,
                        num_classes: int, window_batch: int = 4):
    """image: [W, H, D]. predict_fn: [B, 1, w, h, d] -> softmax
    [B, K, w, h, d]. Returns (label_map, score_map [K, W, H, D])."""
    shape = image.shape
    pads, padded, coords = case_geometry(shape, patch_size, stride_xy,
                                         stride_z)
    image = np.pad(image, pads, mode="constant")
    pw, ph, pd = patch_size
    score_map = np.zeros((num_classes,) + padded, np.float32)
    cnt = np.zeros(padded, np.float32)
    for i in range(0, len(coords), window_batch):
        chunk = coords[i:i + window_batch]
        batch = np.stack([image[x:x + pw, y:y + ph, z:z + pd]
                          for x, y, z in chunk]).astype(np.float32)[:, None]
        probs = predict_fn(batch)
        probs = probs.cpu().numpy() if isinstance(probs, torch.Tensor) \
            else np.asarray(probs)
        for (x, y, z), p in zip(chunk, probs):
            score_map[:, x:x + pw, y:y + ph, z:z + pd] += p
            cnt[x:x + pw, y:y + ph, z:z + pd] += 1
    score_map = score_map / cnt[None]
    label_map = np.argmax(score_map, axis=0)
    sl = tuple(slice(a, a + n) for (a, _), n in zip(pads, shape))
    return label_map[sl], score_map[(slice(None),) + sl]


def largest_connected_component(segmentation: np.ndarray) -> np.ndarray:
    """getLargestCC (test_util.py:11-16)."""
    labels, n = ndimage.label(segmentation)
    if n == 0:
        return segmentation
    largest = np.argmax(np.bincount(labels.flat)[1:]) + 1
    return (labels == largest).astype(segmentation.dtype)


def evaluate_3d(cases, load_fn, predict_fn, num_classes: int,
                patch_size=(112, 112, 80), stride_xy: int = 18,
                stride_z: int = 4, use_nms: bool = False, case_fn=None):
    """test_all_case sweep (test_util.py:38-76). ``case_fn`` (default
    test_single_case_3d; sliding_window_device.test_single_case_3d_device
    keeps the case on the device) maps (predict_fn, image, stride_xy,
    stride_z, patch_size, num_classes) to (label_map, scores)."""
    case_fn = case_fn or test_single_case_3d
    metrics = []
    for case in cases:
        image, label = load_fn(case)
        pred, _ = case_fn(predict_fn, image, stride_xy, stride_z,
                          tuple(patch_size), num_classes)
        if use_nms:
            pred = largest_connected_component(pred)
        metrics.append([calculate_metric_percase(pred == c, label == c)
                        for c in range(1, num_classes)])
    arr = np.asarray(metrics)
    return {"per_class": arr.mean(axis=0), "mean": arr.mean(axis=(0, 1)),
            "raw": arr}
