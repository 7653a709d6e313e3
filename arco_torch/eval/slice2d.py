"""2D volume evaluation: slice-wise forward, volume-wise metrics
(counterpart of arco_tpu/eval/slice2d.py).

Parity target: test_2D.py:67-132. Per case: zoom each slice to the network
size (order 0), forward, argmax, zoom back, stack, then per-class
Dice/Jaccard/HD95/ASD on the host. The slices of a case go through the
model in batches of ``slice_batch``.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
from scipy.ndimage import zoom as nd_zoom

from arco_torch.utils.metrics import calculate_metric_percase


def model_predictor(model: torch.nn.Module, device) -> Callable:
    """predict_fn for ``model`` in eval mode, f32, without autograd:
    [B, 1, h, w] numpy -> argmax labels [B, h, w] int32 numpy."""
    model.eval()

    @torch.no_grad()
    def predict(x):
        logits, _, _ = model(torch.from_numpy(x).to(device))
        return logits.argmax(1).to(torch.int32).cpu().numpy()
    return predict


def test_single_volume_2d(image: np.ndarray, label: np.ndarray,
                          predict_fn: Callable, num_classes: int,
                          input_size=(256, 256), slice_batch: int = 8):
    """image/label: [D, H, W]. predict_fn: [B, 1, h, w] -> argmax
    [B, h, w]. Returns (per-class metric 4-tuples, prediction volume)."""
    d, x, y = image.shape
    if (x, y) != tuple(input_size):
        zoomed = np.stack([nd_zoom(image[i], (input_size[0] / x,
                                              input_size[1] / y), order=0)
                           for i in range(d)])
    else:
        zoomed = image
    zoomed = np.ascontiguousarray(zoomed.astype(np.float32)[:, None])

    pred = np.concatenate([np.asarray(predict_fn(zoomed[i:i + slice_batch]))
                           for i in range(0, d, slice_batch)])

    if (x, y) != tuple(input_size):
        pred = np.stack([nd_zoom(pred[i], (x / input_size[0],
                                           y / input_size[1]), order=0)
                         for i in range(d)])
    pred = pred.astype(label.dtype)

    metrics = []
    for c in range(1, num_classes):
        metrics.append(calculate_metric_percase(pred == c, label == c))
    return metrics, pred


def evaluate_2d(cases, load_fn, predict_fn, num_classes: int,
                input_size=(256, 256)) -> Dict[str, np.ndarray]:
    """Sweep test cases; returns mean metrics per class and overall
    (Inference, test_2D.py:105-132)."""
    all_metrics = []
    for case in cases:
        image, label = load_fn(case)
        metrics, _ = test_single_volume_2d(image, label, predict_fn,
                                           num_classes, input_size)
        all_metrics.append(metrics)
    arr = np.asarray(all_metrics)          # [cases, classes-1, 4]
    return {"per_class": arr.mean(axis=0), "mean": arr.mean(axis=(0, 1)),
            "raw": arr}
