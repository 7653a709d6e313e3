"""nnU-Net's tiled prediction: gaussian importance weighting and mirror
test-time augmentation (counterpart of arco_tpu/eval/tiled_predictor.py;
reference: SegmentationNetwork, networks/neural_network.py:70-600).

- ``get_gaussian`` (:274-290): a gaussian centred in the patch, sigma =
  patch / 8, scaled to a maximum of 1, its zeros replaced by its smallest
  nonzero value;
- ``compute_steps_for_sliding_window`` (:292-319): evenly spaced window
  starts with a target step of patch * step_size;
- the softmax averaged over the 2^m mirror combinations of the chosen axes
  (:553-600), in JAX's order of combinations;
- the weighted sum of the window scores and its normalization (:321-476).

The image goes to the device once. The window crops, the flips, the
weighted sums and the normalization run there in f32, window batches in
JAX's order, and the last batch is filled up with zero windows as in JAX.
Images smaller than the patch are zero-padded around, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import gaussian_filter


def get_gaussian(patch_size: Sequence[int],
                 sigma_scale: float = 1.0 / 8) -> np.ndarray:
    """neural_network.py:274-290."""
    tmp = np.zeros(patch_size)
    center = [i // 2 for i in patch_size]
    sigmas = [i * sigma_scale for i in patch_size]
    tmp[tuple(center)] = 1
    g = gaussian_filter(tmp, sigmas, mode="constant", cval=0)
    g = g / g.max()
    g = g.astype(np.float32)
    g[g == 0] = g[g != 0].min()
    return g


def compute_steps_for_sliding_window(patch_size, image_size,
                                     step_size: float = 0.5):
    """neural_network.py:292-319: the window starts along each axis."""
    if not all(i >= j for i, j in zip(image_size, patch_size)):
        raise ValueError(f"image {tuple(image_size)} is smaller than the "
                         f"patch {tuple(patch_size)}")
    steps = []
    for i, k in zip(image_size, patch_size):
        n = int(np.ceil((i - k) / (k * step_size))) + 1
        actual = (i - k) / (n - 1) if n > 1 else 1e9
        steps.append([int(np.round(actual * j)) if i > k else 0
                      for j in range(n)])
    return steps


def _mirror_axes_combinations(mirror_axes):
    """() first, then each axis added to every earlier combination."""
    combos = [()]
    for ax in mirror_axes:
        combos = combos + [c + (ax,) for c in combos]
    return combos


def predict_tiled(predict_fn: Callable, image, patch_size, num_classes: int,
                  step_size: float = 0.5, use_gaussian: bool = True,
                  mirror_axes=(0, 1, 2), window_batch: int = 2,
                  device="cuda"):
    """image: [*spatial] (numpy or tensor). predict_fn: [B, 1, *patch] f32
    tensor on ``device`` -> softmax [B, K, *patch]. Returns (label map
    numpy int64 [*spatial], class-first scores [K, *spatial] f32 on
    ``device``)."""
    patch_size = tuple(int(p) for p in patch_size)
    nd = len(patch_size)
    vol = torch.as_tensor(np.asarray(image), dtype=torch.float32,
                          device=device)
    pads = [(max(p - s, 0) // 2, max(p - s, 0) - max(p - s, 0) // 2)
            for s, p in zip(vol.shape, patch_size)]
    # F.pad takes the last dim first
    vol = F.pad(vol, [p for pair in reversed(pads) for p in pair])
    steps = compute_steps_for_sliding_window(patch_size, vol.shape,
                                             step_size)
    coords = [(x, y, z) for x in steps[0] for y in steps[1]
              for z in steps[2]] if nd == 3 else \
        [(x, y) for x in steps[0] for y in steps[1]]
    gauss = torch.from_numpy(get_gaussian(patch_size) if use_gaussian
                             else np.ones(patch_size, np.float32)).to(
        vol.device)
    combos = _mirror_axes_combinations(tuple(mirror_axes)[:nd])

    agg = torch.zeros((num_classes,) + tuple(vol.shape), dtype=torch.float32,
                      device=vol.device)
    weights = torch.zeros(vol.shape, dtype=torch.float32, device=vol.device)

    def slices(c):
        return tuple(slice(s, s + p) for s, p in zip(c, patch_size))

    for i in range(0, len(coords), window_batch):
        chunk = coords[i:i + window_batch]
        batch = torch.zeros((window_batch, 1) + patch_size,
                            dtype=torch.float32, device=vol.device)
        for j, c in enumerate(chunk):
            batch[j, 0] = vol[slices(c)]
        prob_sum = torch.zeros((len(chunk), num_classes) + patch_size,
                               dtype=torch.float32, device=vol.device)
        for combo in combos:
            dims = tuple(a + 2 for a in combo)     # after batch, channel
            flipped = torch.flip(batch, dims) if combo else batch
            probs = predict_fn(flipped)[:len(chunk)].float()
            prob_sum += torch.flip(probs, dims) if combo else probs
        prob_sum /= len(combos)
        for c, p in zip(chunk, prob_sum):
            sl = slices(c)
            agg[(slice(None),) + sl] += p * gauss
            weights[sl] += gauss

    agg = agg / weights[None]
    sl = tuple(slice(a, a + s) for (a, _), s in zip(pads, np.shape(image)))
    agg = agg[(slice(None),) + sl]
    return agg.argmax(0).cpu().numpy(), agg


def predict_3d_via_2d(predict_fn: Callable, volume, patch_size2d,
                      num_classes: int, step_size: float = 0.5,
                      use_gaussian: bool = True, mirror_axes=(0, 1),
                      window_batch: int = 2, device="cuda"):
    """A volume through a 2D network: ``predict_tiled`` on every z-slice,
    stacked (neural_network.py:190-270 and :478-551). volume: [Z, H, W].
    Returns (label map numpy [Z, H, W], scores [K, Z, H, W] on
    ``device``)."""
    labels, scores = [], []
    for z in range(np.shape(volume)[0]):
        lab, sc = predict_tiled(predict_fn, volume[z], patch_size2d,
                                num_classes, step_size, use_gaussian,
                                mirror_axes, window_batch, device)
        labels.append(lab)
        scores.append(sc)
    return np.stack(labels), torch.stack(scores, dim=1)
