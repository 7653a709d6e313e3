"""Host-side 2D transform utilities (counterpart of
arco_tpu/data/transforms2d.py, a copy) completing the dataloaders/dataset.py
transform inventory (CenterCrop :203, RandomCrop :234, RandomNoise :367,
RandomColorJitter :385, BrightnessTransform :440, CreateOnehotLabel :406,
Resize :431, CustomMultiCropping :512).

The train paths apply photometrics on device (arco_torch.augment); these numpy
versions serve dataset-level pipelines and notebook use.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy import ndimage


def center_crop(image, label, output_size):
    """dataset.py:203-231 (pads by half-deficit + 3 like the reference)."""
    if (label.shape[0] <= output_size[0]
            or label.shape[1] <= output_size[1]):
        pw = max((output_size[0] - label.shape[0]) // 2 + 3, 0)
        ph = max((output_size[1] - label.shape[1]) // 2 + 3, 0)
        image = np.pad(image, [(pw, pw), (ph, ph)], mode="constant")
        label = np.pad(label, [(pw, pw), (ph, ph)], mode="constant")
    w, h = image.shape
    w1 = int(round((w - output_size[0]) / 2.0))
    h1 = int(round((h - output_size[1]) / 2.0))
    sl = np.s_[w1:w1 + output_size[0], h1:h1 + output_size[1]]
    return image[sl], label[sl]


def random_crop(rng, image, label, output_size):
    """dataset.py:234-262."""
    if (label.shape[0] <= output_size[0]
            or label.shape[1] <= output_size[1]):
        pw = max((output_size[0] - label.shape[0]) // 2 + 3, 0)
        ph = max((output_size[1] - label.shape[1]) // 2 + 3, 0)
        image = np.pad(image, [(pw, pw), (ph, ph)], mode="constant")
        label = np.pad(label, [(pw, pw), (ph, ph)], mode="constant")
    w, h = image.shape
    w1 = rng.randint(0, w - output_size[0] + 1)
    h1 = rng.randint(0, h - output_size[1] + 1)
    sl = np.s_[w1:w1 + output_size[0], h1:h1 + output_size[1]]
    return image[sl], label[sl]


def random_noise(rng, image, p: float = 0.5, sigma_range=(0.15, 1.15)):
    """dataset.py:367-382 (PIL gaussian blur analog: gaussian filter)."""
    if rng.random_sample() < p:
        sigma = rng.uniform(*sigma_range)
        image = ndimage.gaussian_filter(image, sigma)
    return image


def random_color_jitter(rng, image, p: float = 0.5,
                        color=(0.2, 0.2, 0.2, 0.1)):
    """dataset.py:385-403: brightness/contrast jitter for grayscale."""
    if rng.random_sample() < p:
        b = 1.0 + rng.uniform(-color[0], color[0])
        image = image * b
        c = 1.0 + rng.uniform(-color[1], color[1])
        image = image.mean() + (image - image.mean()) * c
    return image


def brightness_transform(rng, image, mu_range=(0.9, 1.1),
                         sigma: float = 0.1):
    """dataset.py:440-453: clamp(mu*x + sigma, 0, 1)."""
    mu = rng.uniform(*mu_range)
    return np.clip(mu * image + sigma, 0.0, 1.0)


def create_onehot_label(label, num_classes: int):
    """dataset.py:406-415."""
    return np.stack([(label == c).astype(np.float32)
                     for c in range(num_classes)])


def resize(image, label, output_size):
    """dataset.py:431-438 (zoom order 0)."""
    x, y = image.shape
    image = ndimage.zoom(image, (output_size[0] / x, output_size[1] / y),
                         order=0)
    label = ndimage.zoom(label, (output_size[0] / x, output_size[1] / y),
                         order=0)
    return image, label


def _box_intersection(box1, box2):
    """dataset.py:35-40: pixel-area overlap of two (i, j, h, w) boxes."""
    i1, j1, h1, w1 = box1
    i2, j2, h2, w2 = box2
    x_overlap = max(0, min(j1 + w1, j2 + w2) - max(j1, j2))
    y_overlap = max(0, min(i1 + h1, i2 + h2) - max(i1, i2))
    return x_overlap * y_overlap


def _random_resized_crop_params(rng, height, width, scale, ratio):
    """dataset.py:568-610 (CustomMultiCropping.get_params): sample a crop
    box with area in ``scale``×image-area and log-uniform aspect in
    ``ratio``; 10 tries then central-crop fallback."""
    import math

    area = height * width
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect_ratio = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect_ratio)))
        h = int(round(math.sqrt(target_area / aspect_ratio)))
        if 0 < w <= width and 0 < h <= height:
            i = rng.randint(0, height - h + 1)
            j = rng.randint(0, width - w + 1)
            return i, j, h, w
    in_ratio = float(width) / float(height)
    if in_ratio < min(ratio):
        w = width
        h = int(round(w / min(ratio)))
    elif in_ratio > max(ratio):
        h = height
        w = int(round(h * max(ratio)))
    else:
        w = width
        h = height
    return (height - h) // 2, (width - w) // 2, h, w


def _conditioned_crop_params(rng, height, width, scale, ratio, constraint):
    """dataset.py:616-642: like _random_resized_crop_params but requires
    >=10% of the sampled area to intersect ``constraint``."""
    import math

    area = height * width
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect_ratio = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect_ratio)))
        h = int(round(math.sqrt(target_area / aspect_ratio)))
        if 0 < w <= width and 0 < h <= height:
            i = rng.randint(0, height - h + 1)
            j = rng.randint(0, width - w + 1)
            if _box_intersection((i, j, h, w), constraint) >= 0.1 * target_area:
                return i, j, h, w
    return _random_resized_crop_params(rng, height, width, scale, ratio)


def _resized_crop(image, i, j, h, w, out_size, order: int):
    patch = image[i:i + h, j:j + w]
    return ndimage.zoom(patch, (out_size[0] / h, out_size[1] / w),
                        order=order)


def custom_multi_cropping(rng, image, label=None, size_large=(160, 160),
                          size_small=(96, 96), scale_large=(0.2, 1.0),
                          scale_small=(0.05, 0.14), n_large: int = 2,
                          n_small: int = 4, ratio=(3.0 / 4.0, 4.0 / 3.0),
                          condition_small_crops_on_key: bool = True):
    """dataset.py:512-677 CustomMultiCropping: n_large random-resized crops
    at size_large plus n_small at size_small, where the small crops are
    (optionally) conditioned to intersect the LAST large crop — the MoCo
    key view — by >=10% of their area. Returns (crops, params); each crop is
    (image_crop[, label_crop]) with the label resized order-0.
    """
    height, width = image.shape[:2]
    if isinstance(size_large, int):
        size_large = (size_large, size_large)
    if isinstance(size_small, int):
        size_small = (size_small, size_small)

    crops: List = []
    params: List[Tuple[int, int, int, int]] = []
    for _ in range(n_large):
        box = _random_resized_crop_params(rng, height, width, scale_large,
                                          ratio)
        params.append(box)
        img_c = _resized_crop(image, *box, size_large, order=1)
        if label is not None:
            crops.append((img_c, _resized_crop(label, *box, size_large,
                                               order=0)))
        else:
            crops.append(img_c)
    for _ in range(n_small):
        if condition_small_crops_on_key:
            box = _conditioned_crop_params(rng, height, width, scale_small,
                                           ratio, params[n_large - 1])
        else:
            box = _random_resized_crop_params(rng, height, width,
                                              scale_small, ratio)
        params.append(box)
        img_c = _resized_crop(image, *box, size_small, order=1)
        if label is not None:
            crops.append((img_c, _resized_crop(label, *box, size_small,
                                               order=0)))
        else:
            crops.append(img_c)
    return crops, params
