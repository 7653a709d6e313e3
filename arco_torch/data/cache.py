"""Packed memory-mapped dataset cache (counterpart of arco_tpu/data/cache.py,
a copy that draws its transforms with the port's random_generator_2d).

The reference opens one h5 file per __getitem__ call
(dataloaders/dataset.py:124-131) — fine for torch's worker pool, wasteful on
a single-host input pipeline. This module packs a slice dataset into two
contiguous .npy files (images, labels) once, then serves samples via
zero-copy memory-mapped reads. For fixed-size slice datasets (ACDC 2D) the
pack is dense; variable-size datasets store per-sample offsets.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from arco_torch.data.datasets import random_generator_2d


class PackedCache:
    """Dense pack for fixed-shape samples."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        self.images = images
        self.labels = labels

    def __len__(self):
        return self.images.shape[0]

    def load(self, idx: int):
        return self.images[idx], self.labels[idx]


def build_cache(dataset, cache_dir: str, size=None) -> Optional[PackedCache]:
    """Pack ``dataset`` (anything with .load(idx) -> (image, label) and
    __len__) into cache_dir; reuses an existing pack. Samples whose shape
    differs from the first are zoomed (order 0) to match when ``size`` is
    given, otherwise a ragged dataset aborts the pack (returns None)."""
    os.makedirs(cache_dir, exist_ok=True)
    meta_path = os.path.join(cache_dir, "meta.json")
    img_path = os.path.join(cache_dir, "images.npy")
    lab_path = os.path.join(cache_dir, "labels.npy")

    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("n") == len(dataset):
            return PackedCache(np.load(img_path, mmap_mode="r"),
                               np.load(lab_path, mmap_mode="r"))

    from scipy.ndimage import zoom as nd_zoom
    first_img, first_lab = dataset.load(0)
    shape = tuple(size) if size else first_img.shape
    n = len(dataset)
    images = np.zeros((n,) + shape, np.float32)
    labels = np.zeros((n,) + shape, np.int16)
    for i in range(n):
        img, lab = dataset.load(i)
        if img.shape != shape:
            if size is None:
                return None
            factors = tuple(t / s for t, s in zip(shape, img.shape))
            img = nd_zoom(img, factors, order=0)
            lab = nd_zoom(lab, factors, order=0)
        images[i] = img
        labels[i] = lab
    np.save(img_path, images)
    np.save(lab_path, labels)
    with open(meta_path, "w") as f:
        json.dump({"n": n, "shape": list(shape)}, f)
    return PackedCache(np.load(img_path, mmap_mode="r"),
                       np.load(lab_path, mmap_mode="r"))


class CachedSliceDataset:
    """Drop-in wrapper: same .get API as SliceDataset, backed by the pack."""

    def __init__(self, dataset, cache_dir: str, size=None):
        self.dataset = dataset
        self.cache = build_cache(dataset, cache_dir, size=size)

    def __len__(self):
        return len(self.dataset)

    def load(self, idx: int):
        if self.cache is not None:
            img, lab = self.cache.load(idx)
            return np.asarray(img), np.asarray(lab)
        return self.dataset.load(idx)

    def get(self, idx: int, rng):
        image, label = self.load(idx)
        if self.dataset.split == "train" and self.dataset.transform:
            image, label = random_generator_2d(rng, image, label,
                                               self.dataset.output_size)
        return {"image": image.astype(np.float32)[..., None],
                "label": label.astype(np.int32), "idx": idx}
